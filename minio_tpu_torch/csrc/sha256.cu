// Batched SHA-256 for Hopper (sm_90a): one digest per row.
//
// Replaces the TPU device program minio_tpu/ops/sha256_jax.py:85-155
// (_compress and _sha256_impl), which advances all N rows in lockstep as
// u32 vectors: standard padding (0x80, zeros, the 64-bit big-endian bit
// length), 64 rounds per 64-byte block, the message schedule extended in
// place. The plain PyTorch version is minio_tpu_torch/ops/sha256_ref.py.
//
// What bounds it on this card: each row is one dependent chain of
// compressions (a block's rounds start from the state the last block
// left), and each round's new `e` and `a` depend on the previous round's.
// At the main path's shape (640 rows of 65,536 bytes, 1,025 compressions
// a row) that chain is far above the byte bound, so the kernel is a
// simple one: one thread per row, 32 rows per one-warp block so that a
// batch spreads over as many SMs as it has warps, all 64 rounds and the
// schedule unrolled into registers, rotates as funnel shifts and the
// big-endian word loads as byte permutes.
//
// Loads: a row's full 64-byte blocks come in as four 16-byte loads when
// the row starts on a 16-byte boundary (every row of the main path does:
// S = 65,536), as sixteen 4-byte loads on a 4-byte boundary, else byte by
// byte. The tail (length % 64 bytes, then the padding: one block, or two
// when length % 64 >= 56) is built byte by byte from the row, so no byte
// at or past `length` is read and no word without a row byte is loaded.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

__constant__ uint32_t kH0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                0xa54ff53a, 0x510e527f, 0x9b05688c,
                                0x1f83d9ab, 0x5be0cd19};

constexpr int kRowsPerBlock = 32;  // one warp, one row per thread

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// little-endian load -> big-endian word
__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ void compress(uint32_t (&st)[8],
                                         uint32_t (&w)[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      const uint32_t w15 = w[(i - 15) & 15], w2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + s1 + ch + kK[i] + w[i & 15];
    const uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + s0 + maj;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// the 16 big-endian words of the 64 bytes at p; `align` is 16, 4 or 1
__device__ __forceinline__ void load_block(const uint8_t* p, int align,
                                           uint32_t (&w)[16]) {
  if (align == 16) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 v = __ldg(q + j);
      w[4 * j] = bswap(v.x);
      w[4 * j + 1] = bswap(v.y);
      w[4 * j + 2] = bswap(v.z);
      w[4 * j + 3] = bswap(v.w);
    }
  } else if (align == 4) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 16; ++j) w[j] = bswap(__ldg(q + j));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      w[j] = (uint32_t(__ldg(p + 4 * j)) << 24) |
             (uint32_t(__ldg(p + 4 * j + 1)) << 16) |
             (uint32_t(__ldg(p + 4 * j + 2)) << 8) |
             uint32_t(__ldg(p + 4 * j + 3));
  }
}

__global__ void __launch_bounds__(kRowsPerBlock)
    sha256_kernel(const uint8_t* __restrict__ data, long long n_rows,
                  long long row_stride, long long length,
                  uint8_t* __restrict__ out) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x;
  if (r >= n_rows) return;
  const uint8_t* row = data + r * row_stride;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int align = (addr & 15) == 0 ? 16 : (addr & 3) == 0 ? 4 : 1;

  const long long n_full = length / 64;
  const int rem = static_cast<int>(length - n_full * 64);
  const int n_tail = rem >= 56 ? 2 : 1;

  // the padded tail: rem row bytes, 0x80, zeros, the bit length
  uint32_t tail[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) tail[j] = 0;
  const uint8_t* tp = row + n_full * 64;
  for (int j = 0; j < rem; ++j)
    tail[j >> 2] |= uint32_t(__ldg(tp + j)) << (24 - 8 * (j & 3));
  tail[rem >> 2] |= 0x80u << (24 - 8 * (rem & 3));
  const unsigned long long bits = static_cast<unsigned long long>(length) * 8;
  tail[16 * n_tail - 2] = static_cast<uint32_t>(bits >> 32);
  tail[16 * n_tail - 1] = static_cast<uint32_t>(bits);

  uint32_t st[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = kH0[j];
  const long long n_blocks = n_full + n_tail;
  for (long long blk = 0; blk < n_blocks; ++blk) {
    uint32_t w[16];
    if (blk < n_full) {
      load_block(row + blk * 64, align, w);
    } else {
      const int o = static_cast<int>(blk - n_full) * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j] = tail[o + j];
    }
    compress(st, w);
  }
  // (N, 32) output rows are 32-byte aligned: the wrapper allocates them
  uint4* o = reinterpret_cast<uint4*>(out + r * 32);
  o[0] = make_uint4(bswap(st[0]), bswap(st[1]), bswap(st[2]), bswap(st[3]));
  o[1] = make_uint4(bswap(st[4]), bswap(st[5]), bswap(st[6]), bswap(st[7]));
}

}  // namespace

extern "C" {

// data: n_rows rows of row_stride bytes (device memory); hashes the first
// `length` bytes of each row into out (n_rows, 32), which must be 16-byte
// aligned, on the given stream. Returns the CUDA error of the launch
// (cudaGetLastError()).
int sha256_launch(const void* data, long long n_rows, long long row_stride,
                  long long length, void* out, void* stream) {
  if (n_rows < 1 || length < 0 || length > row_stride ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  sha256_kernel<<<static_cast<unsigned>(blocks), kRowsPerBlock, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n_rows, row_stride, length,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
