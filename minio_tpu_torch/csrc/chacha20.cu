// Batched ChaCha20 keystream XOR for Hopper (sm_90a): the SSE cipher.
//
// Replaces the TPU device program minio_tpu/ops/chacha20_jax.py:50-122
// (_keystream_words, keystream_u8, keystream_xor, xor_packages), which
// runs the 16 state words of every (row, 64-byte block) as u32 planes
// through 10 double rounds. Row i, package p is ciphered under key words
// keys[i] and nonce words nonces[i, p]; inside a package the RFC 8439
// block counter restarts at 1 (counter 0 is the package's Poly1305
// one-time key, which the host derives: tags never come from the card).
// The plain PyTorch version is minio_tpu_torch/ops/chacha20_plain.py.
//
// What bounds it on this card: a 64-byte block is about 1,000 32-bit
// operations (10 double rounds x 8 quarter rounds x 12, the feed-forward
// and the XOR) against 128 bytes moved, so the integer pipes, not memory,
// set the floor (1,000 ops / 128 B is above the card's ~5 ops per byte of
// INT32 rate over HBM rate). Every block is independent, so the first
// design is the simple one: one thread per (row, block), the 16 words in
// registers, all 20 rounds unrolled, rotates by 16 and 8 as byte
// permutes and by 12 and 7 as funnel shifts.
//
// Alignment: a row of the PUT's flat (B, k*S) view starts at a multiple
// of k*S, which is only 8-byte aligned at config 2 (k*S = 1,048,584), and
// a view may start anywhere. Each thread picks its loads and stores from
// the alignment of its block in both tensors (a block starts 64 bytes
// after the last, so all blocks of a row share it): 16-byte, 8-byte,
// 4-byte or byte accesses. Bytes at or past `span` are never read or
// written: the last block of a row whose span is not a multiple of 64 is
// handled byte by byte up to the span.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b,
                                        uint32_t& c, uint32_t& d) {
  a += b;
  d = __byte_perm(d ^ a, 0, 0x1032);  // rotl 16
  c += d;
  b = rotl(b ^ c, 12);
  a += b;
  d = __byte_perm(d ^ a, 0, 0x2103);  // rotl 8
  c += d;
  b = rotl(b ^ c, 7);
}

// the 16 keystream words of block `ctr` under key k and nonce n
__device__ __forceinline__ void block(const uint32_t (&k)[8],
                                      const uint32_t (&n)[3], uint32_t ctr,
                                      uint32_t (&ks)[16]) {
  uint32_t x0 = 0x61707865u, x1 = 0x3320646eu, x2 = 0x79622d32u,
           x3 = 0x6b206574u;
  uint32_t x4 = k[0], x5 = k[1], x6 = k[2], x7 = k[3];
  uint32_t x8 = k[4], x9 = k[5], x10 = k[6], x11 = k[7];
  uint32_t x12 = ctr, x13 = n[0], x14 = n[1], x15 = n[2];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    quarter(x0, x4, x8, x12);
    quarter(x1, x5, x9, x13);
    quarter(x2, x6, x10, x14);
    quarter(x3, x7, x11, x15);
    quarter(x0, x5, x10, x15);
    quarter(x1, x6, x11, x12);
    quarter(x2, x7, x8, x13);
    quarter(x3, x4, x9, x14);
  }
  ks[0] = x0 + 0x61707865u;
  ks[1] = x1 + 0x3320646eu;
  ks[2] = x2 + 0x79622d32u;
  ks[3] = x3 + 0x6b206574u;
  ks[4] = x4 + k[0];
  ks[5] = x5 + k[1];
  ks[6] = x6 + k[2];
  ks[7] = x7 + k[3];
  ks[8] = x8 + k[4];
  ks[9] = x9 + k[5];
  ks[10] = x10 + k[6];
  ks[11] = x11 + k[7];
  ks[12] = x12 + ctr;
  ks[13] = x13 + n[0];
  ks[14] = x14 + n[1];
  ks[15] = x15 + n[2];
}

__global__ void __launch_bounds__(kThreads)
    chacha20_kernel(const uint8_t* in, long long in_stride,
                    uint8_t* out, long long out_stride, long long n_rows,
                    long long span, const uint32_t* __restrict__ keys,
                    const uint32_t* __restrict__ nonces, long long n_pkg,
                    long long pkg_blocks, long long nblk, int align) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_rows * nblk) return;
  const long long row = t / nblk;
  const long long j = t - row * nblk;
  const long long pkg = j / pkg_blocks;
  const uint32_t ctr = static_cast<uint32_t>(1 + (j - pkg * pkg_blocks));

  uint32_t k[8], n[3], ks[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) k[i] = __ldg(keys + row * 8 + i);
  const uint32_t* np = nonces + (row * n_pkg + pkg) * 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = __ldg(np + i);
  block(k, n, ctr, ks);

  // in and out may be the same tensor (in place): neither is __restrict__,
  // and each thread reads its words before it writes them
  const uint8_t* src = in + row * in_stride + j * 64;
  uint8_t* dst = out + row * out_stride + j * 64;
  const long long left = span - j * 64;
  if (left < 64 || align < 4) {
    // byte by byte: a row's last block cut by the span, or rows on no
    // 4-byte boundary (unrolled, so the keystream stays in registers)
    const int len = left < 64 ? static_cast<int>(left) : 64;
#pragma unroll
    for (int b = 0; b < 64; ++b)
      if (b < len)
        dst[b] = src[b] ^ static_cast<uint8_t>(ks[b >> 2] >> (8 * (b & 3)));
    return;
  }
  if (align >= 16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint4 v = s[q];
      v.x ^= ks[4 * q];
      v.y ^= ks[4 * q + 1];
      v.z ^= ks[4 * q + 2];
      v.w ^= ks[4 * q + 3];
      d[q] = v;
    }
  } else if (align >= 8) {
    const uint2* s = reinterpret_cast<const uint2*>(src);
    uint2* d = reinterpret_cast<uint2*>(dst);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint2 v = s[q];
      v.x ^= ks[2 * q];
      v.y ^= ks[2 * q + 1];
      d[q] = v;
    }
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
    for (int q = 0; q < 16; ++q) d[q] = s[q] ^ ks[q];
  }
}

// the largest of 16, 8, 4, 1 that divides every row start of a tensor
int alignment(const void* p, long long stride) {
  const unsigned long long a =
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(p)) |
      static_cast<unsigned long long>(stride);
  return (a & 15) == 0 ? 16 : (a & 7) == 0 ? 8 : (a & 3) == 0 ? 4 : 1;
}

}  // namespace

extern "C" {

// in, out: n_rows rows of in_stride / out_stride bytes (device memory;
// out may equal in). XORs the first `span` bytes of each row of `in` with
// its keystream into `out`; keys (n_rows, 8) and nonces (n_rows, n_pkg, 3)
// are u32 words, packages of pkg_bytes (a multiple of 64) cover the span.
// Launches on the given stream and returns the CUDA error of the launch.
int chacha20_launch(const void* in, long long in_stride, void* out,
                    long long out_stride, long long n_rows, long long span,
                    const void* keys, const void* nonces, long long n_pkg,
                    long long pkg_bytes, void* stream) {
  if (n_rows < 1 || span < 1 || pkg_bytes < 64 || pkg_bytes % 64 ||
      n_pkg < 1 || span > n_pkg * pkg_bytes || span > in_stride ||
      span > out_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nblk = (span + 63) / 64;
  const long long threads = n_rows * nblk;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int a_in = alignment(in, in_stride), a_out = alignment(out, out_stride);
  const int align = a_in < a_out ? a_in : a_out;
  chacha20_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), in_stride,
      static_cast<uint8_t*>(out), out_stride, n_rows, span,
      static_cast<const uint32_t*>(keys), static_cast<const uint32_t*>(nonces),
      n_pkg, pkg_bytes / 64, nblk, align);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
