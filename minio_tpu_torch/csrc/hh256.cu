// Batched keyed HighwayHash-256 for Hopper (sm_90a).
//
// Replaces the TPU device program minio_tpu/ops/highwayhash_jax.py:336-374
// (_hh256_impl), which emulates the 64-bit lanes as u32 pairs folded into
// sublane groups. The algorithm is the one in
// minio_tpu_torch/ops/highwayhash_py.py and native/highwayhash.cpp:
// 32-byte packets, a remainder packet for length % 32, ten
// permute-and-update rounds and the modular reduction to 256 bits.
//
// What bounds it on this card: a row's packets form one dependent chain
// (each round reads the state the last one wrote), so a row costs its
// packet rounds times the time of one round, whatever the byte rate. At
// the main path's shapes (96 to 512 rows of 87,382 to 349,526 bytes) that
// is several times the byte bound, so the design goal is the shortest
// round, not bandwidth. With every row on a warp of its own, a round is
// bound by one thread's in-order issue: about 50 instructions, most of
// them on the integer ALU pipe, which takes two cycles per warp
// instruction. Anything that adds to a round costs every row: waiting for
// packet bytes, issuing all four 64-bit state lanes from one thread, and
// mask-and-shift byte shuffles.
//
// Design:
// - Packets come from shared memory. Each warp owns a ring of kDepth stages
//   of kChunk bytes per row. All 32 lanes fill one row's next chunk at a
//   time with 16-byte cp.async copies of the aligned window that covers it
//   (neighbouring lanes, neighbouring pieces: coalesced), kDepth - 2 chunks
//   in flight ahead of the pair being hashed. Rows start at any byte
//   offset, so the ring holds the row as a stream from its 16-byte aligned
//   start and the hashing lanes realign five words per half-packet with
//   funnel shifts; the ring's head is mirrored past its end, so those
//   words are consecutive. A 16-byte piece is copied whole only when each
//   of its 32-bit words holds a byte of the row; the row's first and last
//   pieces go word by word, so no word without a row byte is ever read
//   (the last row may end the allocation).
// - Two lanes per row. During packet updates the four state lanes form two
//   independent pairs (update() zipper-merges lane 1 with 0 and 3 with 2
//   only), so lane h of a thread pair carries state lanes 2h, 2h+1 and
//   takes packet bytes 16h..16h+15: half the instructions per round on
//   each thread. The remainder packet is built by each lane for its own
//   half; the ten finalisation rounds exchange the other pair's v0 with
//   one __shfl_xor_sync; each lane reduces and stores its 16 output bytes.
// - Few instructions per round: the zipper merge is five byte permutes,
//   and each 32 x 32 -> 64-bit product one wide multiply.
// - Geometry: issue per round does not grow with the rows a warp holds, so
//   the launch first spreads rows one per warp over one warp per scheduler
//   of every SM (4 x SM count warps), and only beyond that packs up to 16
//   rows into a warp. Warps per block are as few as still reach every SM,
//   at most 4: 128 rows run as 128 one-warp blocks on 128 SMs, 512 rows as
//   128 blocks of 4 warps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 512;  // bytes of one row per ring stage (16 packets)
constexpr int kDepth = 4;    // ring stages per row; kDepth - 2 chunks ahead
constexpr int kRing = kChunk * kDepth;        // bytes per row, power of two
constexpr int kMirror = 32;                   // ring head again past its end
constexpr int kRowSlot = kRing + kMirror + 16;  // padding staggers banks
constexpr int kPieces = kChunk / 16;          // 16-byte pieces per chunk
constexpr int kPackets = kChunk / 32;
constexpr int kMaxRowsPerWarp = 16;
constexpr int kMaxWarpsPerBlock = 4;
static_assert((kRing & (kRing - 1)) == 0, "ring must be a power of two");
static_assert(kChunk % 32 == 0 && kDepth >= 3, "bad ring geometry");
// the largest block's rings fit Hopper's 227 KB opt-in shared memory
static_assert(kMaxWarpsPerBlock * kMaxRowsPerWarp * kRowSlot <= 227 * 1024,
              "ring too large for one block");

__device__ __forceinline__ uint64_t rot32(uint64_t x) {
  return (x >> 32) | (x << 32);
}

// add0 += bytes (a3 b4 a2 a5 b6 a1 b7 a0), add1 += (b3 a4 b2 b5 b1 a6 b0 a7)
// of v0 = a0..a7 and v1 = b0..b7 (least significant first): five byte
// permutes (PRMT), the first shared by both low words, in place of the
// reference's mask-and-shift form (some thirty integer-pipe instructions).
__device__ __forceinline__ void zipper_merge_add(uint64_t v1, uint64_t v0,
                                                 uint64_t& add1,
                                                 uint64_t& add0) {
  const uint32_t a_lo = static_cast<uint32_t>(v0);
  const uint32_t a_hi = static_cast<uint32_t>(v0 >> 32);
  const uint32_t b_lo = static_cast<uint32_t>(v1);
  const uint32_t b_hi = static_cast<uint32_t>(v1 >> 32);
  const uint32_t t = __byte_perm(a_hi, b_hi, 0x5041);      // a5 b4 a4 b5
  const uint32_t z0_lo = __byte_perm(a_lo, t, 0x4253);
  const uint32_t z0_hi = __byte_perm(b_hi, a_lo, 0x4352);
  const uint32_t z1_lo = __byte_perm(b_lo, t, 0x7263);
  const uint32_t z1_hi = __byte_perm(b_lo, a_hi, 0x7061);
  add0 += static_cast<uint64_t>(z0_hi) << 32 | z0_lo;
  add1 += static_cast<uint64_t>(z1_hi) << 32 | z1_lo;
}

// The full 64-bit product of two 32-bit words, as one wide multiply
// (IMAD.WIDE.U32): written in C, the compiler adds a zero to its high
// word after it.
__device__ __forceinline__ uint64_t mul32(uint32_t a, uint32_t b) {
  uint64_t p;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(p) : "r"(a), "r"(b));
  return p;
}

// One lane's half of the state: state lanes 2h and 2h+1.
struct Half {
  uint64_t v0[2], v1[2], mul0[2], mul1[2];
};

__device__ __forceinline__ void update(Half& s, uint64_t l0, uint64_t l1) {
  const uint64_t lanes[2] = {l0, l1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] += s.mul0[i] + lanes[i];
    s.mul0[i] ^= mul32(static_cast<uint32_t>(s.v1[i]),
                       static_cast<uint32_t>(s.v0[i] >> 32));
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul32(static_cast<uint32_t>(s.v0[i]),
                       static_cast<uint32_t>(s.v1[i] >> 32));
  }
  zipper_merge_add(s.v1[1], s.v1[0], s.v0[1], s.v0[0]);
  zipper_merge_add(s.v0[1], s.v0[0], s.v1[1], s.v1[0]);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy the 16-byte piece at stream byte x (x % 16 == 0) of a row whose
// bytes are stream bytes off .. end - 1: whole when each of its words
// holds a row byte, else only the words that do (a row's first and last
// pieces).
__device__ __forceinline__ void stage_piece(uint32_t dst, const uint8_t* src,
                                            long long x, int off,
                                            long long end) {
  if (x >= (off & ~3) && x + 16 <= ((end + 3) & ~3LL)) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int w = 0; w < 16; w += 4)
    if (x + w + 4 > off && x + w < end) cp_async4(dst + w, src + w);
}

// Stage chunk `c` of each of the warp's `rows` rows into its ring stage.
// A row is the stream of aligned 16-byte pieces from its start rounded
// down to 16; stream byte x lives at ring byte x % kRing, and the ring's
// first kMirror bytes are written again after its end, so a packet that
// wraps is read as consecutive words.
__device__ __forceinline__ void stage_chunk(
    long long c, long long n_chunks, const uint8_t* row0_ptr,
    long long row_stride, int rows, long long length, uint32_t ring0,
    int lane) {
  if (c >= n_chunks) return;
  for (int r = 0; r < rows; ++r) {
    const uint8_t* p = row0_ptr + r * row_stride;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    const uint8_t* a0 = p - off;
    const long long end = off + length;     // stream bytes that are the row
    const uint32_t slot = ring0 + r * kRowSlot;
    for (int j = lane; j < kPieces; j += 32) {
      const long long q = c * kPieces + j;
      const long long x = 16 * q;
      if (x >= end) break;
      const uint32_t dst = slot + static_cast<uint32_t>(x & (kRing - 1));
      stage_piece(dst, a0 + x, x, off, end);
      if ((x & (kRing - 1)) < kMirror)
        stage_piece(dst + kRing, a0 + x, x, off, end);
    }
  }
}

// The five words that hold stream bytes x .. x + 15 (x = 4k + off % 4).
__device__ __forceinline__ void load_words(const uint32_t* ring, long long x,
                                           uint32_t w[5]) {
  const uint32_t* p = ring + ((x & (kRing - 1)) >> 2);
#pragma unroll
  for (int j = 0; j < 5; ++j) w[j] = p[j];
}

__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
hh256_kernel(const uint8_t* __restrict__ data, long long n_rows,
             long long row_stride, long long length, int rows_per_warp,
             uint64_t k0, uint64_t k1, uint64_t k2, uint64_t k3,
             uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 =
      ((long long)blockIdx.x * (blockDim.x >> 5) + warp) * rows_per_warp;
  if (row0 >= n_rows) return;                  // whole warp leaves together
  const int rows = static_cast<int>(
      n_rows - row0 < rows_per_warp ? n_rows - row0 : rows_per_warp);
  uint8_t* warp_ring = smem + warp * rows_per_warp * kRowSlot;
  const uint32_t ring0 =
      static_cast<uint32_t>(__cvta_generic_to_shared(warp_ring));
  const uint8_t* row0_ptr = data + row0 * row_stride;

  // lane pair `pr` hashes row row0 + pr; lane h of the pair holds state
  // lanes 2h, 2h+1. Lanes past the warp's rows shadow its last row and
  // store nothing.
  const int h = lane & 1;
  const int pr = lane >> 1;
  const bool valid = pr < rows;
  const int my = valid ? pr : rows - 1;
  const uint8_t* p = row0_ptr + my * row_stride;
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
  const uint8_t* ring = warp_ring + my * kRowSlot;
  const uint32_t* ring_w = reinterpret_cast<const uint32_t*>(ring);

  Half s;
  {
    const uint64_t ka = h ? k2 : k0, kb = h ? k3 : k1;
    s.mul0[0] = h ? 0x13198a2e03707344ull : 0xdbe6d5d5fe4cce2full;
    s.mul0[1] = h ? 0x243f6a8885a308d3ull : 0xa4093822299f31d0ull;
    s.mul1[0] = h ? 0xbe5466cf34e90c6cull : 0x3bd39e10cb0ef593ull;
    s.mul1[1] = h ? 0x452821e638d01377ull : 0xc0acf169b5f18a8cull;
    s.v0[0] = s.mul0[0] ^ ka;
    s.v0[1] = s.mul0[1] ^ kb;
    s.v1[0] = s.mul1[0] ^ rot32(ka);
    s.v1[1] = s.mul1[1] ^ rot32(kb);
  }

  const long long full = length / 32;
  // chunks that hold a byte of some row of the warp (offsets up to 15)
  const long long n_chunks = length ? (15 + length + kChunk - 1) / kChunk : 0;
  const long long packet_chunks = (full + kPackets - 1) / kPackets;
  const int shift = 8 * (off & 3);

#pragma unroll
  for (int c = 0; c < kDepth - 1; ++c) {
    stage_chunk(c, n_chunks, row0_ptr, row_stride, rows, length, ring0, lane);
    cp_async_commit();
  }
  uint32_t w[5];
  for (long long c = 0; c < packet_chunks; ++c) {
    __syncwarp();                   // every lane is done with chunk c - 1
    stage_chunk(c + kDepth - 1, n_chunks, row0_ptr, row_stride, rows, length,
                ring0, lane);
    cp_async_commit();
    cp_async_wait<kDepth - 2>();    // chunks c and c + 1 have landed
    __syncwarp();
    // a half-packet is five words of stream bytes x .. x + 19; the last
    // packet of chunk c reaches into chunk c + 1. The next packet's words
    // are loaded before this one's update.
    long long x = off + 16 * h + c * kChunk;   // stream byte of packet
    if (c == 0) load_words(ring_w, x, w);
    const int n_packets = static_cast<int>(
        full - c * kPackets < kPackets ? full - c * kPackets : kPackets);
#pragma unroll 1
    for (int j = 0; j < n_packets; ++j) {
      const uint64_t l0 = __funnelshift_r(w[0], w[1], shift) |
                          (uint64_t)__funnelshift_r(w[1], w[2], shift) << 32;
      const uint64_t l1 = __funnelshift_r(w[2], w[3], shift) |
                          (uint64_t)__funnelshift_r(w[3], w[4], shift) << 32;
      x += 32;
      load_words(ring_w, x, w);
      update(s, l0, l1);
    }
  }
  cp_async_wait<0>();
  __syncwarp();

  const int n = static_cast<int>(length & 31);
  if (n) {
    // remainder packet (highwayhash_py.HighwayHash._update_remainder):
    // each lane assembles its 16 bytes from the staged tail
    const long long tail = off + 32 * full;
    const int mod4 = n & 3, base = n & ~3;
    uint64_t half_packet[2] = {0, 0};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int g = 16 * h + b;
      int src = -1;
      if ((n & 16) && g >= 28) src = n - 4 + (g - 28);
      else if (g < base) src = g;
      else if (!(n & 16) && mod4 && g == 16) src = base;
      else if (!(n & 16) && mod4 && g == 17) src = base + (mod4 >> 1);
      else if (!(n & 16) && mod4 && g == 18) src = n - 1;
      if (src >= 0)
        half_packet[b >> 3] |=
            static_cast<uint64_t>(ring[(tail + src) & (kRing - 1)])
            << (8 * (b & 7));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s.v0[i] += (static_cast<uint64_t>(n) << 32) + n;
      const uint32_t h0 = static_cast<uint32_t>(s.v1[i]);
      const uint32_t h1 = static_cast<uint32_t>(s.v1[i] >> 32);
      s.v1[i] = static_cast<uint64_t>((h0 << n) | (h0 >> (32 - n))) |
                (static_cast<uint64_t>((h1 << n) | (h1 >> (32 - n))) << 32);
    }
    update(s, half_packet[0], half_packet[1]);
  }
  // finalisation: lane h takes rot32 of the other pair's v0
  for (int r = 0; r < 10; ++r) {
    const uint64_t o0 = __shfl_xor_sync(0xffffffffu, s.v0[0], 1);
    const uint64_t o1 = __shfl_xor_sync(0xffffffffu, s.v0[1], 1);
    update(s, rot32(o0), rot32(o1));
  }
  if (!valid) return;
  // modular reduction of this pair: output words 2h, 2h+1
  const uint64_t a3 = (s.v1[1] + s.mul1[1]) & 0x3FFFFFFFFFFFFFFFull;
  const uint64_t a2 = s.v1[0] + s.mul1[0];
  const uint64_t a1 = s.v0[1] + s.mul0[1];
  const uint64_t a0 = s.v0[0] + s.mul0[0];
  ulonglong2 o;
  o.x = a0 ^ (a2 << 1) ^ (a2 << 2);
  o.y = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  *reinterpret_cast<ulonglong2*>(out + (row0 + pr) * 32 + 16 * h) = o;
}

}  // namespace

extern "C" {

// data: n_rows rows of row_stride bytes (device memory); hashes the first
// `length` bytes of each row with the key (k0..k3, little-endian u64
// words) into out (n_rows, 32), on the current device. Returns the CUDA
// error of the launch (cudaGetLastError()).
int hh256_launch(const void* data, long long n_rows, long long row_stride,
                 long long length, unsigned long long k0,
                 unsigned long long k1, unsigned long long k2,
                 unsigned long long k3, void* out, void* stream) {
  if (n_rows < 1 || length < 0 || length > row_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long schedulers = 4LL * n_sm;
  long long rpw = (n_rows + schedulers - 1) / schedulers;
  if (rpw > kMaxRowsPerWarp) rpw = kMaxRowsPerWarp;
  const long long warps = (n_rows + rpw - 1) / rpw;
  long long wpb = (warps + n_sm - 1) / n_sm;
  if (wpb > kMaxWarpsPerBlock) wpb = kMaxWarpsPerBlock;
  const long long blocks = (warps + wpb - 1) / wpb;
  const int smem = static_cast<int>(wpb * rpw * kRowSlot);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(hh256_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  hh256_kernel<<<static_cast<unsigned>(blocks),
                 static_cast<unsigned>(32 * wpb), smem,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n_rows, row_stride, length,
      static_cast<int>(rpw), k0, k1, k2, k3, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
