// GF(2^8) matrix apply as a GF(2) bit-matrix product on the tensor cores
// (Hopper, sm_90a):
//     out[b, j, t] = XOR_i gf_mul(M[j, i], in[b, i, t])
// computed as  bits(out[b, :, t]) = bits(in[b, :, t]) . BM^T mod 2  with
// BM the [8r, 8k] GF(2) expansion of M (gf256.bit_matrix: row j*8 + c is
// output byte j bit c, column i*8 + b is input shard i bit b).
//
// Replaces: experiments/rs_i8_kernel.py _rs_kernel8 (pallas_call at :78,
// rs_apply8), the experiment behind the TPU's u32 encoder. The TPU kernel
// bitcasts u32 words to byte rows, which puts the 4 byte slots of a word
// on rows, so its bit matrix is block-diagonal [32r, 32k] over the slots
// and 3/4 of its matrix-unit work is a product with zeros. Here a word
// tensor viewed as bytes IS the byte layout, so the product needs only the
// [8r, 8k] bit matrix over byte lanes (EC 8+4: [32, 64]).
//
// Bound on the H100: device-memory bytes. At the 256-block bucket of
// EC 8+4 (256 x 8 x 128 KiB in, 256 x 4 x 128 KiB out) the bytes take
// 0.120 ms at 3.35 TB/s. The tensor-core work is 2^21 m-tiles of 16 byte
// lanes x 4 n-tiles, one binary mma.sync m16n8k128 each: 2.7e11 bit
// operations, 0.038 ms at the rate mtt_mma_probe measured for that shape
// on an H100 (7.3e15 a second). The int8 form (m16n8k32 s8, 1.26e15 a
// second on the same probe) would need 1.37e11 operations, 0.109 ms.
//
// Design: mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc. The
// low bit of popc(row AND column) is the GF(2) dot product.
//   * A (16 x 128 bits) is data: rows are byte lanes, K runs shard-major
//     and bit-minor (K = 8i + b), so thread (g, tig)'s A register, K bits
//     32tig..32tig+31, is one word holding the bytes of shards 4tig..
//     4tig+3 at one lane, shard 4tig+e in byte e. k <= 16 shards take one
//     mma; the shards past k are zero.
//   * A warp step covers 128 byte lanes in 8 m-tiles. Row g of m-tile q
//     is lane 16g + q and row g + 8 is lane 16g + 8 + q, so over the 8
//     m-tiles thread (g, tig) needs lanes 16g..16g+15 of its four shards:
//     four 16-byte loads, all issued before the first product (and the
//     next step's issued before this step's products). The layout shares
//     the loads: the four threads of a group load different shards, so no
//     byte is loaded twice and no shuffle is needed, and for each shard
//     the 8 groups read 128 consecutive bytes. A 4 x 4 byte transpose
//     (transpose4, 8 __byte_perm) of each quarter of the loads gives the
//     16 A words, one per lane.
//   * B (128 x 8 bits) is BM^T, fixed for the launch and laid out by the
//     wrapper (rs_i8_kernel.b_fragments) as [row group][32 lanes] x 4
//     n-tile words, copied to shared memory. Its columns are permuted so
//     that in row group grp, n-tile t, column 2*tig + e is output byte
//     4grp + tig, bit 2t + e. The accumulator holds row g, columns 2tig
//     and 2tig + 1 in d0, d1 and row g + 8 in d2, d3: over the 4 n-tiles
//     thread (g, tig) gets all 8 bits of output byte 4grp + tig for both
//     of its lanes of the m-tile.
//   * Each thread inserts each low bit into its output word with one
//     bit-field insert (no ballots, no cross-lane traffic) and, after the
//     8 m-tiles, holds lanes 16g..16g+15 of output row 4grp + tig: one
//     16-byte store.
//   * Ragged lanes (L % 16 != 0, or unaligned rows) take a masked byte
//     path inside the same kernel: bytes past L load as 0, none is stored.
// grid = (ceil(chunks / (8 warps x 4 chunks)), B); 256 threads a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;          // byte lanes per warp step
constexpr int kChunksPerWarp = 4;
// Blocks an SM that __launch_bounds__ asks registers for (3: at most 80
// a thread, no spills): 24 warps an SM keep more loads in flight than
// 16 warps of 128 registers. tools/rs_i8_variants.py times other values.
constexpr int kMinBlocks = 3;
constexpr int kUnrollVec = 4;        // warp steps unrolled, aligned path
constexpr int kMaxShards = 16;       // 4 threads x 4 shards: K of 128 bits
constexpr int kMaxRows = 32;         // 8 row groups of B in shared memory

// __byte_perm selectors of the 4 x 4 byte transpose: byte n of the result
// is byte (sel >> 4n) & 7 of (x, y), y's bytes being 4..7.
constexpr uint32_t kPairLo = 0x5140;  // (a, b) -> a0 b0 a1 b1
constexpr uint32_t kPairHi = 0x7362;  // (a, b) -> a2 b2 a3 b3
constexpr uint32_t kHalfLo = 0x5410;  // (p, q) -> p0 p1 q0 q1
constexpr uint32_t kHalfHi = 0x7632;  // (p, q) -> p2 p3 q2 q3

// In: byte y of a, b, c, d is lane y of shards 0..3. Out: a, b, c, d are
// lanes 0..3, shard e in byte e of each.
__device__ __forceinline__ void transpose4(uint32_t& a, uint32_t& b,
                                           uint32_t& c, uint32_t& d) {
  const uint32_t p0 = __byte_perm(a, b, kPairLo);
  const uint32_t p1 = __byte_perm(a, b, kPairHi);
  const uint32_t p2 = __byte_perm(c, d, kPairLo);
  const uint32_t p3 = __byte_perm(c, d, kPairHi);
  a = __byte_perm(p0, p2, kHalfLo);
  b = __byte_perm(p0, p2, kHalfHi);
  c = __byte_perm(p1, p3, kHalfLo);
  d = __byte_perm(p1, p3, kHalfHi);
}

// d += popc(A AND B) over K = 128: m16n8k128, A rows g and g + 8 in a0 and
// a1 (K bits 32tig..32tig+31), B column g in b0 (the same K bits).
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// w with bit `pos` replaced by bit 0 of v: one BFI. Volatile, like the
// mma, so that the compiler keeps each m-tile's inserts before the next
// m-tile's products and holds 16 accumulators, not all 128 of a group.
__device__ __forceinline__ uint32_t insert_bit(uint32_t w, uint32_t v,
                                               uint32_t pos) {
  uint32_t out;
  asm volatile("bfi.b32 %0, %1, %2, %3, 1;"
               : "=r"(out) : "r"(v), "r"(w), "r"(pos));
  return out;
}

template <bool kVec>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ shard,
                                        long long len, long long pos) {
  if (pos >= len) return make_uint4(0, 0, 0, 0);
  const uint8_t* p = shard + pos;
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(p));
  const int n = len - pos < 16 ? (int)(len - pos) : 16;
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) w[i >> 2] |= (uint32_t)p[i] << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* __restrict__ row,
                                        long long len, long long pos,
                                        const uint32_t (&v)[4]) {
  if (pos >= len) return;
  uint8_t* p = row + pos;
  if (kVec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
  const int n = len - pos < 16 ? (int)(len - pos) : 16;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < n) p[i] = (uint8_t)(v[i >> 2] >> (8 * (i & 3)));
}

// Lanes pos..pos+15 of this thread's shards 4tig + e (zero past k).
template <bool kVec>
__device__ __forceinline__ void load_step(uint4 (&w)[4],
                                          const uint8_t* __restrict__ inb,
                                          int k, int tig, long long len,
                                          long long pos) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int s = 4 * tig + e;
    w[e] = s < k ? load16<kVec>(inb + (long long)s * len, len, pos)
                 : make_uint4(0, 0, 0, 0);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rs_i8_kernel(const uint4* __restrict__ bfrag, int r, int k,
             const uint8_t* __restrict__ in, long long in_bstride,
             uint8_t* __restrict__ out, long long out_bstride,
             long long len) {
  extern __shared__ uint4 sb[];  // [ceil(r/4)][32 lanes] x 4 n-tiles
  const int groups = (r + 3) / 4;
  for (int i = threadIdx.x; i < groups * 32; i += blockDim.x)
    sb[i] = bfrag[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const uint8_t* inb = in + (long long)blockIdx.y * in_bstride;
  uint8_t* outb = out + (long long)blockIdx.y * out_bstride;
  const long long nchunks = (len + kChunk - 1) / kChunk;
  const long long first =
      ((long long)blockIdx.x * kWarps + warp) * kChunksPerWarp;
  if (first >= nchunks) return;  // warp-uniform
  const int steps = nchunks - first < kChunksPerWarp
                        ? (int)(nchunks - first) : kChunksPerWarp;

  uint4 w[4];  // this step's loads, then the next step's
  load_step<kVec>(w, inb, k, tig, len, first * kChunk + 16 * g);
#pragma unroll (kVec ? kUnrollVec : 1)
  for (int ci = 0; ci < kChunksPerWarp; ++ci) {
    if (ci >= steps) break;
    const long long pos = (first + ci) * kChunk + 16 * g;
    uint32_t x[4][4];  // x[quarter][e]: lanes 4 quarter..+3 of shard 4tig+e
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[0][e] = w[e].x;
      x[1][e] = w[e].y;
      x[2][e] = w[e].z;
      x[3][e] = w[e].w;
    }
    if (ci + 1 < steps)  // the next step's loads fly over this one's work
      load_step<kVec>(w, inb, k, tig, len, pos + kChunk);
    // a[j]: lane 16g + j, byte e = shard 4tig + e.
    uint32_t a[16];
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {
      transpose4(x[qr][0], x[qr][1], x[qr][2], x[qr][3]);
#pragma unroll
      for (int y = 0; y < 4; ++y) a[4 * qr + y] = x[qr][y];
    }
    for (int grp = 0; grp < groups; ++grp) {
      const uint4 b4 = sb[grp * 32 + lane];
      const uint32_t b[4] = {b4.x, b4.y, b4.z, b4.w};
      uint32_t res[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        // m-tile q: row g is lane 16g + q, row g + 8 lane 16g + 8 + q:
        // bytes q and 8 + q of this thread's 16 output bytes; n-tile t
        // gives bits 2t and 2t + 1 of both.
        int d[4][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0;
          mma_b1(d[t], a[q], a[8 + q], b[t]);
        }
        uint32_t& lo = res[q >> 2];
        uint32_t& hi = res[2 + (q >> 2)];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t bit = 8 * (q & 3) + 2 * t;
          lo = insert_bit(lo, d[t][0], bit);
          lo = insert_bit(lo, d[t][1], bit + 1);
          hi = insert_bit(hi, d[t][2], bit);
          hi = insert_bit(hi, d[t][3], bit + 1);
        }
      }
      const int row = 4 * grp + tig;
      if (row < r) store16<kVec>(outb + (long long)row * len, len, pos, res);
    }
  }
}

// -- tensor-core rate probe ---------------------------------------------
// Each thread keeps 8 independent accumulator chains of one mma shape and
// issues `iters` rounds of them; the wrapper times the launch with CUDA
// events. kind 0: m16n8k128 b1 AND+POPC (this kernel's), kind 1:
// m16n8k32 s8 (the int8 form's).
template <int kKind>
__global__ void __launch_bounds__(kThreads)
mma_probe_kernel(int iters, int* __restrict__ out) {
  const uint32_t t = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  const uint4 a = make_uint4(t, t ^ 0x55555555u, t * 3u, ~t);
  const uint32_t b0 = t >> 3, b1 = t * 7u;
  int acc[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (kKind == 0) mma_b1(acc[c], a.x, a.y, b0);
      else mma_s8(acc[c], a, b0, b1);
    }
  }
  int sum = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c)
    sum += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <bool kVec>
cudaError_t launch(const uint4* bfrag, int r, int k, const uint8_t* in,
                   long long in_bstride, uint8_t* out, long long out_bstride,
                   long long batch, long long len, cudaStream_t stream) {
  const size_t smem = (size_t)((r + 3) / 4) * 32 * sizeof(uint4);
  const long long chunks = (len + kChunk - 1) / kChunk;
  const long long per_block = (long long)kWarps * kChunksPerWarp;
  dim3 grid((unsigned)((chunks + per_block - 1) / per_block),
            (unsigned)batch);
  rs_i8_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      bfrag, r, k, in, in_bstride, out, out_bstride, len);
  return cudaGetLastError();
}

}  // namespace

// bfrag: device [ceil(r/4)][32 lanes] x 4 words, BM^T in m16n8k128 B
// fragment order (rs_i8_kernel.b_fragments); in: [batch, k, len] with
// shard rows len bytes apart; out: [batch, r, len] likewise. vec != 0
// promises 16-byte alignment of in, out, len and both batch strides.
// Returns the cudaError_t of the launch (0 = launched).
extern "C" int mtt_rs_i8(const void* bfrag, int r, int k, const void* in,
                         long long in_bstride, void* out,
                         long long out_bstride, long long batch,
                         long long len, int vec, void* stream) {
  if (r <= 0 || k <= 0 || batch <= 0 || len <= 0) return 0;
  if (k > kMaxShards || r > kMaxRows || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* b = static_cast<const uint4*>(bfrag);
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(b, r, k, i, in_bstride, o, out_bstride,
                                  batch, len, s)
                   : launch<false>(b, r, k, i, in_bstride, o, out_bstride,
                                   batch, len, s));
}

// One launch of the rate probe: `blocks` blocks of 256 threads, each
// thread 8 x iters mma of the shape `kind` (0: b1 m16n8k128, 1: s8
// m16n8k32); out: int32 [blocks * 256]. Returns the launch's cudaError_t.
extern "C" int mtt_mma_probe(int kind, int blocks, int iters, void* out,
                             void* stream) {
  if (blocks <= 0 || iters <= 0 || kind < 0 || kind > 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (kind == 0) mma_probe_kernel<0><<<blocks, kThreads, 0, s>>>(iters, o);
  else mma_probe_kernel<1><<<blocks, kThreads, 0, s>>>(iters, o);
  return (int)cudaGetLastError();
}
