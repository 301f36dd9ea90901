// GF(2^8) matrix apply as a GF(2) bit-matrix product on the tensor cores
// (Hopper, sm_90a):
//     out[b, j, t] = XOR_i gf_mul(M[j, i], in[b, i, t])
// computed as  bits(out[b, :, t]) = BM @ bits(in[b, :, t]) mod 2  with BM
// the [8r, 8k] GF(2) expansion of M (gf256.bit_matrix: row j*8 + c is
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
// 0.120 ms at 3.35 TB/s; the needed int8 work, 2*32*64 per byte lane over
// 2^25 lanes = 1.37e11 operations, takes 0.069 ms at 1,979 TOPS.
//
// Design: mma.sync.aligned.m16n8k32 with s8 inputs and s32 accumulation.
//   * A (16 x 32) is a tile of BM, fixed for the launch: the wrapper lays
//     BM out in mma fragment order ([MT][KT][32 lanes] x 16 bytes, zero
//     padded to whole tiles) and each block copies it to shared memory.
//   * B (32 x 8) holds bits of 8 byte lanes. K runs shard-major and
//     bit-minor (i*8 + b), so the 4 consecutive K values a thread holds in
//     one B register are 4 bits of ONE data byte: the register is built
//     from a nibble, spread to four 0/1 bytes by one multiply.
//   * A warp takes 128 byte lanes of every shard per step: lane (g, tig)
//     loads 16 bytes at lane offset 16g of shards 4kt + tig/2 and
//     4kt + 2 + tig/2 (coalesced 128-byte rows). Column n of n-tile q is
//     byte lane 16n + q, so byte q of each thread's 16-byte load is its B
//     operand of n-tile q: 16 n-tiles per step, no shuffles on the way in.
//   * Repack: the accumulator's low bit is the output bit. One warp ballot
//     per accumulator register gathers bit g of 8 lanes' outputs; each
//     thread picks the ballot of its own output row and lane column, packs
//     every 4th bit into a byte, and after 16 n-tiles holds 16 consecutive
//     output bytes of one row, stored with one 128-bit store.
//   * Rows go in groups of 4 (two m-tiles); ragged lanes (len % 16 != 0,
//     or unaligned rows) take a masked byte path inside the same kernel.
// grid = (ceil(chunks / (8 warps x 4 chunks)), B); 256 threads a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;          // byte lanes per warp step
constexpr int kChunksPerWarp = 4;
constexpr int kMaxKT = 4;            // k <= 16 shards
constexpr int kMaxRows = 32;         // A fragments <= 32 KiB of shared memory

__device__ __forceinline__ uint32_t spread4(uint32_t nibble) {
  // bit e of the nibble -> byte e (0 or 1): the copies at shifts 0, 7, 14
  // and 21 occupy disjoint bit ranges, and copy e puts bit e at bit 8e.
  return (nibble * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ uint32_t gather8(uint32_t m) {
  // bits 0, 4, ..., 28 of m -> bits 0..7
  m &= 0x11111111u;
  m = (m | (m >> 3)) & 0x03030303u;
  m = (m | (m >> 6)) & 0x000F000Fu;
  return (m | (m >> 12)) & 0xFFu;
}

__device__ __forceinline__ uint32_t byte_of(const uint4& w, int q) {
  const uint32_t v = q < 4 ? w.x : q < 8 ? w.y : q < 12 ? w.z : w.w;
  return (v >> (8 * (q & 3))) & 0xFFu;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
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

template <int KT, bool kVec>
__global__ void __launch_bounds__(kThreads)
rs_i8_kernel(const uint4* __restrict__ afrag, int r, int k,
             const uint8_t* __restrict__ in, long long in_bstride,
             uint8_t* __restrict__ out, long long out_bstride,
             long long len) {
  extern __shared__ uint4 sa[];  // [MT][KT][32] A fragments
  const int mt = (r + 1) / 2;
  for (int i = threadIdx.x; i < mt * KT * 32; i += blockDim.x)
    sa[i] = afrag[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nib = (tig & 1) * 4;
  const int srow = lane >> 3, scol = lane & 7;  // store role in a group
  const uint8_t* inb = in + (long long)blockIdx.y * in_bstride;
  uint8_t* outb = out + (long long)blockIdx.y * out_bstride;
  const long long nchunks = (len + kChunk - 1) / kChunk;
  const long long first =
      ((long long)blockIdx.x * kWarps + warp) * kChunksPerWarp;

  for (int ci = 0; ci < kChunksPerWarp; ++ci) {
    const long long chunk = first + ci;
    if (chunk >= nchunks) break;  // warp-uniform
    const long long base = chunk * kChunk;

    uint4 w[KT][2];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = 4 * kt + 2 * h + (tig >> 1);
        w[kt][h] = s < k ? load16<kVec>(inb + (long long)s * len, len,
                                        base + 16 * g)
                         : make_uint4(0, 0, 0, 0);
      }

    for (int grp = 0; grp * 4 < r; ++grp) {
      uint4 a[2][KT];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          const int ut = 2 * grp + u;
          a[u][kt] = ut < mt ? sa[(ut * KT + kt) * 32 + lane]
                             : make_uint4(0, 0, 0, 0);
        }
      uint32_t res[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        uint32_t b[KT][2];
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            b[kt][h] = spread4((byte_of(w[kt][h], q) >> nib) & 0xFu);
        int acc[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[u][i] = 0;
#pragma unroll
          for (int kt = 0; kt < KT; ++kt)
            mma_s8(acc[u], a[u][kt], b[kt][0], b[kt][1]);
        }
        // acc[u][0]: bit g of out byte 2ut at lane column 2*tig,
        // acc[u][1]: same byte, column 2*tig + 1; acc[u][2], acc[u][3]:
        // out byte 2ut + 1. Column n is byte lane 16n + q.
        uint32_t m[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            m[u][i] = __ballot_sync(0xFFFFFFFFu, acc[u][i] & 1);
        // This thread stores row 4grp + srow (m-tile srow >> 1, half
        // srow & 1) at lane column scol (parity scol & 1, tig scol >> 1).
        const int sel = (srow & 1) * 2 + (scol & 1);
        const uint32_t m0 = sel == 0 ? m[0][0] : sel == 1 ? m[0][1]
                          : sel == 2 ? m[0][2] : m[0][3];
        const uint32_t m1 = sel == 0 ? m[1][0] : sel == 1 ? m[1][1]
                          : sel == 2 ? m[1][2] : m[1][3];
        const uint32_t byte = gather8((srow >> 1 ? m1 : m0) >> (scol >> 1));
        res[q >> 2] |= byte << (8 * (q & 3));
      }
      const int row = 4 * grp + srow;
      if (row < r)
        store16<kVec>(outb + (long long)row * len, len, base + 16 * scol, res);
    }
  }
}

template <int KT, bool kVec>
cudaError_t launch(const uint4* afrag, int r, int k, const uint8_t* in,
                   long long in_bstride, uint8_t* out, long long out_bstride,
                   long long batch, long long len, cudaStream_t stream) {
  const size_t smem = (size_t)((r + 1) / 2) * KT * 32 * sizeof(uint4);
  const long long chunks = (len + kChunk - 1) / kChunk;
  const long long per_block = (long long)kWarps * kChunksPerWarp;
  dim3 grid((unsigned)((chunks + per_block - 1) / per_block),
            (unsigned)batch);
  rs_i8_kernel<KT, kVec><<<grid, kThreads, smem, stream>>>(
      afrag, r, k, in, in_bstride, out, out_bstride, len);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch(const uint4* afrag, int r, int k, const uint8_t* in,
                     long long in_bstride, uint8_t* out,
                     long long out_bstride, long long batch, long long len,
                     cudaStream_t s) {
  switch ((k + 3) / 4) {
    case 1: return launch<1, kVec>(afrag, r, k, in, in_bstride, out,
                                   out_bstride, batch, len, s);
    case 2: return launch<2, kVec>(afrag, r, k, in, in_bstride, out,
                                   out_bstride, batch, len, s);
    case 3: return launch<3, kVec>(afrag, r, k, in, in_bstride, out,
                                   out_bstride, batch, len, s);
    case 4: return launch<4, kVec>(afrag, r, k, in, in_bstride, out,
                                   out_bstride, batch, len, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// afrag: device [ceil(r/2)][ceil(k/4)][32] x 16 bytes, the bit matrix in
// m16n8k32 A-fragment order; in: [batch, k, len] with shard rows len bytes
// apart; out: [batch, r, len] likewise. vec != 0 promises 16-byte
// alignment of in, out, len and both batch strides. Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int mtt_rs_i8(const void* afrag, int r, int k, const void* in,
                         long long in_bstride, void* out,
                         long long out_bstride, long long batch,
                         long long len, int vec, void* stream) {
  if (r <= 0 || k <= 0 || batch <= 0 || len <= 0) return 0;
  if (k > 4 * kMaxKT || r > kMaxRows || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const uint4*>(afrag);
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? dispatch<true>(a, r, k, i, in_bstride, o, out_bstride,
                                    batch, len, s)
                   : dispatch<false>(a, r, k, i, in_bstride, o, out_bstride,
                                     batch, len, s));
}
