// GF(2^8) matrix apply for Hopper (sm_90a):
//     out[b, j, t] = XOR_i gf_mul(M[j, i], in[b, i, t])
// for any r x k matrix M over GF(2^8) (polynomial 0x11D), the transform
// behind Reed-Solomon parity (encode) and decode-matrix reconstruct.
//
// Replaces: minio_tpu/ops/rs_device.py _rs_kernel32 (B1, pallas_call at
// :321, the u32-lane PUT encoder) and _rs_kernel (B2, pallas_call at :207,
// the byte path of degraded-read reconstruct, ragged tails and the boot
// gate). Both compute this function; the u32 contract is a byte view of
// little-endian words, so one byte kernel serves both. The TPU kernels
// expand M into a GF(2) bit matrix and run an int8 MXU product because
// the TPU has no byte gather; Hopper has one (shared-memory loads), so
// this kernel looks products up.
//
// Bound on the H100: device-memory bytes. One pass reads k*L and writes
// r*L bytes per stripe (EC 8+4 window of 32 blocks: 32 MiB in, 16 MiB
// out, 15 us at 3.35 TB/s). Shared memory is what could stand between
// the kernel and that bound: a 1-byte lookup per (output row, input
// shard, byte) would be r*k*L lane-loads, at 32 lanes a clock per SM
// already as long as the bytes take, and random bytes into a 256-byte
// table hit two words of a bank on nearly every warp-load.
//
// Design:
// - Row-packed tables. For each group g of up to 4 output rows and each
//   input shard i, shared memory holds 256 words T[g][i][x] whose byte jj
//   is MUL[M[4g + jj, i]][x] (0 past r). One 4-byte lookup per input byte
//   gives the products for four output rows: ceil(r/4)*k*L lookups, a
//   quarter of the byte tables' at r = 4. A warp's 32 random lookups into
//   a 256-word table average ~3.2 wavefronts. A lookup's word index,
//   table and input byte together, is one __byte_perm (kLookup), so a
//   lookup costs that, an address add, the load and its XOR.
// - XOR first, transpose once. Each thread owns 16 consecutive byte
//   positions of every shard and keeps one word per position,
//   acc[p] ^= T[g][i][byte p of shard i], row jj in byte jj. XOR is
//   bytewise and a byte transpose is a permutation, so after the last
//   shard one 4 x 4 byte transpose of each group of four positions
//   (8 __byte_perm) gives the four output rows' words.
// - Loads in flight. The 16-byte loads of a group of up to kShardGroup
//   shards are all issued before the first lookup, so a thread has
//   k * 16 bytes in flight at k <= kShardGroup (the batcher's bucket-8
//   launches run about two blocks an SM). With k <= kShardGroup the words
//   stay in registers across row groups (r > 4); above it each row group
//   reads them again.
// - The ragged lane edge (L % 16 != 0) and unaligned rows take a masked
//   byte path inside the same kernel: bytes past L load as 0 and are not
//   stored.
// grid = (ceil(L / 16 / 256), B); shard rows are L bytes apart, stripes
// in_bstride / out_bstride bytes apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWord = 4;   // output rows packed into one table word
constexpr int kShardGroup = 8;    // input shards whose loads fly together

// __byte_perm selectors. Byte n of the result is byte (sel >> 4n) & 7 of
// (x, y), y's bytes being 4..7.
// The lookup index of byte c of input word w in table t (t < 256, as
// ceil(r/4) * k tables of 1 KiB fit shared memory): (t << 8) | byte c,
// as __byte_perm(w, t, kLookup + c), one instruction.
constexpr uint32_t kLookup = 0x5540;  // (w, t) -> w_c t0 0 0
// The 4 x 4 byte transpose (transpose4).
constexpr uint32_t kPairLo = 0x5140;  // (a, b) -> a0 b0 a1 b1
constexpr uint32_t kPairHi = 0x7362;  // (a, b) -> a2 b2 a3 b3
constexpr uint32_t kHalfLo = 0x5410;  // (p, q) -> p0 p1 q0 q1
constexpr uint32_t kHalfHi = 0x7632;  // (p, q) -> p2 p3 q2 q3

// In: a, b, c, d are four consecutive byte positions, output row jj in
// byte jj of each. Out: a, b, c, d are output rows 0..3, position n of
// the four in byte n of each.
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

// 16 bytes of a shard row from src: one 128-bit load when whole, else
// the first nvalid bytes one by one and zeros after them.
__device__ __forceinline__ uint4 load16(const uint8_t* src, bool whole,
                                        int nvalid) {
  if (whole) return __ldg(reinterpret_cast<const uint4*>(src));
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (4 * q + c < nvalid) word |= (uint32_t)src[4 * q + c] << (8 * c);
    w[q] = word;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint32_t* __restrict__ tables, int r, int k,
                const uint8_t* __restrict__ in, long long in_bstride,
                uint8_t* __restrict__ out, long long out_bstride,
                long long len) {
  extern __shared__ __align__(16) uint32_t tab[];
  const int groups = (r + kRowsPerWord - 1) / kRowsPerWord;
  const int ntab16 = groups * k * 64;  // 256-word tables in uint4 units
  const uint4* tsrc = reinterpret_cast<const uint4*>(tables);
  uint4* tdst = reinterpret_cast<uint4*>(tab);
  for (int i = threadIdx.x; i < ntab16; i += blockDim.x) tdst[i] = tsrc[i];
  __syncthreads();

  const long long t0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 16;
  if (t0 >= len) return;
  const uint8_t* inb = in + (long long)blockIdx.y * in_bstride + t0;
  uint8_t* outb = out + (long long)blockIdx.y * out_bstride + t0;
  const bool whole = kVec && t0 + 16 <= len;
  const int nvalid = (int)(len - t0 < 16 ? len - t0 : 16);
  const bool reload = k > kShardGroup;

  uint32_t w[kShardGroup][4];
  for (int g = 0; g < groups; ++g) {
    uint32_t acc[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) acc[p] = 0;

    for (int i0 = 0; i0 < k; i0 += kShardGroup) {
      if (g == 0 || reload) {
#pragma unroll
        for (int s = 0; s < kShardGroup; ++s) {
          if (i0 + s < k) {
            const uint4 v = load16(inb + (long long)(i0 + s) * len, whole,
                                   nvalid);
            w[s][0] = v.x; w[s][1] = v.y; w[s][2] = v.z; w[s][3] = v.w;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kShardGroup; ++s) {
        if (i0 + s < k) {
          const uint32_t t = (uint32_t)(g * k + i0 + s);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[4 * q + c] ^= tab[__byte_perm(w[s][q], t, kLookup + c)];
        }
      }
    }

#pragma unroll
    for (int q = 0; q < 4; ++q)
      transpose4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    // Now acc[4q + jj] is word q of output row 4g + jj.
#pragma unroll
    for (int jj = 0; jj < kRowsPerWord; ++jj) {
      const int j = g * kRowsPerWord + jj;
      if (j < r) {
        uint8_t* dst = outb + (long long)j * len;
        if (whole) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(
              acc[jj], acc[4 + jj], acc[8 + jj], acc[12 + jj]);
        } else {
#pragma unroll
          for (int p = 0; p < 16; ++p)  // static indices: acc stays in registers
            if (p < nvalid)
              dst[p] = (uint8_t)(acc[4 * (p >> 2) + jj] >> (8 * (p & 3)));
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const uint32_t* tables, int r, int k, const uint8_t* in,
                   long long in_bstride, uint8_t* out, long long out_bstride,
                   long long batch, long long len, cudaStream_t stream) {
  const size_t smem =
      (size_t)((r + kRowsPerWord - 1) / kRowsPerWord) * k * 256 * 4;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gf_apply_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // not sticky: keep it from the next launch's check
      return e;
    }
  }
  const long long chunks = (len + 15) / 16;
  dim3 grid((unsigned)((chunks + kThreads - 1) / kThreads), (unsigned)batch);
  gf_apply_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      tables, r, k, in, in_bstride, out, out_bstride, len);
  return cudaGetLastError();
}

}  // namespace

// tables: device u32 [ceil(r/4), k, 256] row-packed product tables (byte
// jj of word [g, i, x] is MUL[M[4g + jj, i]][x], 0 for rows past r);
// in: [batch, k, len] with shard rows len bytes apart; out: [batch, r,
// len] likewise. vec != 0 promises 16-byte alignment of in, out, len and
// both batch strides. Returns the cudaError_t of the launch (0 = launched).
extern "C" int mtt_gf_apply(const void* tables, int r, int k, const void* in,
                            long long in_bstride, void* out,
                            long long out_bstride, long long batch,
                            long long len, int vec, void* stream) {
  if (r <= 0 || k <= 0 || batch <= 0 || len <= 0) return 0;
  if ((r + kRowsPerWord - 1) / kRowsPerWord * k > 256)  // kLookup's table byte
    return (int)cudaErrorInvalidValue;
  const auto* t = static_cast<const uint32_t*>(tables);
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<true>(t, r, k, i, in_bstride, o, out_bstride,
                                  batch, len, s)
                   : launch<false>(t, r, k, i, in_bstride, o, out_bstride,
                                   batch, len, s));
}
