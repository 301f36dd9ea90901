// Keyed HighwayHash-256 of many independent streams, for Hopper (sm_90a).
//
// Replaces: minio_tpu/ops/hh_device.py _hh_kernel_nt (pallas_call at :525,
// natural stream-major layout, in-VMEM transpose) and _hh_kernel
// (pallas_call at :543, pre-transposed packet-major layout), together
// with the XLA remainder path (_remainder, hh_device.py:204-231) that the
// TPU package sends ragged final packets to. One kernel covers all three:
// it reads each stream in its natural layout, any length, any stride.
// The bitrot digest of every shard block (PUT framer, GET deframer,
// degraded-read verify) is this hash under the bitrot magic key.
//
// Bound on the H100 (3.35 TB/s, 132 SMs). By the roofline, device-memory
// bytes: each stream read once, 32 bytes written. An EC 8+4 window of
// 384 x 128 KiB streams is 0.0150 ms; the batcher's 256-block bucket,
// 3,072 streams, is 0.120 ms. Above that sits a floor the roofline does
// not see: each packet's update depends on the previous one (v1 += mul0 +
// packet, zipper merge into v0, zipper merge into v1), so one 128 KiB
// stream is a chain of 4,096 + 10 dependent updates, whatever the stream
// count. One stream alone takes 0.199 ms on an H100 80GB HBM3 at 700 W
// (chip_smoke.py), about 96 cycles a packet; 384 streams take 1.01x that
// and 3,072 streams 1.07x. The only parallelism is across streams; this
// kernel's job is to keep every SM fed so that a launch costs that floor
// (or the byte bound, whichever is larger) and no more.
//
// Design:
//  * Every SM busy. The wrapper (ops/hh_device.py launch_shape) splits the
//    S streams evenly over max(min(S, SMs), ceil(S / 64)) blocks; block b
//    hashes streams [b*S/blocks, (b+1)*S/blocks).
//  * A shared-memory ring per block, filled by 1-D bulk copies (TMA,
//    cp.async.bulk ... mbarrier::complete_tx::bytes). The ring has `stages`
//    slots; a slot holds `stage_bytes` of every stream of the block. One
//    elected thread (lane 0 of the last warp) keeps the copies in flight:
//    for each stage it waits on the slot's `empty` barrier, arms the slot's
//    `full` barrier with the stage's byte count and issues one bulk copy per
//    stream. The compute threads wait on `full`, read their packets from
//    shared memory and arrive on `empty`. Each stream's slot is padded by 32
//    bytes so that the 16-byte reads of a quarter warp (4 streams) fall in
//    distinct banks. Bulk copies need 16-byte aligned addresses and sizes;
//    only whole packets (a multiple of 32 bytes) go through the ring.
//  * Two threads per stream. A packet update never mixes HH lanes {0,1}
//    with {2,3} (the zipper merges pair 0 with 1 and 2 with 3), so thread
//    2j+h carries lanes {2h, 2h+1} of stream j through every update and the
//    ragged remainder. Only the 10 finalisation rounds cross pairs: the
//    permuted packet of a pair is the other pair's v0, which one
//    __shfl_xor_sync of two uint64_t per round brings over. Each thread
//    then writes its 16 bytes of the digest. The split halves each
//    thread's instructions and registers; it does not shorten the chain.
//  * Native uint64_t lane math: 32x32->64 products are one mul.wide.u32
//    (asked for in PTX: the C++ product compiled to a multiply and an add
//    of zero), the zipper merge is __byte_perm on 32-bit halves. The last
//    merge of an update (v0 into v1) is kept apart as z1 and added with
//    the next packet's (mul0 + packet), last: the chain from one packet to
//    the next is then one 64-bit add shorter.
//  * Streams whose base or stride is not 16-byte aligned take a byte-load
//    path from device memory (no ring), and so does the final partial
//    packet of every stream. Those are short tails and self-tests.
//
// A bad launch shape, or a refused launch or shared-memory attribute,
// comes back as a cudaError_t; nothing falls back to another path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlotPad = 32;          // bytes after each stream's ring slot
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may use
// __byte_perm selectors of the zipper merge over 32-bit halves (e = even
// lane, o = odd lane; bytes LSB first): even' = [e3 o4 e2 e5 | o6 e1 o7 e0],
// odd' = [o3 e4 o2 o5 | o1 e6 o0 e7]. A low word is two permutes: kZipLoA
// gathers [x3 y4 x2 .] from (x.lo, y.hi), kZipLoB puts z5 from z.hi on top.
constexpr uint32_t kZipLoA = 0x0243;
constexpr uint32_t kZipLoB = 0x5210;
constexpr uint32_t kZipEvenHi = 0x0716;
constexpr uint32_t kZipOddHi = 0x7061;

// The state of one lane pair: HH lanes {2h, 2h+1}. z1 is the zipper merge
// of v0 into v1 of the last update, not yet added to v1 (see flush).
struct Pair {
  uint64_t v0[2], v1[2], mul0[2], mul1[2], z1[2];
};

__device__ __forceinline__ uint64_t rot32(uint64_t x) {
  return (x >> 32) | (x << 32);
}

__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return ((uint64_t)hi << 32) | lo;
}

// add0 += zipper(even lane v0, odd lane v1) even word, add1 += odd word.
__device__ __forceinline__ void zipper_merge_add(uint64_t v1, uint64_t v0,
                                                 uint64_t& add1,
                                                 uint64_t& add0) {
  const uint32_t el = (uint32_t)v0, eh = (uint32_t)(v0 >> 32);
  const uint32_t ol = (uint32_t)v1, oh = (uint32_t)(v1 >> 32);
  add0 += join(__byte_perm(__byte_perm(el, oh, kZipLoA), eh, kZipLoB),
               __byte_perm(el, oh, kZipEvenHi));
  add1 += join(__byte_perm(__byte_perm(ol, eh, kZipLoA), oh, kZipLoB),
               __byte_perm(ol, eh, kZipOddHi));
}

__device__ __forceinline__ uint64_t mul_wide(uint32_t a, uint32_t b) {
  uint64_t r;
  asm("mul.wide.u32 %0, %1, %2;" : "=l"(r) : "r"(a), "r"(b));
  return r;
}

// x + late, with `late` added last (in PTX, so that the compiler keeps the
// order): late is the end of the previous packet's dependent chain.
__device__ __forceinline__ uint64_t add_last(uint64_t x, uint64_t late) {
  uint64_t r;
  asm("{\n .reg .u32 xl, xh, ll, lh, rl, rh;\n"
      " mov.b64 {xl, xh}, %1;\n mov.b64 {ll, lh}, %2;\n"
      " add.cc.u32 rl, xl, ll;\n addc.u32 rh, xh, lh;\n"
      " mov.b64 %0, {rl, rh};\n}"
      : "=l"(r)
      : "l"(x), "l"(late));
  return r;
}

// One packet update of a lane pair; a, b are the pair's two packet lanes.
__device__ __forceinline__ void update(Pair& s, uint64_t a, uint64_t b) {
  const uint64_t lanes[2] = {a, b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] = add_last(s.v1[i] + s.mul0[i] + lanes[i], s.z1[i]);
    s.mul0[i] ^= mul_wide((uint32_t)s.v1[i], (uint32_t)(s.v0[i] >> 32));
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul_wide((uint32_t)s.v0[i], (uint32_t)(s.v1[i] >> 32));
  }
  zipper_merge_add(s.v1[1], s.v1[0], s.v0[1], s.v0[0]);
  s.z1[0] = s.z1[1] = 0;
  zipper_merge_add(s.v0[1], s.v0[0], s.z1[1], s.z1[0]);
}

// Adds the pending merge into v1: the state is then the reference's.
__device__ __forceinline__ void flush(Pair& s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] += s.z1[i];
    s.z1[i] = 0;
  }
}

__device__ __forceinline__ uint64_t load_le64(const uint8_t* p) {
  uint64_t x = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) x |= (uint64_t)p[c] << (8 * c);
  return x;
}

// The final partial packet (0 < mod < 32) of the pair's half.
__device__ void update_remainder(Pair& s, const uint8_t* tail, int mod,
                                 int half) {
  flush(s);
  const int mod4 = mod & 3;
  const int rem = mod & ~3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v0[i] += ((uint64_t)mod << 32) + (uint64_t)mod;
    // rotate each 32-bit half of v1 left by mod
    const uint32_t lo = (uint32_t)s.v1[i], hi = (uint32_t)(s.v1[i] >> 32);
    s.v1[i] = join((lo << mod) | (lo >> (32 - mod)),
                   (hi << mod) | (hi >> (32 - mod)));
  }
  uint8_t packet[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) packet[i] = 0;
  for (int i = 0; i < rem; ++i) packet[i] = tail[i];
  if (mod & 16) {
    for (int i = 0; i < 4; ++i) packet[28 + i] = tail[rem + i + mod4 - 4];
  } else if (mod4) {
    packet[16] = tail[rem];
    packet[17] = tail[rem + (mod4 >> 1)];
    packet[18] = tail[rem + mod4 - 1];
  }
  update(s, load_le64(packet + 16 * half), load_le64(packet + 16 * half + 8));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-aligned) from
// device memory into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// kRing: whole packets through the shared-memory ring (16-byte aligned
// base and stride); otherwise byte loads from device memory.
template <bool kRing>
__global__ void hh256_kernel(const uint8_t* __restrict__ data,
                             long long nstreams, long long stride,
                             long long len, uint64_t k0, uint64_t k1,
                             uint64_t k2, uint64_t k3, int spb, int stages,
                             int stage_bytes, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t ring[];
  const long long first = (long long)blockIdx.x * nstreams / gridDim.x;
  const int count =
      (int)((long long)(blockIdx.x + 1) * nstreams / gridDim.x - first);
  const int compute = 32 * ((2 * spb + 31) / 32);  // compute threads
  const int slot = stage_bytes + kSlotPad;
  const long long body = len / 32 * 32;  // whole packets
  const int nstg = kRing ? (int)((body + stage_bytes - 1) / stage_bytes) : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * spb * slot);
  uint64_t* empty = full + stages;

  if (kRing) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < stages; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], 2 * count);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  if (threadIdx.x >= compute) {  // the producer warp
    if (kRing && threadIdx.x == compute) {
      for (int t = 0; t < nstg; ++t) {
        const int st = t % stages;
        if (t >= stages) mbar_wait(&empty[st], (uint32_t)((t / stages - 1) & 1));
        const long long off = (long long)t * stage_bytes;
        const uint32_t bytes =
            (uint32_t)(body - off < stage_bytes ? body - off : stage_bytes);
        mbar_arrive_expect_tx(&full[st], bytes * (uint32_t)count);
        for (int j = 0; j < count; ++j)
          bulk_load(ring + (st * spb + j) * slot,
                    data + (first + j) * stride + off, bytes, &full[st]);
      }
    }
    return;
  }
  if ((int)threadIdx.x >= 2 * count) return;

  const int j = threadIdx.x >> 1, half = threadIdx.x & 1;
  const long long sidx = first + j;
  const uint8_t* p = data + sidx * stride;

  const uint64_t init0[4] = {0xdbe6d5d5fe4cce2full, 0xa4093822299f31d0ull,
                             0x13198a2e03707344ull, 0x243f6a8885a308d3ull};
  const uint64_t init1[4] = {0x3bd39e10cb0ef593ull, 0xc0acf169b5f18a8cull,
                             0xbe5466cf34e90c6cull, 0x452821e638d01377ull};
  const uint64_t key[2] = {half ? k2 : k0, half ? k3 : k1};
  Pair s;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint64_t i0 = init0[2 * half + i], i1 = init1[2 * half + i];
    s.v0[i] = i0 ^ key[i];
    s.v1[i] = i1 ^ rot32(key[i]);
    s.mul0[i] = i0;
    s.mul1[i] = i1;
    s.z1[i] = 0;
  }

  if (kRing) {
    const uint8_t* mine = ring + j * slot + 16 * half;
    for (int t = 0; t < nstg; ++t) {
      const int st = t % stages;
      mbar_wait(&full[st], (uint32_t)((t / stages) & 1));
      const long long left = body - (long long)t * stage_bytes;
      const int npk = (int)((left < stage_bytes ? left : stage_bytes) / 32);
      const uint8_t* q = mine + st * spb * slot;
#pragma unroll 4
      for (int pk = 0; pk < npk; ++pk) {
        const uint4 w = *reinterpret_cast<const uint4*>(q + 32 * pk);
        update(s, join(w.x, w.y), join(w.z, w.w));
      }
      mbar_arrive(&empty[st]);
    }
  } else {
    for (long long pk = 0; pk < body / 32; ++pk) {
      const uint8_t* pp = p + pk * 32 + 16 * half;
      update(s, load_le64(pp), load_le64(pp + 8));
    }
  }
  const int mod = (int)(len & 31);
  if (mod) update_remainder(s, p + body, mod, half);

  // Pair exchange: the permuted packet of lanes {2h, 2h+1} is rot32 of the
  // other pair's v0, which lives in the neighbouring thread.
  const unsigned pair_mask = 3u << (threadIdx.x & 30);
  for (int round = 0; round < 10; ++round) {
    const uint64_t o0 =
        __shfl_xor_sync(pair_mask, (unsigned long long)s.v0[0], 1);
    const uint64_t o1 =
        __shfl_xor_sync(pair_mask, (unsigned long long)s.v0[1], 1);
    update(s, rot32(o0), rot32(o1));
  }
  flush(s);
  const uint64_t a3 = (s.v1[1] + s.mul1[1]) & 0x3fffffffffffffffull;
  const uint64_t a2 = s.v1[0] + s.mul1[0];
  const uint64_t a1 = s.v0[1] + s.mul0[1];
  const uint64_t a0 = s.v0[0] + s.mul0[0];
  uint64_t* o64 = reinterpret_cast<uint64_t*>(out + sidx * 32 + 16 * half);
  o64[0] = a0 ^ (a2 << 1) ^ (a2 << 2);  // little-endian digest bytes
  o64[1] = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
}

}  // namespace

// data: stream i's bytes are data[i*stride, i*stride + len); key: the
// 32-byte HighwayHash key as four little-endian u64 lanes; out: device u8
// [nstreams, 32], 8-byte aligned. The launch shape comes from
// ops/hh_device.py launch_shape: `blocks` blocks of `threads` threads, at
// most `spb` streams a block; `stages` > 0 selects the ring (data and
// stride 16-byte aligned) with `stage_bytes` per stream and stage in
// `smem_bytes` of dynamic shared memory, `stages` == 0 the byte path.
// Returns the cudaError_t of the launch (0 = launched);
// cudaErrorInvalidValue for a shape this kernel cannot run.
extern "C" int mtt_hh256(const void* data, long long nstreams,
                         long long stride, long long len,
                         unsigned long long k0, unsigned long long k1,
                         unsigned long long k2, unsigned long long k3,
                         void* out, int spb, int blocks, int threads,
                         int stages, int stage_bytes, int smem_bytes,
                         void* stream) {
  if (nstreams <= 0) return 0;
  const bool ring = stages > 0;
  const long long slots = (long long)stages * spb;
  const bool ok =
      spb >= 1 && blocks >= 1 && blocks <= nstreams &&
      (long long)blocks * spb >= nstreams &&
      threads == 32 * ((2 * spb + 31) / 32 + 1) && threads <= 1024 &&
      (!ring ||
       (stage_bytes >= 32 && stage_bytes % 32 == 0 &&
        (uintptr_t)data % 16 == 0 && (nstreams == 1 || stride % 16 == 0) &&
        len >= 32 && smem_bytes <= kMaxSmem &&
        smem_bytes == slots * (stage_bytes + kSlotPad) + 16LL * stages)) &&
      (ring || smem_bytes == 0);
  if (!ok) return (int)cudaErrorInvalidValue;
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (ring) {
    // Once per process: let the ring kernel take up to kMaxSmem.
    static const cudaError_t attr = cudaFuncSetAttribute(
        hh256_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (attr != cudaSuccess) return (int)attr;
    hh256_kernel<true><<<blocks, threads, smem_bytes, s>>>(
        d, nstreams, stride, len, k0, k1, k2, k3, spb, stages, stage_bytes, o);
  } else {
    hh256_kernel<false><<<blocks, threads, 0, s>>>(
        d, nstreams, stride, len, k0, k1, k2, k3, spb, 0, 0, o);
  }
  return (int)cudaGetLastError();
}
