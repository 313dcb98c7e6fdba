// Sliding-window attention kernel K5, bf16 and f16 paths, on Hopper's
// tensor cores (sm_90a: TMA, mbarrier, wgmma, setmaxnreg).
//
// Replaces (TPU/Pallas kernel of the reference package):
//   K5  src/repro/kernels/swa.py  _kernel  (sliding_window_attention, ops.swa)
// for bfloat16 and float16 q/k/v: one template over the 16-bit storage
// type T (Tc16<T> below).  float32 runs in three TF32 passes in
// swa_tf32.cu; what the two sources share (arguments, block geometry,
// online softmax) is in swa_common.cuh.
//
// What it computes, as the reference does: windowed-causal GQA attention.
// q is (B, Hq, S, D), k/v are (B, Hkv, S, D) with G = Hq / Hkv query heads
// per KV head; query position p attends to keys k with p - W < k <= p.
// Scores s = (q . k) * scale in f32 (scale = 1/sqrt(D), applied to the f32
// product, never folded into 16-bit q), optionally softcap * tanh(s /
// softcap), softmax over the valid keys and P.V in f32, the output rounded
// once to T at the store.
//
// Bound on this card: operations.  At gemma2-27b's local layer (B=1,
// Hq=32, Hkv=16, D=128, S=8192, W=4096) the useful work is
// 4*Hq*D*sum_p min(p+1, W) = 4.124e11 FLOP, 0.417 ms at 989 TFLOP/s of
// dense bf16 or f16; the 192 MiB of q/k/v/o take 0.06 ms at 3.35 TB/s.  Per
// score the kernel also runs a tanhf, an exp2f and a few f32 operations on
// the CUDA cores and the MUFU (8.05e8 scores at that shape).  f16 has the
// same bound (989 TFLOP/s of dense f16).
//
// Design:
// * One CTA per (batch, KV head, block of P query positions), the blocks
//   of one (batch, head) from the last down.  The G query heads of the KV
//   head are folded into ROWS = 128 rows head-major, row g*P + t = head g,
//   position p0 + t, so each head's rows are one TMA box of q.
//   P = floor(128 / G) rounded down to a multiple of 8 (a box must start
//   on a swizzle atom of 8 rows); the rows past G*P are spare, never
//   stored.  G = 2: P = 64.  Past 16 query heads per KV head the group
//   is split over ceil(G / 16) CTAs of GC = ceil(G / split) heads each
//   (one more grid axis), each with P = positions for GC heads and its
//   own K/V reads (G = 32: two CTAs of 16 heads, P = 8); K/V are never
//   copied.
// * Head dims: instances at D = 16, 32, 64, 128, 256.  A head dim d that
//   is a multiple of 16 below an instance's D (zamba2_7b's 112 on 128,
//   nemotron4_340b's 192 on 256) runs on it: the tensor maps are d wide,
//   so TMA fills the box columns d..D-1 with zeros (they add exact zeros
//   to Q.K^T and give zero output columns, never stored); the scale is
//   1/sqrt(d), set by the host.
// * The block walks only its key range [max(0, p0 - W + 1), p_hi] of the
//   unpadded K/V in chunks of KC keys (128, or 64 at D = 256).  A box that
//   reaches past S reads zeros; those keys are masked anyway.
// * Warp specialisation, 384 threads: warpgroups 0 and 1 consume (64 rows
//   each, wgmma's M); warpgroup 2 produces, and one thread of it issues
//   every TMA copy: q once, then K and V chunks into a ring of 2 stages
//   with a full and an empty mbarrier per stage.  __launch_bounds__(384, 1)
//   gives every thread 168 registers; the producer drops to 40 with
//   setmaxnreg.dec and the consumers take the freed ones up to 232 with
//   setmaxnreg.inc (40 * 128 + 232 * 256 = 168 * 384).
// * Shared memory holds T as loaded, in panels of PE = min(D, 64)
//   columns with the TMA swizzle of the panel's row (128 B, or 64/32 B at
//   D = 32/16), which is the layout wgmma reads.
// * S = Q.K^T: wgmma m64nKCk16 with Q and K both K-major in shared memory.
//   bf16 x bf16 and f16 x f16 products are exact in f32 (8 + 8 and 11 + 11
//   significant bits), so this is the reference's f32 dot product up to
//   summation order.
// * Online softmax in registers: each thread holds 2 rows of the
//   accumulator; the row max is reduced over the 4 lanes of a quad by
//   shuffles; O is rescaled by exp(m_old - m_new); l stays a per-thread
//   partial sum until the end (same rows, same rescales).  The position
//   mask runs only on chunks that straddle k <= p or k > p - W; masked
//   keys give probability exactly 0.  exp is 2^((x - m) * log2 e) on the
//   MUFU (ex2.approx.ftz, about 2 ulp).
// * P.V on the tensor cores with P as a sum of NT terms of type T, each
//   the rounding of what the earlier left (every difference exact in f32),
//   and each term x v exact in f32, so P.V is the reference's f32 product
//   up to summation order and the bits the terms drop.
//   bf16, NT = 3: three terms of 8 significant bits cover p's 24, so the
//   sum is p for every p the softmax gives above 2^-100 (the residuals of
//   smaller p turn subnormal).  Two terms keep about 16 bits of p
//   (relative error up to 2^-16); three were taken because the bf16 check
//   holds the output to one bf16 ulp (at least 4e-6) of the f32 plain
//   version, and the CPU mirror of this kernel (tests/_swa_tc_mirror.py)
//   puts the 2-term f32 gap at 5.6e-6, above that floor for outputs that
//   cancel.
//   f16, NT = 2: f16 has 11 significant bits but little exponent range
//   (residuals below 2^-14 turn subnormal), so the terms split p * 2^15
//   (at most 32768 < 65504), undone exactly in the final division; two
//   terms give p within 2^-22 relative for every p >= 2^-18, and the f16
//   check (one f16 ulp, at least 4e-6) holds with two on the CPU mirror.
//   The terms are wgmma's A operand from registers, in the S accumulator's
//   own fragment layout (m64nDk16, V MN-major in shared memory as B).  The
//   extra P.V work (NT x) is the design's cost and not in the bound.
// * Store: O / l rounded once to bf16, straight from registers; spare rows
//   and positions past S are not written.
//
// Budget per head dim (shared memory incl. 1 KB alignment slack and
// barriers, either type; registers per consumer thread: O + S + P terms
// of one group, bf16 / f16):
//   D   KC  smem     O    S   terms
//   16  128  21 KB    8   64   24 / 16  (P.V in groups of 32 keys)
//   32  128  41 KB   16   64   24 / 16
//   64  128  81 KB   32   64   24 / 16
//   128 128 161 KB   64   64   24 / 16  (Q 32 KB + 2 x (K 32 KB + V 32 KB))
//   256  64 193 KB  128   32   12 / 8   (P.V in groups of 16 keys)
// One CTA per SM.  ptxas's counts are printed by chip_smoke.py.
// Softcap divides by multiplying with 1/softcap (one rounding more than
// the reference's division, 2^-24 relative, far below the checks), and
// takes tanh from a polynomial where a warp's |s / softcap| <= 0.55
// (within one ulp; tanh_small in swa_common.cuh), from tanhf elsewhere.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ parameters.  Arguments travel in SwaTcArgs
// (swa_common.cuh), mirrored by a ctypes.Structure in kernels/swa.py;
// casper_swa_tc_args_size() lets the loader check the layout.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "swa_common.cuh"

#define TC_CONSUMERS 256    // consumer threads
#define TC_THREADS 384      // + the producer warpgroup
#define TC_STAGES 2         // K/V ring depth
#define TC_ERR_ENTRY 10001  // no cuTensorMapEncodeTiled in the driver
#define TC_ERR_ENCODE 10002 // cuTensorMapEncodeTiled refused a map

// What the 16-bit storage type T changes: P's terms (NT of them, of
// p * P_SCALE), their packing and residuals, the store and the TMA type.
template <typename T>
struct Tc16;

template <>
struct Tc16<__nv_bfloat16> {
  static constexpr int NT = 3;
  static constexpr float P_SCALE = 1.f;
  static constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // {lo, hi} rounded to bf16 (nearest even) and packed, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    uint32_t u;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
    return u;
  }
  static __device__ __forceinline__ float lo_f32(uint32_t u) { return __uint_as_float(u << 16); }
  static __device__ __forceinline__ float hi_f32(uint32_t u) {
    return __uint_as_float(u & 0xffff0000u);
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* dst, float x0, float x1) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
  }
};

template <>
struct Tc16<__half> {
  static constexpr int NT = 2;
  static constexpr float P_SCALE = 32768.f;  // 2^15: p * 2^15 <= 32768 < 65504
  static constexpr CUtensorMapDataType MAP_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  // {lo, hi} rounded to f16 (nearest even) and packed, lo in the low half
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    uint32_t u;
    asm("cvt.rn.f16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(hi), "f"(lo));
    return u;
  }
  static __device__ __forceinline__ float lo_f32(uint32_t u) {
    return __half2float(__ushort_as_half((unsigned short)(u & 0xffffu)));
  }
  static __device__ __forceinline__ float hi_f32(uint32_t u) {
    return __half2float(__ushort_as_half((unsigned short)(u >> 16)));
  }
  static __device__ __forceinline__ void store2(__half* dst, float x0, float x1) {
    *reinterpret_cast<__half2*>(dst) = __floats2half2_rn(x0, x1);
  }
};

template <int D>
struct Tc {
  static constexpr int KC = D == 256 ? 64 : 128;        // keys per chunk
  static constexpr int KH = D == 256 ? 16 : 32;         // keys per P.V group
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;  // panel row, bytes
  static constexpr int PE = SW / 2;                     // panel row, elements
  static constexpr int NP = D / PE;                     // panels
  static constexpr int Q_BYTES = TC_ROWS * D * 2;
  static constexpr int KV_BYTES = KC * D * 2;           // K (or V) per stage
  static constexpr int BAR_OFF = Q_BYTES + TC_STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * TC_STAGES) + 1024;
  // wgmma descriptor layout type of the swizzle: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : SW == 64 ? 2 : 3;
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.  A barrier that
// never completes (a byte count that does not match the copies) traps
// after about 2^28 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type.
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (Tc<D>::LAYOUT << 62);
}

// The accumulator operands of one wgmma, d[i] .. d[i + 4n - 1], and their
// register lists in the instruction text
#define TC_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define TC_D8(i) TC_D4(i), TC_D4(i + 4)
#define TC_D16(i) TC_D8(i), TC_D8(i + 8)
#define TC_D32(i) TC_D16(i), TC_D16(i + 16)
#define TC_D64(i) TC_D32(i), TC_D32(i + 32)
#define TC_D128(i) TC_D64(i), TC_D64(i + 64)
#define TC_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define TC_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define TC_R32                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TC_R64                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define TC_R128                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "  \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "                   \
  "%120, %121, %122, %123, %124, %125, %126, %127}"

// D[64 x N] (+)= A[64 x 16] . B[N x 16]^T, A and B K-major in shared memory;
// NR accumulators per thread, the descriptors and the scale-d predicate
// are operands A, B and P, TY the operand type's PTX name
#define TC_WGMMA_SS(N, NR, A, B, P, TY)                                          \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "   \
               TC_R##NR ", %" A ", %" B ", p, 1, 1, 0, 0;\n}\n"                  \
               : TC_D##NR(0)                                                     \
               : "l"(da), "l"(db), "r"(acc))

// D[64 x N] += A[64 x 16] . B[16 x N], A in registers (operands A0..A0+3),
// B MN-major in shared memory
#define TC_WGMMA_RS(N, NR, A0, A1, A2, A3, B, P, TY)                             \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " "   \
               TC_R##NR ", {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" B            \
               ", p, 1, 1, 1;\n}\n"                                              \
               : TC_D##NR(0)                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int acc);
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);

#define TC_SPECIALIZE(T, TY)                                                                      \
  template <>                                                                                     \
  __device__ __forceinline__ void wgmma_ss<T, 64>(float* d, uint64_t da, uint64_t db, int acc) {  \
    TC_WGMMA_SS(64, 32, "32", "33", "34", TY);                                                    \
  }                                                                                               \
  template <>                                                                                     \
  __device__ __forceinline__ void wgmma_ss<T, 128>(float* d, uint64_t da, uint64_t db, int acc) { \
    TC_WGMMA_SS(128, 64, "64", "65", "66", TY);                                                   \
  }                                                                                               \
  template <>                                                                                     \
  __device__ __forceinline__ void wgmma_rs<T, 16>(float* d, const uint32_t* a, uint64_t db) {     \
    TC_WGMMA_RS(16, 8, "8", "9", "10", "11", "12", "13", TY);                                     \
  }                                                                                               \
  template <>                                                                                     \
  __device__ __forceinline__ void wgmma_rs<T, 32>(float* d, const uint32_t* a, uint64_t db) {     \
    TC_WGMMA_RS(32, 16, "16", "17", "18", "19", "20", "21", TY);                                  \
  }                                                                                               \
  template <>                                                                                     \
  __device__ __forceinline__ void wgmma_rs<T, 64>(float* d, const uint32_t* a, uint64_t db) {     \
    TC_WGMMA_RS(64, 32, "32", "33", "34", "35", "36", "37", TY);                                  \
  }                                                                                               \
  template <>                                                                                     \
  __device__ __forceinline__ void wgmma_rs<T, 128>(float* d, const uint32_t* a, uint64_t db) {    \
    TC_WGMMA_RS(128, 64, "64", "65", "66", "67", "68", "69", TY);                                 \
  }                                                                                               \
  template <>                                                                                     \
  __device__ __forceinline__ void wgmma_rs<T, 256>(float* d, const uint32_t* a, uint64_t db) {    \
    TC_WGMMA_RS(256, 128, "128", "129", "130", "131", "132", "133", TY);                          \
  }

TC_SPECIALIZE(__nv_bfloat16, "bf16")
TC_SPECIALIZE(__half, "f16")

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(TC_THREADS, 1)
swa_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out,
              const __grid_constant__ SwaTcArgs a) {
  using C = Tc<D>;
  using X = Tc16<T>;
  constexpr int KC = C::KC, SW = C::SW, PE = C::PE;
  extern __shared__ uint8_t smem_raw[];
  // 1 KB-aligned base: a 128-byte swizzle atom spans 8 rows of 128 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                 // [TC_STAGES]
  const uint32_t bar_empty = bar_full + 8 * TC_STAGES;  // [TC_STAGES]

  const int G = a.hq / a.hkv;
  const int P = a.positions;
  const int dd = a.head_dim;  // true head dim: row pitch of the output, stored columns
  const int n_pb = (a.seq + P - 1) / P;
  const int n_bh = a.batch * a.hkv;
  const int n_split = (G + a.heads - 1) / a.heads;
  // blockIdx.x: (batch, KV head) fastest, then the group's split, then
  // position blocks from the last down
  const int bh = (int)(blockIdx.x % (unsigned)n_bh);
  const int rest = (int)(blockIdx.x / (unsigned)n_bh);
  const int g_base = (rest % n_split) * a.heads;     // first query head of the CTA
  const int GL = min(a.heads, G - g_base);           // query heads in the CTA
  const int pb = n_pb - 1 - rest / n_split;
  const int b = bh / a.hkv, h = bh % a.hkv;
  const int p0 = pb * P;
  const int p_hi = min(a.seq - 1, p0 + P - 1);
  const int k_lo = max(0, p0 - a.window + 1);
  const int n_chunks = (p_hi - k_lo + KC) / KC;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, TC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= TC_CONSUMERS) {
    // ---- producer warpgroup: every TMA copy, from one thread --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == TC_CONSUMERS) {
      mbar_expect_tx(bar_q, GL * P * D * 2);
      for (int g = 0; g < GL; ++g)
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load_3d(q_s + pn * TC_ROWS * SW + g * P * SW, &tm_q, bar_q, pn * PE, p0,
                      (b * a.hkv + h) * G + g_base + g);
      for (int j = 0; j < n_chunks; ++j) {
        const int st = j % TC_STAGES;
        mbar_wait(bar_empty + 8 * st, ((j / TC_STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st;
        const uint32_t k_s = base + C::Q_BYTES + st * 2 * C::KV_BYTES;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
        for (int pn = 0; pn < C::NP; ++pn) {
          tma_load_3d(k_s + pn * KC * SW, &tm_k, full, pn * PE, k_lo + j * KC, bh);
          tma_load_3d(k_s + C::KV_BYTES + pn * KC * SW, &tm_v, full, pn * PE, k_lo + j * KC,
                      bh);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int quad = lane & 3;

    // rows wg*64 + warp*16 + lane/4 (+ 8): head g = r / P, position p0 + r % P
    int pos[2];
    bool live[2];
    long long out_off[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
      const int g = r / P;
      pos[i] = p0 + (r - g * P);
      live[i] = g < GL && pos[i] < a.seq;
      out_off[i] =
          live[i] ? (((long long)(b * a.hkv + h) * G + g_base + g) * a.seq + pos[i]) * dd : 0;
    }

    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    // descriptors: Q rows of this warpgroup; K and V of stage 0 (the
    // stage offset is added per chunk)
    const uint32_t q_wg = q_s + wg * 64 * SW;
    const uint32_t kv0 = base + C::Q_BYTES;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_chunks; ++j) {
      const int st = j % TC_STAGES;
      const int c0 = k_lo + j * KC;
      const uint32_t k_s = kv0 + st * 2 * C::KV_BYTES;
      const uint32_t v_s = k_s + C::KV_BYTES;
      mbar_wait(bar_full + 8 * st, (j / TC_STAGES) & 1);

      // S = Q . K^T over D in steps of 16
      float s[KC / 2];
#pragma unroll
      for (int e = 0; e < KC / 2; ++e) s[e] = 0.f;
      fence_regs<KC / 2>(s);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const int pn = kd * 16 / PE;                  // panel
        const uint32_t off = ((kd * 16) % PE) * 2;    // bytes into its row
        wgmma_ss<T, KC>(s, make_desc<D>(q_wg + pn * TC_ROWS * SW + off, 16, 8 * SW),
                        make_desc<D>(k_s + pn * KC * SW + off, 16, 8 * SW), kd > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<KC / 2>(s);

      // element e: row i = (e >> 1) & 1, key c0 + 8*(e >> 2) + 2*quad + (e & 1)
      online_softmax<KC, D / 2>(s, o, m, l, pos, c0, p0, p_hi, quad, a);

      // O += P . V, P (times P_SCALE) split into NT terms of T, KH keys at a time
#pragma unroll
      for (int grp = 0; grp < KC / C::KH; ++grp) {
        constexpr int KS = C::KH / 16;  // k-steps per group
        uint32_t pa[X::NT][KS][4];
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int kk = grp * KS + ks;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float x0 = s[8 * kk + 2 * q], x1 = s[8 * kk + 2 * q + 1];
            if constexpr (X::P_SCALE != 1.f) {
              x0 *= X::P_SCALE;  // exact: a power of two
              x1 *= X::P_SCALE;
            }
#pragma unroll
            for (int t = 0; t < X::NT; ++t) {
              const uint32_t u = X::pack(x0, x1);
              pa[t][ks][q] = u;
              x0 -= X::lo_f32(u);  // exact: the rounding residual
              x1 -= X::hi_f32(u);
            }
          }
        }
        fence_regs<X::NT * KS * 4>(&pa[0][0][0]);
        fence_regs<D / 2>(o);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          // 16 keys of V: rows kk*16.. of every panel; panels LBO apart
          const uint64_t dv =
              make_desc<D>(v_s + (grp * KS + ks) * 16 * SW, KC * SW, 8 * SW);
#pragma unroll
          for (int t = 0; t < X::NT; ++t) wgmma_rs<T, D>(o, pa[t][ks], dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs<D / 2>(o);
        fence_regs<X::NT * KS * 4>(&pa[0][0][0]);
      }
      mbar_arrive(bar_empty + 8 * st);
    }

    // O / (l * P_SCALE), rounded once; element e of n-block jn: row
    // (e >> 1) & 1, column 8*jn + 2*quad + (e & 1)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      if constexpr (X::P_SCALE != 1.f) l[i] *= X::P_SCALE;  // exact
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!live[i]) continue;
      T* dst = out + out_off[i] + 2 * quad;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        if (8 * jn + 2 * quad < dd)
          X::store2(dst + 8 * jn, o[4 * jn + 2 * i] / l[i], o[4 * jn + 2 * i + 1] / l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// (B*H, S, d) rows of a 16-bit type, boxes of PE columns x `rows`
// positions x 1 head; box columns past d read as zero
static bool encode(EncodeTiledFn fn, CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                   int heads, int seq, int d, int pe, int rows, int swizzle_bytes) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)pe, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle sw = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, typename T>
static int launch_d(const void* q, const void* k, const void* v, void* out, const SwaTcArgs* a,
                    cudaStream_t stream) {
  using C = Tc<D>;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return TC_ERR_ENTRY;
  CUtensorMap tm_q, tm_k, tm_v;
  const int d = a->head_dim;
  const CUtensorMapDataType ty = Tc16<T>::MAP_TYPE;
  if (!encode(fn, &tm_q, ty, q, a->batch * a->hq, a->seq, d, C::PE, a->positions, C::SW) ||
      !encode(fn, &tm_k, ty, k, a->batch * a->hkv, a->seq, d, C::PE, C::KC, C::SW) ||
      !encode(fn, &tm_v, ty, v, a->batch * a->hkv, a->seq, d, C::PE, C::KC, C::SW))
    return TC_ERR_ENCODE;
  cudaError_t err = cudaFuncSetAttribute(swa_tc_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long split = (a->hq / a->hkv + a->heads - 1) / a->heads;
  const long long blocks = (long long)a->batch * a->hkv * split *
                           ((a->seq + a->positions - 1) / a->positions);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  swa_tc_kernel<D, T><<<(unsigned int)blocks, TC_THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), *a);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(int device, const void* q, const void* k, const void* v, void* out,
                  const SwaTcArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!swa_args_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (swa_instance_dim(a->head_dim)) {
    case 16: return launch_d<16, T>(q, k, v, out, a, st);
    case 32: return launch_d<32, T>(q, k, v, out, a, st);
    case 64: return launch_d<64, T>(q, k, v, out, a, st);
    case 128: return launch_d<128, T>(q, k, v, out, a, st);
    case 256: return launch_d<256, T>(q, k, v, out, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int casper_swa_tc_args_size(void) { return (int)sizeof(SwaTcArgs); }

// dynamic shared memory per CTA at head dim d (0 for a head dim not built)
int casper_swa_tc_smem_bytes(int d) {
  switch (d) {
    case 16: return Tc<16>::SMEM;
    case 32: return Tc<32>::SMEM;
    case 64: return Tc<64>::SMEM;
    case 128: return Tc<128>::SMEM;
    case 256: return Tc<256>::SMEM;
    default: return 0;
  }
}

int casper_swa_tc_bf16(int device, const void* q, const void* k, const void* v, void* out,
                       const void* args, void* stream) {
  return launch<__nv_bfloat16>(device, q, k, v, out, static_cast<const SwaTcArgs*>(args), stream);
}

int casper_swa_tc_f16(int device, const void* q, const void* k, const void* v, void* out,
                      const void* args, void* stream) {
  return launch<__half>(device, q, k, v, out, static_cast<const SwaTcArgs*>(args), stream);
}

const char* casper_swa_tc_error_string(int err) {
  if (err == TC_ERR_ENTRY) return "cuTensorMapEncodeTiled not found in the driver";
  if (err == TC_ERR_ENCODE) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
