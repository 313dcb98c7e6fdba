// Sliding-window attention kernel K5, float32 path, on Hopper's tensor
// cores in three TF32 passes (sm_90a: mma.sync, cp.async).
//
// Replaces (TPU/Pallas kernel of the reference package):
//   K5  src/repro/kernels/swa.py  _kernel  (sliding_window_attention, ops.swa)
// for float32 q/k/v.  bfloat16 and float16 run in swa_wgmma.cu; what the
// two share (arguments, block geometry, online softmax) is in
// swa_common.cuh.
//
// What it computes, as the reference does: windowed-causal GQA attention
// in f32.  q is (B, Hq, S, D), k/v are (B, Hkv, S, D) with G = Hq / Hkv
// query heads per KV head; query position p attends to keys k with
// p - W < k <= p.  Scores s = (q . k) * scale (scale = 1/sqrt(d)),
// optionally softcap * tanh(s / softcap), softmax over the valid keys and
// P.V, the output stored in f32.
//
// f32 accuracy from TF32 products (the 3xTF32 scheme of CUTLASS's
// OpMultiplyAddFastF32): each f32 operand x is split into a big and a
// small tf32 half, and a product is big.big + big.small + small.big, every
// term exact in the f32 accumulator (11 x 11 significant bits).  mma.sync
// reads an f32 bit pattern given as a .tf32 operand by dropping its low 13
// bits (tools/swa_probe.py, on an H100: truncation, for A and B alike), so
// big is x itself, read as trunc(x), and small is x - trunc(x), exact in
// f32, read as trunc(x - trunc(x)): one mask and one subtraction per
// element, no cvt.  The two halves as read give x within 2^-21 |x|, and
// the dropped small.small is below 2^-20 of the product, so Q.K^T and P.V
// are the reference's f32 products up to summation order and those terms
// (tests/_swa_tc_mirror.py walks the same arithmetic on the CPU).  Both
// products use the split: Q.K^T (Q and K split as their fragments load
// from shared memory) and P.V (P split in registers, V as it loads).
// A chunk's P.V is summed from zero in an accumulator of its own and added
// to O in one rounded f32 add: the tensor cores truncate each product to
// the accumulator's alignment, so O itself never passes through them.
//
// Bound on this card: operations.  At gemma2-27b's local layer (B=1,
// Hq=32, Hkv=16, D=128, S=8192, W=4096) the useful work is
// 4*Hq*D*sum_p min(p+1, W) = 4.124e11 FLOP; three TF32 passes of it take
// 2.50 ms at the dense TF32 rate (494.7 TFLOP/s), the least time in which
// this card forms f32-accurate products (six bf16 passes at 989 take the
// same).  The 384 MiB of f32 q/k/v/o take 0.12 ms at 3.35 TB/s.
//
// Design:
// * Block geometry as in swa_wgmma.cu: one CTA per (batch, KV head, share
//   of the group, block of P query positions), TC_ROWS = 128 rows head-major
//   (P = floor(128 / GC) rounded down to a multiple of 8), the blocks of one
//   (batch, head) from the last down; the block walks only its key range
//   [max(0, p0 - W + 1), p_hi] of the unpadded K/V, KC keys per chunk (64,
//   or 32 at D = 256).  Keys past S and columns past d are zero-filled.
// * mma.sync.m16n8k8 (.tf32) with register fragments, not wgmma: wgmma
//   reads B only K-major for tf32 and takes A and B from shared memory or A
//   from registers, so the split halves of Q, K and V would all have to sit
//   in shared memory: at D = 128 a 128-row Q is 128 KB in two halves, and a
//   64-key K and V chunk another 128 KB, past the 227 KB a CTA can use even
//   without a ring.  mma.sync takes fragments from registers, so Q, K and V
//   stay raw f32 in shared memory and are split as their fragments load.
// * 256 threads, 8 warps of 16 rows.  Q is loaded once; K/V chunks come
//   by 16-byte cp.async into a ring of STAGES (2, or 1 at D = 256), the next
//   chunk's copy issued before this one's products.  Rows in shared memory
//   are D + 4 floats apart (pitch = 4 mod 32 banks), so every fragment load
//   below is free of bank conflicts.
// * S = Q.K^T per warp: 16 rows x KC keys, KC / 8 m16n8 accumulators; per
//   8-column step of D one A fragment of Q (split once) against each
//   8-key B fragment of K.
// * Online softmax in registers (swa_common.cuh, as in swa_wgmma.cu): the
//   m16n8 accumulators are the layout that function takes.
// * O += P.V: P stays in the S registers.  m16n8k8's A fragment wants
//   columns t and t + 4 of an 8-key group where the S accumulator holds
//   keys 2t and 2t + 1, so the product runs over the group's keys in the
//   order 0, 2, 4, 6, 1, 3, 5, 7: the thread's two keys are its A columns
//   t and t + 4, and the B fragment reads V's rows 2t and 2t + 1 (a sum
//   over keys in another order is the same sum).
// * Store: O / l straight from registers; spare rows and positions past S
//   are not written.
//
// Budget per head dim (shared memory: Q + STAGES x (K + V) chunks, floats
// at pitch D + 4; registers per thread: O + S):
//   D   KC  stages  smem     O    S
//   16  64  2        30 KB   8   32
//   32  64  2        54 KB  16   32
//   64  64  2       102 KB  32   32
//   128 64  2       198 KB  64   32
//   256 32  1       195 KB 128   16
// One CTA per SM; ptxas's counts are printed by chip_smoke.py.
//
// Arguments travel in SwaTcArgs (swa_common.cuh), mirrored by a
// ctypes.Structure in kernels/swa.py; casper_swa_tf32_args_size() lets the
// loader check the layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "swa_common.cuh"

#define TF_THREADS 256  // 8 warps of 16 rows

template <int D>
struct Tf {
  static constexpr int KC = D == 256 ? 32 : 64;      // keys per chunk
  static constexpr int STAGES = D == 256 ? 1 : 2;    // K/V ring depth
  static constexpr int PITCH = D + 4;                 // floats per row in shared memory
  static constexpr int Q_FLOATS = TC_ROWS * PITCH;
  static constexpr int KV_FLOATS = KC * PITCH;        // K (or V) per stage
  static constexpr int SMEM = (Q_FLOATS + STAGES * 2 * KV_FLOATS) * 4;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as two tf32 operands whose sum, as mma reads them, is x within
// 2^-21 |x|: big = x (read as trunc(x)), small = x - trunc(x) (exact)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x);
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d[16 x 8] += a[16 x 8] . b[8 x 8], tf32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b in three passes: the two small cross terms, then big . big
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_big,
                                           const uint32_t* a_small, const uint32_t* b_big,
                                           const uint32_t* b_small) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

template <int D>
__global__ void __launch_bounds__(TF_THREADS, 1)
swa_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                const __grid_constant__ SwaTcArgs a) {
  using C = Tf<D>;
  constexpr int KC = C::KC, PITCH = C::PITCH, D4 = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                    // [TC_ROWS][PITCH]
  float* const kv_s = smem + C::Q_FLOATS;    // per stage: K [KC][PITCH], V [KC][PITCH]

  const int G = a.hq / a.hkv;
  const int P = a.positions;
  const int dd = a.head_dim;  // true head dim: row pitch in device memory, stored columns
  const int n_pb = (a.seq + P - 1) / P;
  const int n_bh = a.batch * a.hkv;
  const int n_split = (G + a.heads - 1) / a.heads;
  // blockIdx.x: (batch, KV head) fastest, then the group's split, then
  // position blocks from the last down
  const int bh = (int)(blockIdx.x % (unsigned)n_bh);
  const int rest = (int)(blockIdx.x / (unsigned)n_bh);
  const int g_base = (rest % n_split) * a.heads;  // first query head of the CTA
  const int GL = min(a.heads, G - g_base);        // query heads in the CTA
  const int pb = n_pb - 1 - rest / n_split;
  const int p0 = pb * P;
  const int p_hi = min(a.seq - 1, p0 + P - 1);
  const int k_lo = max(0, p0 - a.window + 1);
  const int n_chunks = (p_hi - k_lo + KC) / KC;
  const long long kv_row0 = (long long)bh * a.seq;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, quad = lane & 3;

  // Q rows r = gi*P + t: head g_base + gi, position p0 + t; zeros past the
  // CTA's heads, past S and past column d
  for (int idx = tid; idx < TC_ROWS * D4; idx += TF_THREADS) {
    const int r = idx / D4, c4 = idx % D4;
    const int gi = r / P, t = r - gi * P;
    const bool ok = gi < GL && p0 + t < a.seq && c4 * 4 < dd;
    const float* src =
        ok ? q + (((long long)bh * G + g_base + gi) * a.seq + p0 + t) * dd + c4 * 4 : q;
    cp_async16(smem_u32(qs + r * PITCH + c4 * 4), src, ok);
  }
  // chunk j's keys k_lo + j*KC.. into stage st; zeros past S and column d
  auto load_kv = [&](int j, int st) {
    float* const ks = kv_s + st * 2 * C::KV_FLOATS;
    float* const vs = ks + C::KV_FLOATS;
    const int c0 = k_lo + j * KC;
    for (int idx = tid; idx < KC * D4; idx += TF_THREADS) {
      const int row = idx / D4, c4 = idx % D4;
      const bool ok = c0 + row < a.seq && c4 * 4 < dd;
      const long long off = ok ? (kv_row0 + c0 + row) * dd + c4 * 4 : 0;
      cp_async16(smem_u32(ks + row * PITCH + c4 * 4), k + off, ok);
      cp_async16(smem_u32(vs + row * PITCH + c4 * 4), v + off, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  // this thread's rows 16*warp + lane/4 (+ 8): head g = r / P, position
  // p0 + r % P
  int pos[2];
  bool live[2];
  long long out_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g8 + 8 * i;
    const int g = r / P;
    pos[i] = p0 + (r - g * P);
    live[i] = g < GL && pos[i] < a.seq;
    out_off[i] = live[i] ? (((long long)bh * G + g_base + g) * a.seq + pos[i]) * dd : 0;
  }

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* const qw = qs + warp * 16 * PITCH;

  for (int j = 0; j < n_chunks; ++j) {
    const int st = C::STAGES > 1 ? j % C::STAGES : 0;
    const int c0 = k_lo + j * KC;
    if (C::STAGES > 1) {
      if (j + 1 < n_chunks) load_kv(j + 1, (j + 1) % C::STAGES);
      cp_async_commit();
      cp_async_wait<1>();  // chunk j (and Q) landed; j + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* const ks = kv_s + st * 2 * C::KV_FLOATS;
    const float* const vs = ks + C::KV_FLOATS;

    // S = Q.K^T, 8 columns of D at a time
    float s[KC / 2];
#pragma unroll
    for (int e = 0; e < KC / 2; ++e) s[e] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < D; kd += 8) {
      const float* qa = qw + g8 * PITCH + kd + quad;
      uint32_t ab[4], as[4];
      split_tf32(qa[0], ab[0], as[0]);
      split_tf32(qa[8 * PITCH], ab[1], as[1]);
      split_tf32(qa[4], ab[2], as[2]);
      split_tf32(qa[8 * PITCH + 4], ab[3], as[3]);
#pragma unroll
      for (int nb = 0; nb < KC / 8; ++nb) {
        const float* kb_ = ks + (8 * nb + g8) * PITCH + kd + quad;
        uint32_t bb[2], bs[2];
        split_tf32(kb_[0], bb[0], bs[0]);
        split_tf32(kb_[4], bb[1], bs[1]);
        mma_3xtf32(s + 4 * nb, ab, as, bb, bs);
      }
    }

    online_softmax<KC, D / 2>(s, o, m, l, pos, c0, p0, p_hi, quad, a);

    // P split once per chunk; per 8-key group kb the A columns quad and
    // quad + 4 are keys 2*quad and 2*quad + 1 (the order 0, 2, 4, 6, 1,
    // 3, 5, 7)
    uint32_t pbig[KC / 2], psmall[KC / 2];
#pragma unroll
    for (int kb = 0; kb < KC / 8; ++kb) {
      split_tf32(s[4 * kb], pbig[4 * kb], psmall[4 * kb]);          // row g8,     key 2*quad
      split_tf32(s[4 * kb + 2], pbig[4 * kb + 1], psmall[4 * kb + 1]);  // row g8 + 8, key 2*quad
      split_tf32(s[4 * kb + 1], pbig[4 * kb + 2], psmall[4 * kb + 2]);  // row g8,     key 2*quad + 1
      split_tf32(s[4 * kb + 3], pbig[4 * kb + 3], psmall[4 * kb + 3]);  // row g8 + 8, key 2*quad + 1
    }
    // O += P.V: each 8 columns of O sum the chunk's keys in an accumulator
    // of their own, from zero, which one rounded add then puts into O.
    // The tensor cores align each product to the accumulator and drop the
    // bits below it: summed into O itself, every step of the window would
    // lose up to an ulp of O, always in the same direction
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kb = 0; kb < KC / 8; ++kb) {
        const float* v0 = vs + (8 * kb + 2 * quad) * PITCH + g8 + 8 * nb;
        uint32_t vb[2], vsm[2];
        split_tf32(v0[0], vb[0], vsm[0]);
        split_tf32(v0[PITCH], vb[1], vsm[1]);
        mma_3xtf32(c, pbig + 4 * kb, psmall + 4 * kb, vb, vsm);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * nb + e] += c[e];
    }
    __syncthreads();  // every warp is done with stage st before it refills
    if (C::STAGES == 1 && j + 1 < n_chunks) {
      load_kv(j + 1, 0);
      cp_async_commit();
    }
  }

  // O / l; element e of n-block jn: row (e >> 1) & 1, column 8*jn + 2*quad + (e & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    float* dst = out + out_off[i] + 2 * quad;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      if (8 * jn + 2 * quad < dd)
        *reinterpret_cast<float2*>(dst + 8 * jn) =
            make_float2(o[4 * jn + 2 * i] / l[i], o[4 * jn + 2 * i + 1] / l[i]);
  }
}

template <int D>
static int launch_d(const float* q, const float* k, const float* v, float* out,
                    const SwaTcArgs* a, cudaStream_t stream) {
  using C = Tf<D>;
  cudaError_t err = cudaFuncSetAttribute(swa_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long split = (a->hq / a->hkv + a->heads - 1) / a->heads;
  const long long blocks = (long long)a->batch * a->hkv * split *
                           ((a->seq + a->positions - 1) / a->positions);
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  swa_tf32_kernel<D><<<(unsigned int)blocks, TF_THREADS, C::SMEM, stream>>>(q, k, v, out, *a);
  return (int)cudaGetLastError();
}

extern "C" {

int casper_swa_tf32_args_size(void) { return (int)sizeof(SwaTcArgs); }

// dynamic shared memory per CTA at head dim d (0 for a head dim not built)
int casper_swa_tf32_smem_bytes(int d) {
  switch (d) {
    case 16: return Tf<16>::SMEM;
    case 32: return Tf<32>::SMEM;
    case 64: return Tf<64>::SMEM;
    case 128: return Tf<128>::SMEM;
    case 256: return Tf<256>::SMEM;
    default: return 0;
  }
}

int casper_swa_tf32(int device, const void* q, const void* k, const void* v, void* out,
                    const void* args, void* stream) {
  const SwaTcArgs* a = static_cast<const SwaTcArgs*>(args);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!swa_args_ok(a)) return (int)cudaErrorInvalidValue;
  const float* qp = static_cast<const float*>(q);
  const float* kp = static_cast<const float*>(k);
  const float* vp = static_cast<const float*>(v);
  float* op = static_cast<float*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (swa_instance_dim(a->head_dim)) {
    case 16: return launch_d<16>(qp, kp, vp, op, a, st);
    case 32: return launch_d<32>(qp, kp, vp, op, a, st);
    case 64: return launch_d<64>(qp, kp, vp, op, a, st);
    case 128: return launch_d<128>(qp, kp, vp, op, a, st);
    case 256: return launch_d<256>(qp, kp, vp, op, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* casper_swa_tf32_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
