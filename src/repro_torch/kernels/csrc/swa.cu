// Sliding-window attention kernel K5, float32 and float16 paths, on the
// CUDA cores (sm_90a).  bfloat16 runs on the tensor cores in swa_wgmma.cu.
//
// Replaces (TPU/Pallas kernel of the reference package):
//   K5  src/repro/kernels/swa.py  _kernel  (sliding_window_attention, ops.swa)
// for float32 and float16 q/k/v.  float16 is the f32 kernel on another
// storage type: q/k/v are widened to f32 on load and the output rounded
// once to f16 at the store, the reference's own arithmetic (it widens
// q/k/v to f32).
//
// What it computes: windowed-causal GQA attention.  q is (B, Hq, S, D),
// k/v are (B, Hkv, S, D) with G = Hq / Hkv query heads per KV head; query
// position p attends to keys k with p - W < k <= p.  Scores are
// s = (q . k) * scale in f32 (scale = 1/sqrt(D)), optionally
// softcap * tanh(s / softcap), softmaxed over the valid keys, and the
// output sum_k softmax(s)_k * v_k is accumulated in f32.
//
// The reference kernel materialises, per query tile of tq positions, the
// scores of its G*tq rows against the whole tq + W - 1 key window of a
// front-padded K/V and takes a full softmax.  At gemma2-27b's local-layer
// width (G = 2, tq = 128, W = 4096) that block alone is 4.3 MB, far over
// the 227 KB of shared memory an H100 CTA can use.  This kernel computes
// the same function by streaming instead (online softmax):
//
// * The rows of one query tile, (position t, head g) ordered as
//   r = t*G + g, so the G heads of a position sit side by side, are cut
//   into blocks of RB = 64 rows; one CTA per (batch, KV head, tile, row
//   block).  The block's rows cover positions [p_lo, p_hi] and need the
//   keys [max(0, p_lo - W + 1), p_hi]; they are read straight from the
//   unpadded K/V (no front pad), KC = 64 keys per chunk, staged in shared
//   memory as f32 next to the block's query rows.
// * Thread (tr, tc) of 16 x 16 owns rows tr*4 .. tr*4+3.  For each chunk
//   it computes the 4 x 4 scores of its rows against keys j*16 + tc
//   (fmaf over d in order), masks them by position, and the 16 threads
//   of a row (one half-warp) reduce the chunk's row max and row sum by
//   xor shuffles (every lane ends with the same bits).  A running max m,
//   sum l and the f32 output accumulator of the thread's 4 rows x D/16
//   columns are rescaled by exp(m_old - m_new); the chunk's
//   probabilities go through shared memory (transposed) to the P.V
//   product.  The output is acc / l, divided once at the end.
// * Masked keys are skipped (probability exactly 0), as the reference's
//   -1e30 fill gives exp(-1e30 - m) = 0; key k = p is always valid, so
//   l > 0 for every real row.
// * Built with -fmad=false; the products that should fuse are written
//   as fmaf.
// * Head dims: instances at D = 16, 32, 64, 128, 256.  A head dim d that
//   is a multiple of 16 below an instance's D (zamba2_7b's 112 on 128,
//   nemotron4_340b's 192 on 256) runs on it: columns d..D-1 load as zero
//   (they add exact zeros to every dot product), rows are d apart in
//   device memory, and only the d columns are stored; the scale is
//   1/sqrt(d).
//
// Bound on this card: operations.  At gemma2-27b's local layer
// (B=1, Hq=32, Hkv=16, D=128, S=8192, W=4096) the useful work is
// 4*Hq*D*sum_p keys(p) = 4.12e11 FLOP against 384 MiB of f32 q, k, v, o.
// This kernel runs on the CUDA cores (f32 FMA, 67 TFLOP/s at most, 6.15 ms
// at that shape): the tensor cores have no full-f32 product.  Each CTA stages
// 64 x (D+4) query floats and two 64 x (D+4) key/value chunks plus the
// 64 x 68 probability block: 118,784 bytes at D = 128, one CTA per SM.
//
// Arguments travel in a __grid_constant__ struct mirrored by a
// ctypes.Structure (SwaArgs in kernels/swa.py); casper_swa_args_size()
// lets the loader check the layout.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct SwaArgs {
  int batch;        // B
  int hq;           // query heads
  int hkv;          // key/value heads, hq % hkv == 0
  int seq;          // S
  int head_dim;     // d, a multiple of 16 up to the instance's D
  int window;       // W, clamped to S by the caller
  int tq;           // query tile (positions), clamped to S by the caller
  int has_softcap;  // 0 or 1
  float scale;      // 1/sqrt(D) in f32
  float softcap;
};

#define SWA_THREADS 256
#define SWA_RB 64  // query rows per CTA
#define SWA_KC 64  // keys per chunk

// four consecutive elements widened to f32, and one rounded store
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__half* p, float x) { *p = __float2half_rn(x); }

template <int D>
constexpr size_t swa_smem_bytes() {
  return (size_t)(SWA_RB * (D + 4) + 2 * SWA_KC * (D + 4) + SWA_KC * (SWA_RB + 4)) *
         sizeof(float);
}

template <int D, typename S>
__global__ void __launch_bounds__(SWA_THREADS)
swa_kernel(const S* __restrict__ q, const S* __restrict__ k,
           const S* __restrict__ v, S* __restrict__ out,
           const __grid_constant__ SwaArgs a) {
  constexpr int DP = D + 4;        // padded row of q/k/v in shared memory
  constexpr int RBP = SWA_RB + 4;  // padded row of the transposed P block
  constexpr int D4 = D / 4;
  constexpr int TN = D / 16;       // output columns per thread
  constexpr int VEC = TN < 4 ? TN : 4;
  const int dd = a.head_dim;       // the true head dim: row pitch, stored columns
  const int d4 = dd / 4;
  extern __shared__ __align__(16) float smem[];
  float* const qs = smem;                 // [RB][DP]
  float* const ks = qs + SWA_RB * DP;     // [KC][DP]
  float* const vs = ks + SWA_KC * DP;     // [KC][DP]
  float* const ps = vs + SWA_KC * DP;     // [KC][RBP], P transposed

  const int G = a.hq / a.hkv;
  const int rows = G * a.tq;
  const int nrb = (rows + SWA_RB - 1) / SWA_RB;
  const int n_tiles = (a.seq + a.tq - 1) / a.tq;
  const int bh_count = a.batch * a.hkv;
  // blockIdx.x: (batch, KV head) fastest, then row block, then tiles from
  // the last one down, so the blocks with the longest key ranges start first
  const long long lin = blockIdx.x;
  const int bh = (int)(lin % bh_count);
  const long long rest = lin / bh_count;
  const int rb = (int)(rest % nrb);
  const int tile = n_tiles - 1 - (int)(rest / nrb);
  const int r0 = rb * SWA_RB;
  const int r1 = min(rows, r0 + SWA_RB);
  const int p_lo = tile * a.tq + r0 / G;
  if (p_lo >= a.seq) return;
  const int p_hi = min(a.seq - 1, tile * a.tq + (r1 - 1) / G);
  const int k_lo = max(0, p_lo - a.window + 1);

  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // row group: rows tr*4 .. tr*4+3
  const int tc = tid & 15;  // key / column group

  // q row r of this tile: position tile*tq + r/G of head bh*G + r%G
  for (int idx = tid; idx < SWA_RB * D4; idx += SWA_THREADS) {
    const int lr = idx / D4, c4 = idx % D4;
    const int r = r0 + lr;
    const int p = tile * a.tq + r / G;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < r1 && p < a.seq && c4 < d4)
      x = load4(q + (((long long)bh * G + r % G) * a.seq + p) * dd + c4 * 4);
    *reinterpret_cast<float4*>(qs + lr * DP + c4 * 4) = x;
  }

  int pos[4];
  bool live[4];
  float m[4], l[4], acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + tr * 4 + i;
    pos[i] = tile * a.tq + r / G;
    live[i] = r < r1 && pos[i] < a.seq;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[i][n] = 0.f;
  }

  const long long kv_base = (long long)bh * a.seq;
  for (int c0 = k_lo; c0 <= p_hi; c0 += SWA_KC) {
    // stage the chunk's keys and values; keys past p_hi are zero
    for (int idx = tid; idx < SWA_KC * D4; idx += SWA_THREADS) {
      const int j = idx / D4, c4 = idx % D4;
      const int key = c0 + j;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (key <= p_hi && c4 < d4) {
        const long long off = (kv_base + key) * dd + c4 * 4;
        kx = load4(k + off);
        vx = load4(v + off);
      }
      *reinterpret_cast<float4*>(ks + j * DP + c4 * 4) = kx;
      *reinterpret_cast<float4*>(vs + j * DP + c4 * 4) = vx;
    }
    __syncthreads();

    // scores of rows tr*4+i against keys j*16+tc
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (tr * 4 + i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (j * 16 + tc) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = fmaf(qv[i].x, kv[j].x, s[i][j]);
          t = fmaf(qv[i].y, kv[j].y, t);
          t = fmaf(qv[i].z, kv[j].z, t);
          s[i][j] = fmaf(qv[i].w, kv[j].w, t);
        }
    }

    // online softmax over the chunk, one half-warp per row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = c0 + j * 16 + tc;
        float x = s[i][j] * a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x / a.softcap);
        const bool ok = live[i] && key <= pos[i] && key > pos[i] - a.window;
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = fmaf(l[i], alpha, sum);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][n] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (j * 16 + tc) * RBP + tr * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P . V; column n = u*16*VEC + tc*VEC + e of thread (tr, tc)
    const int n_keys = min(SWA_KC, p_hi - c0 + 1);
#pragma unroll 4
    for (int c = 0; c < n_keys; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + c * RBP + tr * 4);
      const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[TN];
#pragma unroll
      for (int u = 0; u < TN / VEC; ++u) {
        const float* src = vs + c * DP + u * 16 * VEC + tc * VEC;
        if constexpr (VEC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[u * 4] = x.x; vv[u * 4 + 1] = x.y; vv[u * 4 + 2] = x.z; vv[u * 4 + 3] = x.w;
        } else if constexpr (VEC == 2) {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[u * 2] = x.x; vv[u * 2 + 1] = x.y;
        } else {
          vv[u] = *src;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(pr[i], vv[n], acc[i][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = r0 + tr * 4 + i;
    S* const dst = out + (((long long)bh * G + r % G) * a.seq + pos[i]) * dd;
#pragma unroll
    for (int u = 0; u < TN / VEC; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = u * 16 * VEC + tc * VEC + e;
        if (col < dd) store1(dst + col, acc[i][u * VEC + e] / l[i]);
      }
  }
}

template <int D, typename S>
static cudaError_t launch_d(const S* q, const S* k, const S* v, S* out,
                            const SwaArgs* a, cudaStream_t stream) {
  const size_t smem = swa_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(swa_kernel<D, S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)(a->hq / a->hkv) * a->tq;
  const long long blocks = (long long)a->batch * a->hkv *
                           ((rows + SWA_RB - 1) / SWA_RB) *
                           ((a->seq + a->tq - 1) / a->tq);
  if (rows >= (1LL << 31) || blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  swa_kernel<D, S><<<(unsigned int)blocks, SWA_THREADS, smem, stream>>>(q, k, v, out, *a);
  return cudaGetLastError();
}

// the built head dim serving d (the smallest instance at least d), or 0
static int instance_dim(int d) {
  if (d % 16 || d < 16 || d > 256) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

template <typename S>
static int launch(int device, const void* q, const void* k, const void* v, void* out,
                  const SwaArgs* a, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a->hkv < 1 || a->hq % a->hkv || a->seq < 1 || a->window < 1 || a->tq < 1)
    return (int)cudaErrorInvalidValue;
  const S* qp = static_cast<const S*>(q);
  const S* kp = static_cast<const S*>(k);
  const S* vp = static_cast<const S*>(v);
  S* op = static_cast<S*>(out);
  cudaStream_t st = (cudaStream_t)stream;
  switch (instance_dim(a->head_dim)) {
    case 16: err = launch_d<16>(qp, kp, vp, op, a, st); break;
    case 32: err = launch_d<32>(qp, kp, vp, op, a, st); break;
    case 64: err = launch_d<64>(qp, kp, vp, op, a, st); break;
    case 128: err = launch_d<128>(qp, kp, vp, op, a, st); break;
    case 256: err = launch_d<256>(qp, kp, vp, op, a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" {

int casper_swa_args_size(void) { return (int)sizeof(SwaArgs); }

int casper_swa_f32(int device, const void* q, const void* k, const void* v, void* out,
                   const void* args, void* stream) {
  return launch<float>(device, q, k, v, out, static_cast<const SwaArgs*>(args), stream);
}

int casper_swa_f16(int device, const void* q, const void* k, const void* v, void* out,
                   const void* args, void* stream) {
  return launch<__half>(device, q, k, v, out, static_cast<const SwaArgs*>(args), stream);
}

const char* casper_swa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
