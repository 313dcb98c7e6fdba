// What K5's two tensor-core kernels share: the argument block, the block
// geometry and the per-chunk online softmax.
//
//   swa_wgmma.cu  bf16 and f16 q/k/v (wgmma, TMA ring)
//   swa_tf32.cu   f32 q/k/v (mma.sync, three TF32 passes)
//
// Both fold the G query heads of a KV head into TC_ROWS = 128 rows per
// CTA, head-major (row g*P + t = head g, position p0 + t), and hold a
// chunk's scores in the accumulator layout that wgmma's m64nN and
// mma.sync's m16n8 share: per warp 16 rows, thread lane holding rows
// lane/4 and lane/4 + 8, element e of a chunk's scores at row (e >> 1) & 1
// and key 8*(e >> 2) + 2*(lane & 3) + (e & 1), and element e of the output
// accumulator at row (e >> 1) & 1 and column 8*(e >> 2) + 2*(lane & 3) +
// (e & 1).  The softmax below is therefore one function for both.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct SwaTcArgs {
  int batch;        // B
  int hq;           // query heads
  int hkv;          // key/value heads, hq % hkv == 0
  int seq;          // S
  int head_dim;     // d, a multiple of 16 up to the instance's D
  int window;       // W, clamped to S by the caller
  int positions;    // P, query positions per CTA (multiple of 8, heads*P <= 128)
  int heads;        // GC, query heads per CTA (all G, or a share of a split group)
  int has_softcap;  // 0 or 1
  float scale;      // 1/sqrt(d) in f32
  float softcap;
};

#define TC_ROWS 128  // query rows per CTA

// the argument checks both entries make; true where the kernels take `a`
static inline bool swa_args_ok(const SwaTcArgs* a) {
  return a->hkv >= 1 && a->hq % a->hkv == 0 && a->seq >= 1 && a->window >= 1 &&
         a->positions >= 8 && a->positions % 8 == 0 && a->heads >= 1 &&
         a->heads <= a->hq / a->hkv && a->heads * a->positions <= TC_ROWS &&
         a->head_dim % 16 == 0;
}

// the built head dim serving d (the smallest instance at least d), or 0
static inline int swa_instance_dim(int d) {
  if (d % 16 || d < 16 || d > 256) return 0;
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x, flushing results below 2^-126 to zero (those probabilities are far
// below anything the f32 sums can hold beside the row's 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) for |y| <= 0.55: y + y^3 Q(y^2), Q a degree-5 least-squares fit
// of (tanh(sqrt t)/sqrt t - 1)/t on [0, 0.3025].  Within one ulp of tanh
// (tanhf's bound is 2 ulp); tests/test_torch_swa.py checks that on a sweep
// of f32 values, through the same coefficients in tests/_swa_tc_mirror.py
// (TANH_POLY).  CUDA's tanhf serves every larger |y|.
__device__ __forceinline__ float tanh_small(float y) {
  const float y2 = y * y;
  float q = 2.524329582e-03f;
  q = fmaf(q, y2, -8.524764329e-03f);
  q = fmaf(q, y2, 2.181803063e-02f);
  q = fmaf(q, y2, -5.396465585e-02f);
  q = fmaf(q, y2, 1.333332360e-01f);
  q = fmaf(q, y2, -3.333333433e-01f);
  return fmaf(y * y2, q, y);
}

// Keep the compiler from moving accesses of asynchronous products'
// registers across them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One chunk of KC keys starting at c0: the thread's scores s (KC / 2, raw
// q.k) become probabilities exp(x - m_new), with x = q.k * scale, then
// softcap * tanh(x / softcap) where the call has a softcap, and masked
// keys (outside p - W < k <= p) exactly 0; the running max m and partial
// sum l of the thread's two rows are updated and its output accumulator o
// (NO elements) rescaled by exp(m_old - m_new).  exp is 2^((x - m) log2 e)
// on the MUFU.  Softcap divides by multiplying with 1/softcap (one
// rounding more than the reference's division, 2^-24 relative) and takes
// tanh from tanh_small where the whole warp's |x / softcap| <= 0.55.  The
// mask runs only on chunks that straddle k <= p or k > p - W.
template <int KC, int NO>
__device__ __forceinline__ void online_softmax(float* s, float* o, float* m, float* l,
                                               const int* pos, int c0, int p0, int p_hi,
                                               int quad, const SwaTcArgs& a) {
  constexpr float LOG2E = 1.4426950408889634f;
#pragma unroll
  for (int e = 0; e < KC / 2; ++e) s[e] *= a.scale;
  if (a.has_softcap) {
    const float inv_cap = 1.f / a.softcap;
    float big = 0.f;
#pragma unroll
    for (int e = 0; e < KC / 2; ++e) {
      s[e] *= inv_cap;
      big = fmaxf(big, fabsf(s[e]));
    }
    // the polynomial where the whole warp's |y| <= 0.55, else tanhf
    if (__any_sync(0xffffffffu, big > 0.55f)) {
#pragma unroll
      for (int e = 0; e < KC / 2; ++e) s[e] = a.softcap * tanhf(s[e]);
    } else {
#pragma unroll
      for (int e = 0; e < KC / 2; ++e) s[e] = a.softcap * tanh_small(s[e]);
    }
  }
  // only chunks that straddle k <= p or k > p - W need the mask
  if (!(c0 + KC - 1 <= p0 && c0 > p_hi - a.window)) {
#pragma unroll
    for (int e = 0; e < KC / 2; ++e) {
      const int key = c0 + 8 * (e >> 2) + 2 * quad + (e & 1);
      const int p = pos[(e >> 1) & 1];
      if (!(key <= p && key > p - a.window)) s[e] = -INFINITY;
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < KC / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float alpha[2], m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    m_use[i] = m_new == -INFINITY ? 0.f : m_new;
    alpha[i] = exp2_ftz((m[i] - m_use[i]) * LOG2E);
    m[i] = m_new;
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < KC / 2; ++e) {
    s[e] = exp2_ftz((s[e] - m_use[(e >> 1) & 1]) * LOG2E);
    ls[(e >> 1) & 1] += s[e];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ls[i];
#pragma unroll
  for (int e = 0; e < NO; ++e) o[e] *= alpha[(e >> 1) & 1];
}
