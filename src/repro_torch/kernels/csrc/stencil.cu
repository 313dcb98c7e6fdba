// Fused temporal-blocking stencil kernels K1-K4 for Hopper (sm_90a).
//
// Replaces (TPU/Pallas kernels of the reference package):
//   K1  src/repro/kernels/engine.py  _padfree_kernel           (stencil_sweep)
//   K2  src/repro/kernels/engine.py  _kernel                   (stencil_window_sweep)
//   K3  src/repro/kernels/engine.py  _padfree_pipeline_kernel  (pipeline_sweep)
//   K4  src/repro/kernels/engine.py  _pipeline_kernel          (pipeline_window_sweep)
//
// All four are one kernel template: `sweeps` fused applications of a
// chain of 1..4 rank-1..3 stencil stages (one stage for K1/K2, a
// StencilPipeline's stages for K3/K4) on one output tile per CTA
// (blockIdx.x = tile, blockIdx.y = batch element).  The window
// tile + 2*sweeps*H, where H is the per-dim sum of the stage radii, is
// staged in shared memory; each stage application writes the next
// intermediate, narrower by that stage's radius per side, into the other
// of two shared buffers (ping-pong), and the last application writes the
// tile straight to global memory, masked at the ragged edge.  The entry
// points differ only in how the window is loaded:
//   pad-free (K1/K3) loads each window element straight from the unpadded
//      grid through the boundary index map of its global coordinate under
//      stage 0's mode: fill for zero/constant, g mod N for periodic, the
//      period-(2N-2) fold for reflect.  That is pad_boundary at any depth,
//      read in place: no padded copy of the grid exists.
//   padded window (K2/K4) reads the window from an input pre-padded with
//      stage 0's mode at the tile's local offset; reads past the input's
//      end are masked to 0.  `origin` only shifts the global coordinates
//      used for ghost restoration.
// After every application but the last, the ghosts left in the
// intermediate (by global coordinate) are restored to the extension of
// the NEXT stage to run, stages[(k+1) % n], as
// repro.core.ref.masked_window_pipeline does: fill for zero/constant,
// re-mirror from inside the buffer for reflect, nothing for periodic (a
// fusable chain with a periodic stage is periodic in every stage).  The
// remaining ghost depth before stage k's application is the sum of the
// radii the rest of the block still consumes; g0 = tile origin - depth.
//
// Arithmetic: f64 results must be bit-identical to the reference oracle.
// Every product is rounded on its own and added to an accumulator that
// starts at zero, in tap order (star and dense stages) or in the factored
// order (separable stages: the term's 1-D passes nested innermost-first,
// each summed from zero in offset order; several terms are summed from
// zero in term order, one term is returned as is).  Inner passes are
// recomputed per point, which gives the same bits as staging them.  The
// library is built with -fmad=false and the intrinsics below round each
// operation explicitly, so no multiply-add is ever fused.  bf16 grids are
// loaded into f32, computed in f32 in shared memory, and rounded to bf16
// once, at the store (the reference's f32 accumulation).
//
// Bound on this card: each tile reads its window once from device memory
// (or L2) and writes its tile once, so the least traffic is one read and
// one write of the grid: 2 * prod(shape) * itemsize bytes over the
// 3.35 TB/s of an H100 SXM.  For the paper stencils and pipelines the
// operations per byte stay below the f64 ridge point (about 10 flop/byte),
// so the kernels are bound by bytes.  This version keeps every
// intermediate (every stage of every sweep) in shared memory, the only
// lever against the bytes bound that temporal blocking and stage fusion
// offer, but makes no other attempt at speed: windows are re-read per tile
// (the halo overhead of hbm_traffic), loads are plain (no TMA, no
// cp.async), and one CTA holds one tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CASPER_MAX_STAGES 4
#define CASPER_MAX_TAPS 96       // pooled across stages
#define CASPER_MAX_TERMS 16
#define CASPER_MAX_FACS 24
#define CASPER_MAX_FOFF 96
#define CASPER_THREADS 256

enum { MODE_ZERO = 0, MODE_CONSTANT = 1, MODE_PERIODIC = 2, MODE_REFLECT = 3 };

// One stage of the chain: its radius, boundary, and its slices of the
// pooled tap and term tables.
struct CasperStage {
  int halo[3];
  int mode;                      // MODE_*
  int tap_first;
  int n_taps;
  int term_first;
  int n_terms;                   // 0: tap chain; else factored terms
  double value;                  // constant(c) fill
};

// Every rank is carried as rank 3: missing leading dims have extent 1,
// tile 1, halo 0.  Mirrored field for field by repro_torch.kernels.engine
// (a ctypes.Structure); casper_args_size() lets the loader check it.
struct CasperArgs {
  int padded;                    // 0: pad-free (K1/K3), 1: padded window (K2/K4)
  int sweeps;
  int batch;
  int n_stages;
  int grid[3];                   // global grid extents (ghost restoration)
  int tile[3];
  int halo[3];                   // sum of the stage radii
  int src[3];                    // input extents per batch element
  int out[3];                    // output extents per batch element
  int origin[3];                 // padded: global coordinate of the output origin
  CasperStage stage[CASPER_MAX_STAGES];
  int tap_off[CASPER_MAX_TAPS][3];
  int term_fac[CASPER_MAX_TERMS];    // first factor of each term
  int term_nf[CASPER_MAX_TERMS];     // factors per term (1..3)
  int fac_axis[CASPER_MAX_FACS];
  int fac_first[CASPER_MAX_FACS];    // first offset of each factor in foff
  int fac_n[CASPER_MAX_FACS];
  int foff[CASPER_MAX_FOFF];
  double tap_c[CASPER_MAX_TAPS];
  double fc[CASPER_MAX_FOFF];    // factor coefficients, parallel to foff
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Storage type -> accumulator type, and the conversions at load and store.
template <typename S> struct Acc;
template <> struct Acc<float> {
  typedef float T;
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float rounded(double v) { return (float)v; }
};
template <> struct Acc<double> {
  typedef double T;
  static __device__ __forceinline__ double load(double v) { return v; }
  static __device__ __forceinline__ double store(double v) { return v; }
  static __device__ __forceinline__ double rounded(double v) { return v; }
};
template <> struct Acc<__nv_bfloat16> {
  typedef float T;
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
  // a fill value as the bf16 grid would hold it (pad_boundary on the grid)
  static __device__ __forceinline__ float rounded(double v) {
    return __bfloat162float(__float2bfloat16_rn((float)v));
  }
};

__device__ __forceinline__ int wrap_index(int g, int n) {
  int m = g % n;
  return m < 0 ? m + n : m;
}

__device__ __forceinline__ int reflect_index(int g, int n) {
  if (n == 1) return 0;
  int period = 2 * n - 2;
  int m = wrap_index(g, period);
  return m < n ? m : period - m;
}

// One application of stage `st` at point (p0,p1,p2) of the output extent;
// x is the input buffer with row strides s0 (dim 0) and s1 (dim 1).
template <typename T>
__device__ __forceinline__ T apply_point(const T* __restrict__ x, int s0, int s1,
                                         int p0, int p1, int p2,
                                         const CasperArgs& a, const CasperStage& st) {
  const T* __restrict__ c = x + (p0 + st.halo[0]) * s0 + (p1 + st.halo[1]) * s1 +
                            (p2 + st.halo[2]);
  if (st.n_terms == 0) {
    T acc = T(0);
    for (int k = st.tap_first; k < st.tap_first + st.n_taps; ++k) {
      const T v = c[a.tap_off[k][0] * s0 + a.tap_off[k][1] * s1 + a.tap_off[k][2]];
      acc = add_rn(acc, mul_rn(T(a.tap_c[k]), v));
    }
    return acc;
  }
  T total = T(0);
  T single = T(0);
  for (int t = st.term_first; t < st.term_first + st.n_terms; ++t) {
    // factors f0 (innermost, lowest axis) .. f0+nf-1 (outermost)
    const int f0 = a.term_fac[t];
    const int nf = a.term_nf[t];
    int sd[3], b[3], n[3];
    for (int f = 0; f < 3; ++f) {
      const int ff = f0 + (f < nf ? f : 0);
      const int ax = a.fac_axis[ff];
      sd[f] = ax == 0 ? s0 : (ax == 1 ? s1 : 1);
      b[f] = a.fac_first[ff];
      n[f] = a.fac_n[ff];
    }
    T v = T(0);
    if (nf == 1) {
      for (int j = 0; j < n[0]; ++j)
        v = add_rn(v, mul_rn(T(a.fc[b[0] + j]), c[a.foff[b[0] + j] * sd[0]]));
    } else if (nf == 2) {
      for (int j1 = 0; j1 < n[1]; ++j1) {
        const T* __restrict__ c1 = c + a.foff[b[1] + j1] * sd[1];
        T u = T(0);
        for (int j0 = 0; j0 < n[0]; ++j0)
          u = add_rn(u, mul_rn(T(a.fc[b[0] + j0]), c1[a.foff[b[0] + j0] * sd[0]]));
        v = add_rn(v, mul_rn(T(a.fc[b[1] + j1]), u));
      }
    } else {
      for (int j2 = 0; j2 < n[2]; ++j2) {
        const T* __restrict__ c2 = c + a.foff[b[2] + j2] * sd[2];
        T w = T(0);
        for (int j1 = 0; j1 < n[1]; ++j1) {
          const T* __restrict__ c1 = c2 + a.foff[b[1] + j1] * sd[1];
          T u = T(0);
          for (int j0 = 0; j0 < n[0]; ++j0)
            u = add_rn(u, mul_rn(T(a.fc[b[0] + j0]), c1[a.foff[b[0] + j0] * sd[0]]));
          w = add_rn(w, mul_rn(T(a.fc[b[1] + j1]), u));
        }
        v = add_rn(v, mul_rn(T(a.fc[b[2] + j2]), w));
      }
    }
    if (st.n_terms == 1) {
      single = v;
    } else {
      total = add_rn(total, v);   // tap_sum over terms: 0 + 1.0*v0 + 1.0*v1 ...
    }
  }
  return st.n_terms == 1 ? single : total;
}

template <typename S>
__global__ void __launch_bounds__(CASPER_THREADS)
casper_chain_kernel(const S* __restrict__ in, S* __restrict__ out,
                    const __grid_constant__ CasperArgs a) {
  typedef typename Acc<S>::T T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf_a = reinterpret_cast<T*>(smem_raw);

  // Which tile: blockIdx.x walks tiles with dim 2 fastest.
  int lin = blockIdx.x;
  const int nt2 = (a.out[2] + a.tile[2] - 1) / a.tile[2];
  const int nt1 = (a.out[1] + a.tile[1] - 1) / a.tile[1];
  int base[3];
  base[2] = (lin % nt2) * a.tile[2];
  lin /= nt2;
  base[1] = (lin % nt1) * a.tile[1];
  base[0] = (lin / nt1) * a.tile[0];

  const int sweeps = a.sweeps;
  int win[3], gorg[3], rem[3];
  for (int d = 0; d < 3; ++d) {
    rem[d] = sweeps * a.halo[d];                         // ghost depth left
    win[d] = a.tile[d] + 2 * rem[d];
    gorg[d] = (a.padded ? a.origin[d] : 0) + base[d];   // global coord of tile origin
  }
  const int n_win = win[0] * win[1] * win[2];
  const CasperStage& first = a.stage[0];
  const T fill0 = first.mode == MODE_CONSTANT ? Acc<S>::rounded(first.value) : T(0);

  // ---- load the window (stage 0's extension) ------------------------------
  const size_t src_elems = (size_t)a.src[0] * a.src[1] * a.src[2];
  const S* __restrict__ src = in + (size_t)blockIdx.y * src_elems;
  for (int i = threadIdx.x; i < n_win; i += blockDim.x) {
    const int j2 = i % win[2];
    const int r = i / win[2];
    const int j1 = r % win[1];
    const int j0 = r / win[1];
    int l[3] = {base[0] + j0, base[1] + j1, base[2] + j2};  // padded: local input index
    T v;
    if (a.padded) {
      const bool inside = l[0] < a.src[0] && l[1] < a.src[1] && l[2] < a.src[2];
      v = inside ? Acc<S>::load(src[((size_t)l[0] * a.src[1] + l[1]) * a.src[2] + l[2]])
                 : T(0);
    } else {
      int g[3];
      bool inside = true;
      for (int d = 0; d < 3; ++d) {
        g[d] = l[d] - rem[d];                               // global coordinate
        inside = inside && g[d] >= 0 && g[d] < a.grid[d];
      }
      if (first.mode == MODE_PERIODIC) {
        for (int d = 0; d < 3; ++d) g[d] = wrap_index(g[d], a.grid[d]);
        inside = true;
      } else if (first.mode == MODE_REFLECT) {
        for (int d = 0; d < 3; ++d) g[d] = reflect_index(g[d], a.grid[d]);
        inside = true;
      }
      v = inside ? Acc<S>::load(src[((size_t)g[0] * a.src[1] + g[1]) * a.src[2] + g[2]])
                 : fill0;
    }
    buf_a[i] = v;
  }
  __syncthreads();

  // ---- sweeps x n_stages fused applications, ping-pong in shared memory --
  T* xin = buf_a;
  T* const buf_b = buf_a + n_win;
  int cin[3] = {win[0], win[1], win[2]};
  const int total = sweeps * a.n_stages;
  int step = 0;
  for (int s = 0; s < sweeps; ++s) {
    for (int k = 0; k < a.n_stages; ++k) {
      const CasperStage& st = a.stage[k];
      int cur[3], g0[3];
      for (int d = 0; d < 3; ++d) {
        rem[d] -= st.halo[d];                  // ghost depth left after this one
        cur[d] = a.tile[d] + 2 * rem[d];
        g0[d] = gorg[d] - rem[d];
      }
      const int s1 = cin[2], s0 = cin[1] * cin[2];
      const int n_cur = cur[0] * cur[1] * cur[2];
      if (++step == total) {
        S* __restrict__ dst =
            out + (size_t)blockIdx.y * ((size_t)a.out[0] * a.out[1] * a.out[2]);
        for (int i = threadIdx.x; i < n_cur; i += blockDim.x) {
          const int p2 = i % cur[2];
          const int r = i / cur[2];
          const int p1 = r % cur[1];
          const int p0 = r / cur[1];
          const int o0 = base[0] + p0, o1 = base[1] + p1, o2 = base[2] + p2;
          if (o0 >= a.out[0] || o1 >= a.out[1] || o2 >= a.out[2]) continue;
          dst[((size_t)o0 * a.out[1] + o1) * a.out[2] + o2] =
              Acc<S>::store(apply_point(xin, s0, s1, p0, p1, p2, a, st));
        }
        return;
      }
      // ghosts of this intermediate take the extension of the next stage
      const CasperStage& nx = a.stage[(k + 1) % a.n_stages];
      T* const xout = (xin == buf_a) ? buf_b : buf_a;
      const bool fill_mode = nx.mode == MODE_ZERO || nx.mode == MODE_CONSTANT;
      const T fill = nx.mode == MODE_CONSTANT ? T(nx.value) : T(0);
      for (int i = threadIdx.x; i < n_cur; i += blockDim.x) {
        const int p2 = i % cur[2];
        const int r = i / cur[2];
        const int p1 = r % cur[1];
        const int p0 = r / cur[1];
        T v = apply_point(xin, s0, s1, p0, p1, p2, a, st);
        if (fill_mode) {
          const int ga = g0[0] + p0, gb = g0[1] + p1, gc = g0[2] + p2;
          const bool inside = ga >= 0 && ga < a.grid[0] && gb >= 0 && gb < a.grid[1] &&
                              gc >= 0 && gc < a.grid[2];
          if (!inside) v = fill;
        }
        xout[i] = v;
      }
      __syncthreads();
      if (nx.mode == MODE_REFLECT) {
        // One axis at a time, as reflect_gather: a ghost along `d` copies
        // the element at the fold of its coordinate (clipped into the
        // buffer; the clip only matters where no in-grid output reads).
        const int sd[3] = {cur[1] * cur[2], cur[2], 1};
        for (int d = 0; d < 3; ++d) {
          for (int i = threadIdx.x; i < n_cur; i += blockDim.x) {
            const int p2 = i % cur[2];
            const int r = i / cur[2];
            const int p1 = r % cur[1];
            const int p0 = r / cur[1];
            const int pd = d == 0 ? p0 : (d == 1 ? p1 : p2);
            const int g = g0[d] + pd;
            if (g >= 0 && g < a.grid[d]) continue;
            int srcd = reflect_index(g, a.grid[d]) - g0[d];
            srcd = srcd < 0 ? 0 : (srcd > cur[d] - 1 ? cur[d] - 1 : srcd);
            xout[i] = xout[i + (srcd - pd) * sd[d]];
          }
          __syncthreads();
        }
      }
      xin = xout;
      cin[0] = cur[0];
      cin[1] = cur[1];
      cin[2] = cur[2];
    }
  }
}

template <typename S>
static int launch(int device, const void* in, void* out, const CasperArgs* a,
                  void* stream) {
  typedef typename Acc<S>::T T;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the window, plus the first intermediate (the window less stage 0's
  // radius per side, the largest one) when more than one application runs
  size_t win = 1, inner = 1;
  for (int d = 0; d < 3; ++d) {
    const int w = a->tile[d] + 2 * a->sweeps * a->halo[d];
    win *= (size_t)w;
    inner *= (size_t)(w - 2 * a->stage[0].halo[d]);
  }
  const size_t smem = (win + (a->sweeps * a->n_stages > 1 ? inner : 0)) * sizeof(T);
  err = cudaFuncSetAttribute(casper_chain_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned int tiles = 1;
  for (int d = 0; d < 3; ++d) tiles *= (unsigned int)((a->out[d] + a->tile[d] - 1) / a->tile[d]);
  dim3 grid(tiles, (unsigned int)a->batch);
  casper_chain_kernel<S><<<grid, CASPER_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const S*>(in), static_cast<S*>(out), *a);
  return (int)cudaGetLastError();
}

extern "C" {

int casper_args_size(void) { return (int)sizeof(CasperArgs); }

int casper_stencil_f32(int device, const void* in, void* out, const void* args,
                       void* stream) {
  return launch<float>(device, in, out, static_cast<const CasperArgs*>(args), stream);
}

int casper_stencil_f64(int device, const void* in, void* out, const void* args,
                       void* stream) {
  return launch<double>(device, in, out, static_cast<const CasperArgs*>(args), stream);
}

int casper_stencil_bf16(int device, const void* in, void* out, const void* args,
                        void* stream) {
  return launch<__nv_bfloat16>(device, in, out, static_cast<const CasperArgs*>(args),
                               stream);
}

const char* casper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
