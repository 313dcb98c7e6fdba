// Fused temporal-blocking stencil kernels K1-K4 for Hopper (sm_90a).
//
// Replaces (TPU/Pallas kernels of the reference package):
//   K1  src/repro/kernels/engine.py  _padfree_kernel           (stencil_sweep)
//   K2  src/repro/kernels/engine.py  _kernel                   (stencil_window_sweep)
//   K3  src/repro/kernels/engine.py  _padfree_pipeline_kernel  (pipeline_sweep)
//   K4  src/repro/kernels/engine.py  _pipeline_kernel          (pipeline_window_sweep)
//
// All four are one kernel template, instantiated per storage type and per
// rank (1, 2, 3): `sweeps` fused applications of a chain of 1..4 stencil
// stages (one stage for K1/K2, a StencilPipeline's stages for K3/K4) on
// one output tile per CTA (blockIdx.x = batch group * tiles + tile, so
// a batch is not held to gridDim.y's 65,535).  A rank-3 spec (K1/K2 of
// one stage) runs instead in casper_stream_kernel below, which streams
// its tile plane by plane along dim 0 rather than holding a 3-D window.
// The window tile + 2*sweeps*H, where H is the per-dim sum of the stage
// radii, is staged in shared memory; each stage application writes the
// next intermediate, narrower by that stage's radius per side, into the
// other of two shared buffers (ping-pong), and the last application writes
// the tile straight to global memory, masked at the ragged edge.  The
// entry points differ only in how the window is loaded:
//   pad-free (K1/K3) reads the unpadded grid by global coordinate under
//      stage 0's mode: fill for zero/constant, g mod N for periodic, the
//      period-(2N-2) fold for reflect.  That is pad_boundary at any depth,
//      read in place: no padded copy of the grid exists.
//   padded window (K2/K4) reads the window from an input pre-padded with
//      stage 0's mode at the tile's local offset; reads past the input's
//      end (a ragged tile's) are masked to 0.  `origin` only shifts the
//      global coordinates used for ghost restoration.
// Small grids (K2/K4's traffic: serving buckets, grids below one window,
// and likewise K1/K3's): the host fits the default tile to a grid smaller
// than it, and packs a batch of such grids of rank 1-2 several to a CTA
// (CasperArgs.pack, P): their windows are stacked along the spare dim 0
// (extent 1, halo 0), so a tap keeps its linear offset, no tap crosses
// grids, and one box walk of the rank-3 instance covers all P grids in
// each application.  P fills the card where the batch allows, keeps two
// CTAs' buffers per SM, and gives every thread a point of the last
// application.
// After every application but the last, the ghosts left in the
// intermediate (by global coordinate) are restored to the extension of
// the NEXT stage to run, stages[(k+1) % n], as
// repro.core.ref.masked_window_pipeline does: fill for zero/constant,
// re-mirror from inside the buffer one axis at a time for reflect,
// nothing for periodic (a fusable chain with a periodic stage is periodic
// in every stage).  The remaining ghost depth before stage k's
// application is the sum of the radii the rest of the block still
// consumes; g0 = tile origin - depth.
//
// Tiles are interior or rim, uniformly per CTA.  An interior tile's whole
// window [origin - sweeps*H, origin + tile + sweeps*H) lies inside the
// grid in every dim, so no intermediate holds an out-of-grid point: its
// window is a plain copy (no boundary index map) and it skips the fill
// test and the restoration.  A rim tile maps every window element and
// restores only its ghost rim: the positions with an out-of-grid
// coordinate, one slab per side and axis, never a pass over the buffer.
//
// Layout: both shared buffers keep the window's row pitch P1 (and the
// window buffer its plane pitch), so a tap is one linear offset per stage
// and buffer, packed by the host; a point's position is linear in its
// window coordinate with no per-point division (threads walk a box with
// deltas computed once per box).  P1 rounds the row up to 16 bytes, with
// the window's first column placed at `lead` so that a row of the grid
// and its row in shared memory agree modulo 16 bytes.
//
// Compute: a stage of 3, 5 or 7 taps holds its offsets and coefficients in
// registers for the whole application (FixedTaps); a radius-1 star of rank
// 2 in the paper stencils' tap order runs in strips of CASPER_STRIP rows
// per thread, the center column read once per strip (star_strips); other
// stages read their taps per point.  Each thread forms two points
// before it stores either, so their loads overlap.
//
// Loads: a window that needs no boundary test (a pad-free interior tile's,
// a padded tile's inside its input) is a copy: in an f32/f64 launch whose
// input rows are 16-byte aligned (decided by the host before the launch,
// args.async_load) by 16-byte cp.async, no register round trip; in a
// padded f32/f64 launch of unaligned rows by a 4/8-byte cp.async per
// element, no test either; else element by element.  Every other tile
// loads element by element through the boundary index map or the mask.
// Two CTAs fit on an SM at the 2-D default tile in f64, so one CTA's load
// overlaps the other's compute (a window prefetched by persistent CTAs
// would leave one: measured, the load overlaps all but about a tenth of
// the block already).
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
// Bound on this card: the larger of one read and one write of the grid
// (2 * prod(shape) * itemsize bytes over the 3.35 TB/s of an H100 SXM)
// and the f64 operations without fused multiply-add (the arithmetic the
// f64 contract fixes per point and application: a product and an add per
// tap, or per factor tap plus the term sums in a separable spec's
// factored order; over 17e12 per second, half the data sheet's 34
// TFLOP/s, which counts an FMA as two).  Most paper stencils are bound by
// bytes; star33_3d at sweeps = 4 by operations (132 per point, 33 per
// application).  What keeps the kernels from the bound is the
// instructions each point costs (shared-memory loads, index arithmetic)
// and the halo each window recomputes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define CASPER_MAX_STAGES 4
#define CASPER_MAX_TAPS 96       // pooled across stages
#define CASPER_MAX_TERMS 16
#define CASPER_MAX_FACS 24
#define CASPER_MAX_FOFF 96
#define CASPER_THREADS 256       // threads per CTA
#define CASPER_STRIP 4           // rows per thread in a star stage's strip
#define CASPER_MIN_BLOCKS 2      // CTAs per SM the register budget leaves room for
#define CASPER_STREAM_THREADS 384  // threads per CTA of the streamed rank-3 kernel
#define CASPER_STREAM_AHEAD 2    // planes the streamed kernel loads ahead of use
#define CASPER_CORE27 27         // CasperStage.star of a 3x3x3-core-plus-arms stage

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
  int star;                      // 2 or 3: the radius-1 star of that rank, in
                                 // the paper stencils' tap order; CASPER_CORE27:
                                 // a separable 3x3x3 core, then distance-2 arms
                                 // along dims 0, 1, 2 (star33_3d); else 0
  double value;                  // constant(c) fill
};

// Every rank is carried as rank 3: missing leading dims have extent 1,
// tile 1, halo 0.  Mirrored field for field by repro_torch.kernels.engine
// (a ctypes.Structure); casper_args_size() lets the loader check it.
// Tap offsets are linear in the buffers' pitches (Layout below), which
// the host mirrors (repro_torch.core.plan.kernel_layout).
struct CasperArgs {
  int padded;                    // 0: pad-free (K1/K3), 1: padded window (K2/K4)
  int rank;                      // 1..3: which template instance runs
  int sweeps;
  int batch;
  int n_stages;
  int async_load;                // windows needing no test: 0 element by element,
                                 // 1 by 16-byte cp.async, 2 by a 4/8-byte
                                 // cp.async per element (padded only)
  int stream;                    // 1: rank 3, one stage, streamed along dim 0
  int pack;                      // grids per CTA (ranks 1-2, one tile per grid)
  int n_foff;                    // factor offsets in use (foff_lin, foff_dz)
  int grid[3];                   // global grid extents (ghost restoration)
  int tile[3];
  int halo[3];                   // sum of the stage radii
  int src[3];                    // input extents per batch element
  int out[3];                    // output extents per batch element
  int origin[3];                 // padded: global coordinate of the output origin
  int* tiles;                    // null, or counters: interior tiles, rim
                                 // tiles, CTAs per load kind (4), packed CTAs
  CasperStage stage[CASPER_MAX_STAGES];
  int tap_lin[2][CASPER_MAX_TAPS];   // tap offsets in buffer 0 / buffer 1
  int term_fac[CASPER_MAX_TERMS];    // first factor of each term
  int term_nf[CASPER_MAX_TERMS];     // factors per term (1..3)
  int fac_first[CASPER_MAX_FACS];    // first offset of each factor in foff_lin
  int fac_n[CASPER_MAX_FACS];
  int foff_lin[2][CASPER_MAX_FOFF];  // factor offsets along their axis, per buffer
  int tap_dz[CASPER_MAX_TAPS];       // streamed: each tap's dim-0 offset
  int foff_dz[CASPER_MAX_FOFF];      // streamed: each factor offset's dim-0 part
  double tap_c[CASPER_MAX_TAPS];
  double fc[CASPER_MAX_FOFF];    // factor coefficients, parallel to foff_lin
};

// The shared buffers: 0 holds the window, 1 the intermediates (from the
// first, the window less stage 0's radius per side, the largest).  An
// element at window coordinate (j0, j1, j2) sits at
// j0 * plane[b] + j1 * row + j2 + base[b] of buffer b.  Rows are rounded
// up to 16 bytes of storage (`vec` elements, 1 for bf16) and start at
// column `lead`, so that an aligned chunk of an input row lands on an
// aligned chunk of the buffer: a pad-free window starts at a grid column
// congruent to -sweeps*H (mod vec), a padded one at its tile's column of
// the padded input, 0 (mod vec).  A CTA of `pack` grids (ranks 1-2, whose
// dim 0 has extent 1 and halo 0) stacks their windows along dim 0.
struct Layout {
  int lead, row;
  int plane[2], base[2], elems[2];
};

template <typename S>
__host__ __device__ __forceinline__ Layout layout_of(const CasperArgs& a) {
  const int vec = sizeof(S) >= 4 ? 16 / (int)sizeof(S) : 1;
  const int* h = a.stage[0].halo;
  int win[3];
  for (int d = 0; d < 3; ++d) win[d] = a.tile[d] + 2 * a.sweeps * a.halo[d];
  win[0] *= a.pack;
  Layout l;
  l.lead = a.padded ? 0 : (vec - (a.sweeps * a.halo[2]) % vec) % vec;
  l.row = (l.lead + win[2] + vec - 1) / vec * vec;
  l.plane[0] = win[1] * l.row;
  l.plane[1] = (win[1] - 2 * h[1]) * l.row;
  l.base[0] = l.lead;
  l.base[1] = l.lead - h[0] * l.plane[1] - h[1] * l.row;
  l.elems[0] = win[0] * l.plane[0];
  l.elems[1] = a.sweeps * a.n_stages > 1 ? (win[0] - 2 * h[0]) * l.plane[1] : 0;
  return l;
}

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// an asynchronous copy of one 4- or 8-byte element
template <int N>
__device__ __forceinline__ void cp_async_elem(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A thread's walk over the flat order of an n0 x n1 x n2 box (for rank R
// the leading 3 - R extents are 1), CASPER_THREADS points per step: the
// point is followed by adding per-stride deltas computed once per box
// and carrying into the next dim, so no step divides.
template <int R, int NTH = CASPER_THREADS>
struct BoxWalk {
  int n1, n2, x0, x1, x2, d0, d1, d2;
  // a walk whose start and steps are already known (rank 2)
  __device__ __forceinline__ BoxWalk(int n1_, int n2_, int x1_, int x2_, int d1_, int d2_)
      : n1(n1_), n2(n2_), x0(0), x1(x1_), x2(x2_), d0(0), d1(d1_), d2(d2_) {}
  __device__ __forceinline__ BoxWalk(int n1_, int n2_) : n1(n1_), n2(n2_) {
    const int i = threadIdx.x;
    x2 = R == 1 ? i : i % n2;
    const int r = R == 1 ? 0 : i / n2;
    x1 = R == 3 ? r % n1 : r;
    x0 = R == 3 ? r / n1 : 0;
    d2 = R == 1 ? NTH : NTH % n2;
    const int dr = R == 1 ? 0 : NTH / n2;
    d1 = R == 3 ? dr % n1 : dr;
    d0 = R == 3 ? dr / n1 : 0;
  }
  __device__ __forceinline__ void next() {
    x2 += d2;
    if (R == 1) return;
    x1 += d1;
    x0 += d0;
    if (x2 >= n2) {
      x2 -= n2;
      ++x1;
    }
    if (R == 3 && x1 >= n1) {
      x1 -= n1;
      ++x0;
    }
  }
};

// f(x0, x1, x2) on every point of an n0 x n1 x n2 box, NTH threads.
template <int R, int NTH = CASPER_THREADS, typename F>
__device__ __forceinline__ void for_box(int n0, int n1, int n2, F&& f) {
  const int n = n0 * n1 * n2;
  BoxWalk<R, NTH> w(n1, n2);
  for (int i = threadIdx.x; i < n; i += NTH) {
    f(w.x0, w.x1, w.x2);
    w.next();
  }
}

// floor(i / n) for 0 <= i < 2**16 and 1 <= n < 2**13 by a float reciprocal:
// (i + 0.5) / n lies at least 0.5 / n from an integer, far above the
// reciprocal's error, so truncation gives the quotient.
__device__ __forceinline__ int small_div(int i, int n) {
  return __float2int_rz(((float)i + 0.5f) * __frcp_rn((float)n));
}

// map_box on an n1 x n2 plane, its walk started without an integer
// division (the streamed kernel maps a plane per level and step).
template <int NTH, typename G, typename P>
__device__ __forceinline__ void map_plane(int n1, int n2, G&& get, P&& put) {
  const int n = n1 * n2;
  const int x1 = small_div(threadIdx.x, n2), d1 = small_div(NTH, n2);
  BoxWalk<2, NTH> w(1, n2, x1, threadIdx.x - x1 * n2, d1, NTH - d1 * n2);
  for (int i = threadIdx.x; i < n; i += 2 * NTH) {
    const int a1 = w.x1, a2 = w.x2;
    w.next();
    const int b1 = w.x1, b2 = w.x2;
    w.next();
    const bool has_b = i + NTH < n;
    const auto va = get(0, a1, a2);
    const auto vb = has_b ? get(0, b1, b2) : va;
    put(0, a1, a2, va);
    if (has_b) put(0, b1, b2, vb);
  }
}

// put(p, get(p)) on every point p of an n0 x n1 x n2 box, two points per
// thread at a time, both values formed before either is stored (the
// stores could alias the loads, so the compiler would not overlap them).
template <int R, int NTH = CASPER_THREADS, typename G, typename P>
__device__ __forceinline__ void map_box(int n0, int n1, int n2, G&& get, P&& put) {
  const int n = n0 * n1 * n2;
  BoxWalk<R, NTH> w(n1, n2);
  for (int i = threadIdx.x; i < n; i += 2 * NTH) {
    const int a0 = w.x0, a1 = w.x1, a2 = w.x2;
    w.next();
    const int b0 = w.x0, b1 = w.x1, b2 = w.x2;
    w.next();
    const bool has_b = i + NTH < n;
    const auto va = get(a0, a1, a2);
    const auto vb = has_b ? get(b0, b1, b2) : va;
    put(a0, a1, a2, va);
    if (has_b) put(b0, b1, b2, vb);
  }
}

// One application of stage `st` at position L of buffer x; tap(k) and
// fo(j) give the linear offsets of tap k and of factor offset j.
template <typename T, typename Tap, typename Fo>
__device__ __forceinline__ T apply_point(const T* __restrict__ x, int L, Tap&& tap, Fo&& fo,
                                         const CasperArgs& a, const CasperStage& st) {
  const T* __restrict__ c = x + L;
  if (st.n_terms == 0) {
    T acc = T(0);
    for (int k = st.tap_first; k < st.tap_first + st.n_taps; ++k)
      acc = add_rn(acc, mul_rn(T(a.tap_c[k]), c[tap(k)]));
    return acc;
  }
  T total = T(0);
  T single = T(0);
  for (int t = st.term_first; t < st.term_first + st.n_terms; ++t) {
    // factors f0 (innermost, lowest axis) .. f0+nf-1 (outermost)
    const int f0 = a.term_fac[t];
    const int nf = a.term_nf[t];
    const int b0 = a.fac_first[f0], n0 = a.fac_n[f0];
    T v = T(0);
    if (nf == 1) {
      for (int j = 0; j < n0; ++j)
        v = add_rn(v, mul_rn(T(a.fc[b0 + j]), c[fo(b0 + j)]));
    } else if (nf == 2) {
      const int b1 = a.fac_first[f0 + 1], n1 = a.fac_n[f0 + 1];
      for (int j1 = 0; j1 < n1; ++j1) {
        const T* __restrict__ c1 = c + fo(b1 + j1);
        T u = T(0);
        for (int j0 = 0; j0 < n0; ++j0)
          u = add_rn(u, mul_rn(T(a.fc[b0 + j0]), c1[fo(b0 + j0)]));
        v = add_rn(v, mul_rn(T(a.fc[b1 + j1]), u));
      }
    } else {
      const int b1 = a.fac_first[f0 + 1], n1 = a.fac_n[f0 + 1];
      const int b2 = a.fac_first[f0 + 2], n2 = a.fac_n[f0 + 2];
      for (int j2 = 0; j2 < n2; ++j2) {
        const T* __restrict__ c2 = c + fo(b2 + j2);
        T w = T(0);
        for (int j1 = 0; j1 < n1; ++j1) {
          const T* __restrict__ c1 = c2 + fo(b1 + j1);
          T u = T(0);
          for (int j0 = 0; j0 < n0; ++j0)
            u = add_rn(u, mul_rn(T(a.fc[b0 + j0]), c1[fo(b0 + j0)]));
          w = add_rn(w, mul_rn(T(a.fc[b1 + j1]), u));
        }
        v = add_rn(v, mul_rn(T(a.fc[b2 + j2]), w));
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

// A star or dense stage of NT taps, its offsets and coefficients held in
// registers for the whole application (the paper stencils' 3, 5 and 7).
template <typename T, int NT>
struct FixedTaps {
  int off[NT];
  T c[NT];
  __device__ __forceinline__ FixedTaps(const CasperArgs& a, const CasperStage& st, int b) {
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      off[k] = a.tap_lin[b][st.tap_first + k];
      c[k] = T(a.tap_c[st.tap_first + k]);
    }
  }
  __device__ __forceinline__ T operator()(const T* __restrict__ x, int L) const {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < NT; ++k) acc = add_rn(acc, mul_rn(c[k], x[L + off[k]]));
    return acc;
  }
};

// Any other stage: taps or factored terms read from the argument block.
template <typename T>
struct AnyStage {
  const CasperArgs& a;
  const CasperStage& st;
  int b;
  __device__ __forceinline__ T operator()(const T* __restrict__ x, int L) const {
    return apply_point(
        x, L, [&](int k) { return a.tap_lin[b][k]; }, [&](int j) { return a.foff_lin[b][j]; },
        a, st);
  }
};

// A radius-1 star stage of rank 2 (5 taps: center, row -1, row +1,
// column -1, column +1), each thread computing a strip of M rows of one
// column: the center column is read once for the strip's M + 2 rows and
// held in registers, so a point costs 3 shared-memory loads instead of 5.
// Every point's sum is formed in tap order, as FixedTaps forms it.  The
// box's dim 0 holds the grids of a packed CTA (R = 3).  (The streamed
// rank-3 kernel runs rank 3's seven taps so: Star7Op.)
template <int R, int M, typename T, typename Put>
__device__ __forceinline__ void star_strips(const T* __restrict__ x, int plane, int row,
                                            const int* cur, const int* c, const CasperArgs& a,
                                            const CasperStage& st, Put&& put) {
  T k[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) k[t] = T(a.tap_c[st.tap_first + t]);
  const int strips = (cur[1] + M - 1) / M;
  for_box<R>(cur[0], strips, cur[2], [&](int q0, int sq, int q2) {
    const int q1 = sq * M;
    const int rows = min(M, cur[1] - q1);
    const T* __restrict__ p = x + (c[0] + q0) * plane + (c[1] + q1) * row + c[2] + q2;
    T col[M + 2];
#pragma unroll
    for (int i = 0; i < M + 2; ++i) col[i] = i <= rows + 1 ? p[(i - 1) * row] : T(0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m < rows) {
        const T* __restrict__ pm = p + m * row;
        T acc = T(0);
        acc = add_rn(acc, mul_rn(k[0], col[m + 1]));
        acc = add_rn(acc, mul_rn(k[1], col[m]));
        acc = add_rn(acc, mul_rn(k[2], col[m + 2]));
        acc = add_rn(acc, mul_rn(k[3], pm[-1]));
        acc = add_rn(acc, mul_rn(k[4], pm[1]));
        put(q0, q1 + m, q2, acc);
      }
    }
  });
}

template <typename S, int R>
__global__ void __launch_bounds__(CASPER_THREADS, CASPER_MIN_BLOCKS)
casper_chain_kernel(const S* __restrict__ in, S* __restrict__ out,
                    const __grid_constant__ CasperArgs a) {
  typedef typename Acc<S>::T T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout ly = layout_of<S>(a);
  // Buffers are addressed as offsets from the shared array itself (no
  // array of pointers), so the compiler keeps every access a 32-bit
  // shared-memory one.
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int row = ly.row;

  // Which tile: blockIdx.x = group * tiles + tile, tiles with dim 2
  // fastest; a group is `pack` consecutive batch elements.
  const int nt2 = (a.out[2] + a.tile[2] - 1) / a.tile[2];
  const int nt1 = (a.out[1] + a.tile[1] - 1) / a.tile[1];
  const int ntiles = nt1 * nt2 * ((a.out[0] + a.tile[0] - 1) / a.tile[0]);
  const int item = blockIdx.x / ntiles * a.pack;
  int lin = blockIdx.x % ntiles;
  int base[3];
  base[2] = (lin % nt2) * a.tile[2];
  lin /= nt2;
  base[1] = (lin % nt1) * a.tile[1];
  base[0] = (lin / nt1) * a.tile[0];
  // A packed CTA (R = 3 instance, ranks 1-2, one tile per grid) carries
  // np grids along dim 0, whose extent is 1 and halo 0: dim 0 of the
  // tile, the grid and the input and output extents becomes np, and
  // since one batch element's data follows the previous one's, dim-0
  // coordinate j addresses grid item + j.  No tap crosses grids.
  // (only the rank-3 instance runs packed launches: the host sends them
  // there, so the rank-1/2 instances compile without this path)
  const bool packed = R == 3 && a.pack > 1;
  const int np = min(a.pack, a.batch - item);
  const int tl[3] = {packed ? np : a.tile[0], a.tile[1], a.tile[2]};
  const int gd[3] = {packed ? np : a.grid[0], a.grid[1], a.grid[2]};
  const int sx[3] = {packed ? np : a.src[0], a.src[1], a.src[2]};
  const int ox0 = packed ? np : a.out[0];

  const int sweeps = a.sweeps;
  int win[3], gorg[3], full[3], rem[3];
  bool interior = true, inside = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    full[d] = sweeps * a.halo[d];
    rem[d] = full[d];                                   // ghost depth left
    win[d] = tl[d] + 2 * full[d];
    gorg[d] = (a.padded ? a.origin[d] : 0) + base[d];  // global coord of tile origin
    interior = interior && gorg[d] - full[d] >= 0 && gorg[d] + tl[d] + full[d] <= gd[d];
    inside = inside && base[d] + win[d] <= sx[d];       // padded: window in the input
  }
  const CasperStage& first = a.stage[0];
  const T fill0 = first.mode == MODE_CONSTANT ? Acc<S>::rounded(first.value) : T(0);

  // ---- load the window (stage 0's extension) into buffer 0 ----------------
  // A window that needs no boundary test -- a pad-free interior tile's,
  // or a padded tile's that lies inside its input (all but the ragged
  // end) -- is a plain copy: by 16-byte cp.async, by a cp.async per
  // element, or through registers (bf16, widened); kind 3 is the rest.
  const size_t src_elems = (size_t)a.src[0] * a.src[1] * a.src[2];
  const S* __restrict__ src = in + (size_t)item * src_elems;
  T* const w0 = sm + ly.base[0];
  const int pl0 = ly.plane[0];
  const bool copy = a.padded ? inside : interior;
  const int kind = !copy ? 3 : a.async_load == 1 ? 0 : a.async_load == 2 ? 1 : 2;
  if (a.tiles != nullptr && threadIdx.x == 0) {
    atomicAdd(a.tiles + (interior ? 0 : 1), 1);
    atomicAdd(a.tiles + 2 + kind, 1);
    if (np > 1) atomicAdd(a.tiles + 6, 1);
  }
  if (copy) {
    const int c0 = a.padded ? base[0] : gorg[0] - full[0];
    const int c1 = a.padded ? base[1] : gorg[1] - full[1];
    const int c2 = a.padded ? base[2] : gorg[2] - full[2];
    const S* __restrict__ g = src + ((size_t)c0 * sx[1] + c1) * sx[2] + c2;
    bool copied = false;
    if constexpr (sizeof(S) >= 4) {
      if (kind == 0) {
        // 16-byte chunks from the aligned column at or below the window's
        // first; the row pitch leaves room for the chunks past either end
        constexpr int vec = 16 / sizeof(S);
        const int chunks = (ly.lead + win[2] + vec - 1) / vec;
        const S* __restrict__ g16 = g - ly.lead;
        T* const s16 = sm;
        for_box<R>(win[0], win[1], chunks, [&](int j0, int j1, int ch) {
          cp_async16(s16 + j0 * pl0 + j1 * row + ch * vec,
                     g16 + (size_t)(j0 * sx[1] + j1) * sx[2] + ch * vec);
        });
        cp_async_wait_all();
        copied = true;
      } else if (kind == 1) {
        for_box<R>(win[0], win[1], win[2], [&](int j0, int j1, int j2) {
          cp_async_elem<sizeof(S)>(w0 + j0 * pl0 + j1 * row + j2,
                                   g + (size_t)(j0 * sx[1] + j1) * sx[2] + j2);
        });
        cp_async_wait_all();
        copied = true;
      }
    }
    if (!copied) {
      for_box<R>(win[0], win[1], win[2], [&](int j0, int j1, int j2) {
        w0[j0 * pl0 + j1 * row + j2] =
            Acc<S>::load(g[(size_t)(j0 * sx[1] + j1) * sx[2] + j2]);
      });
    }
  } else if (a.padded) {
    // a ragged tile: reads past the padded input's end are 0
    for_box<R>(win[0], win[1], win[2], [&](int j0, int j1, int j2) {
      const int l0 = base[0] + j0, l1 = base[1] + j1, l2 = base[2] + j2;
      const bool in_src = l0 < sx[0] && l1 < sx[1] && l2 < sx[2];
      w0[j0 * pl0 + j1 * row + j2] =
          in_src ? Acc<S>::load(src[((size_t)l0 * sx[1] + l1) * sx[2] + l2]) : T(0);
    });
  } else {
    for_box<R>(win[0], win[1], win[2], [&](int j0, int j1, int j2) {
      int gi[3] = {gorg[0] - full[0] + j0, gorg[1] - full[1] + j1, gorg[2] - full[2] + j2};
      bool in_grid = true;
#pragma unroll
      for (int d = 3 - R; d < 3; ++d) {
        if (R == 3 && d < 3 - a.rank) continue;  // a packed CTA's dim 0 indexes its grids
        if (first.mode == MODE_PERIODIC) {
          gi[d] = wrap_index(gi[d], gd[d]);
        } else if (first.mode == MODE_REFLECT) {
          gi[d] = reflect_index(gi[d], gd[d]);
        } else {
          in_grid = in_grid && gi[d] >= 0 && gi[d] < gd[d];
        }
      }
      w0[j0 * pl0 + j1 * row + j2] =
          in_grid ? Acc<S>::load(src[((size_t)gi[0] * sx[1] + gi[1]) * sx[2] + gi[2]])
                  : fill0;
    });
  }
  __syncthreads();

  // ---- sweeps x n_stages fused applications, ping-pong in shared memory --
  const int total = sweeps * a.n_stages;
  int step = 0;
  for (int s = 0; s < sweeps; ++s) {
    for (int k = 0; k < a.n_stages; ++k) {
      const CasperStage& st = a.stage[k];
      const int bi = step & 1;                 // input buffer
      const T* const xin = sm + (bi ? ly.elems[0] + ly.base[1] : ly.base[0]);
      const int pin = bi ? ly.plane[1] : ly.plane[0];
      int cur[3], c[3], g0[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        rem[d] -= st.halo[d];                  // ghost depth left after this one
        cur[d] = tl[d] + 2 * rem[d];
        c[d] = full[d] - rem[d];               // window coordinate of cur's origin
        g0[d] = gorg[d] - rem[d];
      }
      const bool last = ++step == total;
      // ghosts of this intermediate take the extension of the next stage
      const CasperStage& nx = a.stage[(k + 1) % a.n_stages];
      const int bo = bi ^ 1;
      T* const xout = sm + (bo ? ly.elems[0] + ly.base[1] : ly.base[0]);
      const int pout = bo ? ly.plane[1] : ly.plane[0];
      const bool fill_rim = !interior && (nx.mode == MODE_ZERO || nx.mode == MODE_CONSTANT);
      const T fill = nx.mode == MODE_CONSTANT ? T(nx.value) : T(0);
      S* __restrict__ dst = out + (size_t)item * ((size_t)a.out[0] * a.out[1] * a.out[2]);
      // where a value goes: the tile in global memory after the last
      // application; else the other buffer, a rim tile's out-of-grid
      // positions taking the fill of a zero/constant next stage
      auto put_last = [&](int q0, int q1, int q2, T v) {
        const int o0 = base[0] + q0, o1 = base[1] + q1, o2 = base[2] + q2;
        if (o0 < ox0 && o1 < a.out[1] && o2 < a.out[2])
          dst[((size_t)o0 * a.out[1] + o1) * a.out[2] + o2] = Acc<S>::store(v);
      };
      auto put_fill = [&](int q0, int q1, int q2, T v) {
        const int ga = g0[0] + q0, gb = g0[1] + q1, gc = g0[2] + q2;
        const bool in_grid = ga >= 0 && ga < gd[0] && gb >= 0 && gb < gd[1] &&
                             gc >= 0 && gc < gd[2];
        xout[(c[0] + q0) * pout + (c[1] + q1) * row + c[2] + q2] = in_grid ? v : fill;
      };
      auto put_keep = [&](int q0, int q1, int q2, T v) {
        xout[(c[0] + q0) * pout + (c[1] + q1) * row + c[2] + q2] = v;
      };
      auto apply = [&](auto&& put) {
        auto run = [&](const auto& pt) {
          map_box<R>(cur[0], cur[1], cur[2], [&](int q0, int q1, int q2) {
            return pt(xin, (c[0] + q0) * pin + (c[1] + q1) * row + c[2] + q2);
          }, put);
        };
        if (R >= 2 && st.star == 2) {
          star_strips<R, CASPER_STRIP>(xin, pin, row, cur, c, a, st, put);
        } else if (st.n_terms == 0 && st.n_taps == 5) {
          run(FixedTaps<T, 5>(a, st, bi));
        } else if (st.n_terms == 0 && st.n_taps == 3) {
          run(FixedTaps<T, 3>(a, st, bi));
        } else if (st.n_terms == 0 && st.n_taps == 7) {
          run(FixedTaps<T, 7>(a, st, bi));
        } else {
          run(AnyStage<T>{a, st, bi});
        }
      };
      if (last) {
        apply(put_last);
      } else if (fill_rim) {
        apply(put_fill);
      } else {
        apply(put_keep);
      }
      if (last) return;
      __syncthreads();
      if (!interior && nx.mode == MODE_REFLECT) {
        // One axis at a time, as reflect_gather: a ghost along `d` copies
        // the element at the fold of its coordinate (clipped into the
        // buffer; the clip only matters where no in-grid output reads).
        // Only the two ghost slabs along `d` are visited; their sources
        // lie inside the grid along `d`, so no pass reads what it writes.
#pragma unroll
        for (int d = 3 - R; d < 3; ++d) {
          const int lo = min(max(-g0[d], 0), cur[d]);
          const int hi = min(max(g0[d] + cur[d] - gd[d], 0), cur[d] - lo);
          if (lo + hi == 0) continue;
          int box[3] = {cur[0], cur[1], cur[2]};
          box[d] = lo + hi;
          for_box<R>(box[0], box[1], box[2], [&](int q0, int q1, int q2) {
            int q[3] = {q0, q1, q2};
            const int qd = q[d] < lo ? q[d] : cur[d] - hi + (q[d] - lo);
            int from = reflect_index(g0[d] + qd, gd[d]) - g0[d];
            from = from < 0 ? 0 : (from > cur[d] - 1 ? cur[d] - 1 : from);
            q[d] = qd;
            const int to = (c[0] + q[0]) * pout + (c[1] + q[1]) * row + c[2] + q[2];
            const int stride = d == 0 ? pout : (d == 1 ? row : 1);
            xout[to] = xout[to + (from - qd) * stride];
          });
          __syncthreads();
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Rank 3, one stage (K1/K2 of a 3-D spec): planes streamed along dim 0
// ---------------------------------------------------------------------------
// A CTA owns an xy tile and a chunk of tile[0] output planes (the tile's
// extent along dim 0).  It walks the chunk's window one plane of dim 0 at
// a time (2.5-D temporal blocking): a step loads one plane of the window
// into level 0's ring (CASPER_STREAM_AHEAD steps before it is read) and
// advances every application by one plane, the last application writing
// its plane of the tile straight to global memory.  Application 1 forms
// the plane h0 behind the newest window plane, from the 2*h0 + 1 planes
// around it; every later application lags its predecessor by h0 + 1, so
// that a step reads only planes formed at earlier steps and every level
// runs between the same two barriers (one barrier per step; a reflect rim
// tile adds two for its in-plane restoration).  Level l < sweeps keeps a
// ring of the 2*h0 + 2 planes: the 2*h0 + 1 the next application reads
// and the one it forms meanwhile (level 0: 2*h0 + 1 and the planes in
// flight); each plane is narrowed in xy by the radius the remaining
// applications consume: tile + 2*(sweeps - l)*h per side.  A chunk
// recomputes sweeps*h0 lead-in planes at each end, read through the
// boundary index map (wrapped for periodic), so no intermediate crosses
// CTAs and the only other recompute is the xy halo: at sweeps = 4,
// star33_3d's 16x16 tile forms 1.97 points per output (2.45 with the
// lead-in planes of a 32-plane chunk) and heat3d's 32x32 1.20 (1.32),
// against 16.3 for the 2x4x32 3-D window that star33_3d had.
//
// Ghosts of an intermediate, by global coordinate as _restore_ghosts
// places them: an out-of-grid plane is filled (zero/constant), formed
// like any other (periodic), or never formed (reflect): a read of it
// goes to its mirror plane, which the ring holds for every in-grid
// reader (the reads of an in-grid plane w lie in [w - h0, w + h0], and so
// do the mirrors of its out-of-grid ones).  Within an in-grid plane the
// ghosts of a rim tile are filled, or re-mirrored along dim 1 then dim 2
// as the window kernel does.  Composed, that is _restore_ghosts' axis by
// axis mirror, for every value an output reads.
//
// Taps: a stage's tap offsets are linear in one row pitch shared by every
// level (tap_lin[0]) plus a plane offset per dim-0 offset (tap_dz), which
// depends on the ring slot and is resolved per step and level (zslots).
// The stage's evaluator is built once per CTA (stream_body's Op): heat3d's
// radius-1 star holds its seven coefficients in registers and runs in row
// strips (Star7Op); star33_3d's separable 3x3x3 core with its arms holds
// fifteen (Core27Op); any other stage reads its taps per point from the
// argument block, their offsets from a table in shared memory built per
// step (TabledOp).  Sums keep tap or factored order, as everywhere in this
// file.
struct StreamGeom {
  int lead, row;      // first column and row pitch, shared by every level
  int depth0, depth;  // ring depth of level 0 and of levels 1..sweeps-1
};

template <typename S>
__host__ __device__ __forceinline__ StreamGeom stream_geom(const CasperArgs& a) {
  const int vec = sizeof(S) >= 4 ? 16 / (int)sizeof(S) : 1;
  StreamGeom g;
  g.lead = (vec - (a.sweeps * a.halo[2]) % vec) % vec;
  g.row = (g.lead + a.tile[2] + 2 * a.sweeps * a.halo[2] + vec - 1) / vec * vec;
  g.depth = 2 * a.halo[0] + 2;
  g.depth0 = 2 * a.halo[0] + 1 + CASPER_STREAM_AHEAD;
  return g;
}

// Elements of one plane of level l, and the offset of level l's ring.
__host__ __device__ __forceinline__ int stream_plane(const CasperArgs& a, const StreamGeom& g,
                                                     int l) {
  return (a.tile[1] + 2 * (a.sweeps - l) * a.halo[1]) * g.row;
}
__host__ __device__ __forceinline__ int stream_level_off(const CasperArgs& a,
                                                         const StreamGeom& g, int l) {
  int off = 0;
  for (int k = 0; k < l; ++k) off += (k ? g.depth : g.depth0) * stream_plane(a, g, k);
  return off;
}

// After the rings (16-byte aligned), for two steps in turn: the offset
// tables of the Tabled path, per level n_taps + n_foff ints; then per
// level the plane offsets of the 2*h0 + 1 planes it reads and of the one
// it writes (stream_zslots); last, per level its ring's offset and plane
// size.
template <typename S>
__host__ __device__ __forceinline__ size_t stream_table_byte(const CasperArgs& a) {
  typedef typename Acc<S>::T T;
  const StreamGeom g = stream_geom<S>(a);
  return ((size_t)stream_level_off(a, g, a.sweeps) * sizeof(T) + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int stream_zslots(const CasperArgs& a) {
  return 2 * a.halo[0] + 2;
}

template <typename S>
static size_t stream_smem_bytes(const CasperArgs* a) {
  return stream_table_byte<S>(*a) +
         (size_t)2 * a->sweeps * (a->stage[0].n_taps + a->n_foff + stream_zslots(*a) + 1) *
             sizeof(int);
}


// f(x1, x2) on every point of an n1 x n2 plane, NTH threads, the walk
// started without an integer division
template <int NTH, typename F>
__device__ __forceinline__ void for_plane(int n1, int n2, F&& f) {
  const int n = n1 * n2;
  const int x1 = small_div(threadIdx.x, n2), d1 = small_div(NTH, n2);
  BoxWalk<2, NTH> w(1, n2, x1, threadIdx.x - x1 * n2, d1, NTH - d1 * n2);
  for (int i = threadIdx.x; i < n; i += NTH) {
    f(w.x1, w.x2);
    w.next();
  }
}

// wait until at most CASPER_STREAM_AHEAD - 1 committed groups are pending
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(CASPER_STREAM_AHEAD - 1) : "memory");
}

// The stage evaluators of the streamed kernel.  Each is built once per
// CTA, its coefficients (and tap offsets within a plane) in registers for
// the whole chunk; plane() forms one plane of an application, cy x cx
// points, reading the planes of the level below through zs (zs[dz + h0]:
// the offset of the plane at dim-0 offset dz) and handing each value to
// put(0, q1, q2, v).  Sums keep tap or factored order.

// A radius-1 star of rank 3 in the paper stencils' tap order (heat3d's
// seven taps: center, dim-0 -1/+1, dim-1 -1/+1, dim-2 -1/+1), each thread
// forming a strip of CASPER_STRIP rows of one column: the column of the
// center plane is read once for the strip's rows and held in registers,
// so a point costs 5 shared-memory loads instead of 7 (star_strips'
// order).
template <typename T>
struct Star7Op {
  static constexpr bool kTabled = false;
  T k[7];
  __device__ __forceinline__ Star7Op(const CasperArgs& a, const CasperStage& st) {
#pragma unroll
    for (int t = 0; t < 7; ++t) k[t] = T(a.tap_c[st.tap_first + t]);
  }
  template <int NTH, typename Put>
  __device__ __forceinline__ void plane(const T* __restrict__ x, const int* zs, int L0, int cy,
                                        int cx, int row, const int*, Put&& put) const {
    constexpr int M = CASPER_STRIP;
    const T* __restrict__ lo = x + zs[0];
    const T* __restrict__ mid = x + zs[1];
    const T* __restrict__ hi = x + zs[2];
    for_plane<NTH>((cy + M - 1) / M, cx, [&](int sq, int q2) {
      const int q1 = sq * M;
      const int rows = min(M, cy - q1);
      const int L = L0 + q1 * row + q2;
      T col[M + 2];
#pragma unroll
      for (int i = 0; i < M + 2; ++i) col[i] = i <= rows + 1 ? mid[L + (i - 1) * row] : T(0);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        if (m < rows) {
          const int p = L + m * row;
          T acc = T(0);
          acc = add_rn(acc, mul_rn(k[0], col[m + 1]));
          acc = add_rn(acc, mul_rn(k[1], lo[p]));
          acc = add_rn(acc, mul_rn(k[2], hi[p]));
          acc = add_rn(acc, mul_rn(k[3], col[m]));
          acc = add_rn(acc, mul_rn(k[4], col[m + 2]));
          acc = add_rn(acc, mul_rn(k[5], mid[p - 1]));
          acc = add_rn(acc, mul_rn(k[6], mid[p + 1]));
          put(0, q1 + m, q2, acc);
        }
      }
    });
  }
};

// star33_3d's stage as factored: a separable term of three 3-point
// factors (dim 0 innermost, dim 2 outermost), then one 2-point term of
// offsets -2, +2 along each of dims 0, 1 and 2; summed from zero in
// term order.  The host flags only that exact structure (CASPER_CORE27).
template <typename T>
struct Core27Op {
  static constexpr bool kTabled = false;
  T c0[3], c1[3], c2[3], arm[3][2];
  __device__ __forceinline__ Core27Op(const CasperArgs& a, const CasperStage& st) {
    const int f0 = a.term_fac[st.term_first];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c0[j] = T(a.fc[a.fac_first[f0] + j]);
      c1[j] = T(a.fc[a.fac_first[f0 + 1] + j]);
      c2[j] = T(a.fc[a.fac_first[f0 + 2] + j]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int b = a.fac_first[a.term_fac[st.term_first + 1 + d]];
      arm[d][0] = T(a.fc[b]);
      arm[d][1] = T(a.fc[b + 1]);
    }
  }
  template <int NTH, typename Put>
  __device__ __forceinline__ void plane(const T* __restrict__ x, const int* zs, int L0, int cy,
                                        int cx, int row, const int*, Put&& put) const {
    int zb[5];  // h0 = 2
#pragma unroll
    for (int i = 0; i < 5; ++i) zb[i] = zs[i];
    map_plane<NTH>(cy, cx, [&](int, int q1, int q2) {
      const int L = L0 + q1 * row + q2;
      T core = T(0);
#pragma unroll
      for (int j2 = 0; j2 < 3; ++j2) {
        T w = T(0);
#pragma unroll
        for (int j1 = 0; j1 < 3; ++j1) {
          const int p = L + (j1 - 1) * row + (j2 - 1);
          T u = T(0);
#pragma unroll
          for (int j0 = 0; j0 < 3; ++j0) u = add_rn(u, mul_rn(c0[j0], x[p + zb[j0 + 1]]));
          w = add_rn(w, mul_rn(c1[j1], u));
        }
        core = add_rn(core, mul_rn(c2[j2], w));
      }
      const int c = L + zb[2];
      T total = add_rn(T(0), core);
      T v = add_rn(T(0), mul_rn(arm[0][0], x[L + zb[0]]));
      total = add_rn(total, add_rn(v, mul_rn(arm[0][1], x[L + zb[4]])));
      v = add_rn(T(0), mul_rn(arm[1][0], x[c - 2 * row]));
      total = add_rn(total, add_rn(v, mul_rn(arm[1][1], x[c + 2 * row])));
      v = add_rn(T(0), mul_rn(arm[2][0], x[c - 2]));
      return add_rn(total, add_rn(v, mul_rn(arm[2][1], x[c + 2])));
    }, put);
  }
};

// Any other stage: taps or factored terms read from the argument block
// per point, their offsets for this plane from a table in shared memory
// (n_taps tap offsets, then n_foff factor offsets).
template <typename T>
struct TabledOp {
  static constexpr bool kTabled = true;
  const CasperArgs& a;
  const CasperStage& st;
  template <int NTH, typename Put>
  __device__ __forceinline__ void plane(const T* __restrict__ x, const int*, int L0, int cy,
                                        int cx, int row, const int* tab, Put&& put) const {
    map_plane<NTH>(cy, cx, [&](int, int q1, int q2) {
      return apply_point(
          x, L0 + q1 * row + q2, [&](int k) { return tab[k]; },
          [&](int j) { return tab[st.n_taps + j]; }, a, st);
    }, put);
  }
};

template <typename S, typename Op>
__device__ __forceinline__ void stream_body(const S* __restrict__ in, S* __restrict__ out,
                                            const CasperArgs& a, const Op& op) {
  typedef typename Acc<S>::T T;
  constexpr int NTH = CASPER_STREAM_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  int* const tables = reinterpret_cast<int*>(smem_raw + stream_table_byte<S>(a));
  const int nzs = stream_zslots(a);
  int* const zslots = tables + 2 * a.sweeps * (a.stage[0].n_taps + a.n_foff);
  int* const levels_at = zslots + 2 * a.sweeps * stream_zslots(a);
  const StreamGeom geo = stream_geom<S>(a);
  const int row = geo.row, lead = geo.lead;
  const CasperStage& st = a.stage[0];
  const int sw = a.sweeps;
  const int hz = a.halo[0], hy = a.halo[1], hx = a.halo[2];
  // loop invariants, in registers rather than re-read from the argument
  // block (a constant bank whose cache the ~3 KB block overflows)
  const int t1 = a.tile[1], t2 = a.tile[2], n0 = a.grid[0], n1 = a.grid[1], n2 = a.grid[2];
  const int o1 = a.out[1], o2 = a.out[2], s0 = a.src[0], s1 = a.src[1], s2 = a.src[2];

  // blockIdx.x = batch element * tiles + tile, tiles with dim 2 fastest
  const int nt2 = (a.out[2] + t2 - 1) / t2;
  const int nt1 = (a.out[1] + t1 - 1) / t1;
  const int nt0 = (a.out[0] + a.tile[0] - 1) / a.tile[0];
  const int ntiles = nt0 * nt1 * nt2;
  const int item = blockIdx.x / ntiles;
  int lin = blockIdx.x % ntiles;
  const int base2 = (lin % nt2) * t2;
  lin /= nt2;
  const int base1 = (lin % nt1) * t1;
  const int base0 = (lin / nt1) * a.tile[0];
  const int org0 = a.padded ? a.origin[0] : 0, org1 = a.padded ? a.origin[1] : 0,
            org2 = a.padded ? a.origin[2] : 0;
  const int gz0 = org0 + base0, gy0 = org1 + base1, gx0 = org2 + base2;
  const int nz = min(a.tile[0], a.out[0] - base0);
  const int fz = sw * hz, fy = sw * hy, fx = sw * hx;
  const int e0y = t1 + 2 * fy, e0x = t2 + 2 * fx;
  const bool xy_in = gy0 - fy >= 0 && gy0 + t1 + fy <= n1 && gx0 - fx >= 0 &&
                     gx0 + t2 + fx <= n2;
  const bool interior = xy_in && gz0 - fz >= 0 && gz0 + nz + fz <= n0;
  if (a.tiles != nullptr && threadIdx.x == 0) atomicAdd(a.tiles + (interior ? 0 : 1), 1);
  const int mode = st.mode;
  const T fill0 = mode == MODE_CONSTANT ? Acc<S>::rounded(st.value) : T(0);
  const T fill = mode == MODE_CONSTANT ? T(st.value) : T(0);
  const S* __restrict__ src = in + (size_t)item * ((size_t)s0 * s1 * s2);
  S* __restrict__ dst = out + (size_t)item * ((size_t)a.out[0] * a.out[1] * a.out[2]);

  // where plane z of level l sits; a reflect intermediate's out-of-grid
  // plane is read from its mirror
  // each level's ring offset and plane size, once per CTA
  for (int l = threadIdx.x; l < sw; l += NTH) {
    levels_at[2 * l] = stream_level_off(a, geo, l);
    levels_at[2 * l + 1] = stream_plane(a, geo, l);
  }
  __syncthreads();
  auto slot = [&](int l, int z) {
    if (l > 0 && mode == MODE_REFLECT && (z < 0 || z >= n0))
      z = reflect_index(z, n0);
    return levels_at[2 * l] + wrap_index(z, l ? geo.depth : geo.depth0) * levels_at[2 * l + 1];
  };
  // one element of the window: a 4- or 8-byte cp.async from the grid, or
  // the fill (bf16 widens on a plain load)
  auto put_elem = [&](T* d, const S* g, bool inside, T f) {
    if constexpr (sizeof(S) >= 4) {
      if (inside) {
        cp_async_elem<sizeof(S)>(d, g);
      } else {
        *d = f;
      }
    } else {
      *d = inside ? Acc<S>::load(*g) : f;
    }
  };

  // level 0's plane z: a plain copy (16-byte cp.async where the host
  // allows it) inside the grid, else through the boundary index map (K1)
  // or from the pre-padded window, zero past its end (K2)
  auto load_plane = [&](int z) {
    T* const p = sm + slot(0, z) + lead;
    if (a.padded) {
      const int l0 = z - org0 + fz;
      for_plane<NTH>(e0y, e0x, [&](int j1, int j2) {
        const int l1 = base1 + j1, l2 = base2 + j2;
        const bool inside = l0 < s0 && l1 < s1 && l2 < s2;
        put_elem(p + j1 * row + j2, src + ((size_t)l0 * s1 + l1) * s2 + l2, inside,
                 T(0));
      });
      return;
    }
    if (xy_in && z >= 0 && z < n0) {
      const S* __restrict__ g =
          src + ((size_t)z * s1 + (gy0 - fy)) * s2 + (gx0 - fx);
      if constexpr (sizeof(S) >= 4) {
        if (a.async_load) {
          constexpr int vec = 16 / sizeof(S);
          const int chunks = (lead + e0x + vec - 1) / vec;
          T* const s16 = p - lead;
          const S* __restrict__ g16 = g - lead;
          for_plane<NTH>(e0y, chunks, [&](int j1, int ch) {
            cp_async16(s16 + j1 * row + ch * vec, g16 + (size_t)j1 * s2 + ch * vec);
          });
          return;
        }
      }
      for_plane<NTH>(e0y, e0x, [&](int j1, int j2) {
        put_elem(p + j1 * row + j2, g + (size_t)j1 * s2 + j2, true, T(0));
      });
      return;
    }
    int zz = z;
    bool zin = true;
    if (mode == MODE_PERIODIC) {
      zz = wrap_index(z, n0);
    } else if (mode == MODE_REFLECT) {
      zz = reflect_index(z, n0);
    } else {
      zin = z >= 0 && z < n0;
    }
    for_plane<NTH>(e0y, e0x, [&](int j1, int j2) {
      int gi1 = gy0 - fy + j1, gi2 = gx0 - fx + j2;
      bool inside = zin;
      if (mode == MODE_PERIODIC) {
        gi1 = wrap_index(gi1, n1);
        gi2 = wrap_index(gi2, n2);
      } else if (mode == MODE_REFLECT) {
        gi1 = reflect_index(gi1, n1);
        gi2 = reflect_index(gi2, n2);
      } else {
        inside = inside && gi1 >= 0 && gi1 < n1 && gi2 >= 0 && gi2 < n2;
      }
      put_elem(p + j1 * row + j2, src + ((size_t)zz * s1 + gi1) * s2 + gi2, inside,
               fill0);
    });
  };

  const int n_tab = st.n_taps + a.n_foff;
  const int L0 = hy * row + hx + lead;  // a plane's first point in the level below
  const int planes0 = nz + 2 * fz;        // window planes loaded
  const int steps = planes0 + sw - 1;     // the last application lags sw - 1 more
  const int z_first = gz0 - fz;
  // the plane application l forms at step j, and whether it has one:
  // level 1 lags the load by h0, every later level its predecessor by
  // h0 + 1, so that a step reads only planes formed at earlier steps
  auto plane_of = [&](int l, int jj) { return z_first + jj - l * (hz + 1) + 1; };
  auto active = [&](int l, int jj) {
    return jj >= 2 * l * hz + l - 1 && jj < planes0 + l - 1;
  };
  // whether factor offset j belongs to the innermost factor of its term:
  // apply_point adds the offsets of a term's factors, so only the
  // innermost (the lowest axis, dim 0 where the term has it) carries the
  // plane's ring slot
  auto innermost = [&](int j) {
    for (int t = st.term_first; t < st.term_first + st.n_terms; ++t) {
      const int b = a.fac_first[a.term_fac[t]];
      if (j >= b && j < b + a.fac_n[a.term_fac[t]]) return true;
    }
    return false;
  };
  // step jj's tables, in buffer jj & 1: per level the plane offsets of the
  // 2*h0 + 1 planes it reads and of the plane it writes, then (Tabled)
  // every tap's full offset and every factor offset's (its in-plane part
  // alone on an outer factor)
  auto build_tables = [&](int jj) {
    int* const zs = zslots + (jj & 1) * sw * nzs;
    for (int i = threadIdx.x; i < sw * nzs; i += NTH) {
      const int l = 1 + i / nzs, k = i % nzs;
      const int zl = plane_of(l, jj);
      zs[i] = k + 1 < nzs ? slot(l - 1, zl + k - hz) : (l < sw ? slot(l, zl) : 0);
    }
    if (!Op::kTabled) return;
    int* const tab = tables + (jj & 1) * sw * n_tab;
    for (int i = threadIdx.x; i < sw * n_tab; i += NTH) {
      const int l = 1 + i / n_tab, k = i % n_tab;
      const int zl = plane_of(l, jj);
      const int j = k - st.n_taps;
      tab[i] = k < st.n_taps  ? slot(l - 1, zl + a.tap_dz[k]) + a.tap_lin[0][k]
               : innermost(j) ? slot(l - 1, zl + a.foff_dz[j]) + a.foff_lin[0][j]
                              : a.foff_lin[0][j];
    }
  };
  build_tables(0);
  // one commit group per plane, empty for a plain or rim load, so that
  // waiting for all but the newest CASPER_STREAM_AHEAD - 1 groups waits
  // for this step's plane
  for (int p = 0; p < CASPER_STREAM_AHEAD; ++p) {
    if (p < planes0) load_plane(z_first + p);
    cp_async_commit();
  }
  for (int j = 0; j < steps; ++j) {
    cp_async_wait_ahead();
    __syncthreads();  // plane z_first + j, step j's tables and step j - 1's planes are in
    // into a slot no level reads now: depth0 = 2*h0 + 1 + AHEAD
    if (j + CASPER_STREAM_AHEAD < planes0) load_plane(z_first + j + CASPER_STREAM_AHEAD);
    cp_async_commit();
    if (j + 1 < steps) build_tables(j + 1);
    const int* const zs_step = zslots + (j & 1) * sw * nzs;
    const int* const tab_step = tables + (j & 1) * sw * n_tab;
    bool restore = false;
    // every application forms its plane; none reads what this step writes
    for (int l = 1; l <= sw; ++l) {
      if (!active(l, j)) continue;
      const int zl = plane_of(l, j);
      const int rem = sw - l;
      const int cy = t1 + 2 * rem * hy, cx = t2 + 2 * rem * hx;
      const bool last = l == sw;
      const bool z_out = zl < 0 || zl >= n0;
      const int* const zs = zs_step + (l - 1) * nzs;
      T* const po = last ? nullptr : sm + zs[nzs - 1] + lead;
      if (!last && z_out && mode != MODE_PERIODIC) {
        if (mode == MODE_REFLECT) continue;  // never formed: read from the mirror
        for_plane<NTH>(cy, cx, [&](int q1, int q2) { po[q1 * row + q2] = fill; });
        continue;
      }
      const int g0y = gy0 - rem * hy, g0x = gx0 - rem * hx;
      const int* const tab = tab_step + (l - 1) * n_tab;
      if (last) {
        S* __restrict__ d = dst + (size_t)(zl - org0) * o1 * o2;
        op.template plane<NTH>(sm, zs, L0, cy, cx, row, tab, [&](int, int q1, int q2, T v) {
          const int r1 = base1 + q1, r2 = base2 + q2;
          if (r1 < o1 && r2 < o2) d[(size_t)r1 * o2 + r2] = Acc<S>::store(v);
        });
      } else if (!xy_in && (mode == MODE_ZERO || mode == MODE_CONSTANT)) {
        op.template plane<NTH>(sm, zs, L0, cy, cx, row, tab, [&](int, int q1, int q2, T v) {
          const int gb = g0y + q1, gc = g0x + q2;
          const bool inside = gb >= 0 && gb < n1 && gc >= 0 && gc < n2;
          po[q1 * row + q2] = inside ? v : fill;
        });
      } else {
        op.template plane<NTH>(sm, zs, L0, cy, cx, row, tab,
                               [&](int, int q1, int q2, T v) { po[q1 * row + q2] = v; });
        restore = restore || (!xy_in && mode == MODE_REFLECT);
      }
    }
    if (!restore) continue;
    // a reflect rim tile re-mirrors the ghosts of the planes just formed,
    // along dim 1, then dim 2
#pragma unroll
    for (int d = 1; d < 3; ++d) {
      __syncthreads();
      for (int l = 1; l < sw; ++l) {
        const int zl = plane_of(l, j);
        if (!active(l, j) || zl < 0 || zl >= n0) continue;
        const int rem = sw - l;
        const int cy = t1 + 2 * rem * hy, cx = t2 + 2 * rem * hx;
        T* const po = sm + zs_step[(l - 1) * nzs + nzs - 1] + lead;
        const int g0 = d == 1 ? gy0 - rem * hy : gx0 - rem * hx, c = d == 1 ? cy : cx;
        const int n = d == 1 ? n1 : n2;
        const int lo = min(max(-g0, 0), c);
        const int hi = min(max(g0 + c - n, 0), c - lo);
        if (lo + hi == 0) continue;
        const int stride = d == 1 ? row : 1;
        for_box<2, NTH>(1, d == 1 ? lo + hi : cy, d == 1 ? cx : lo + hi,
                        [&](int, int q1, int q2) {
          int q[2] = {q1, q2};
          const int qd = q[d - 1] < lo ? q[d - 1] : c - hi + (q[d - 1] - lo);
          int from = reflect_index(g0 + qd, n) - g0;
          from = from < 0 ? 0 : (from > c - 1 ? c - 1 : from);
          q[d - 1] = qd;
          const int to = q[0] * row + q[1];
          po[to] = po[to + (from - qd) * stride];
        });
      }
    }
  }
}

// K1/K2 of a rank-3 spec: the stage's evaluator, built once per CTA.
template <typename S>
__global__ void __launch_bounds__(CASPER_STREAM_THREADS, 1)
casper_stream_kernel(const S* __restrict__ in, S* __restrict__ out,
                     const __grid_constant__ CasperArgs a) {
  typedef typename Acc<S>::T T;
  const CasperStage& st = a.stage[0];
  if (st.star == CASPER_CORE27) {
    stream_body(in, out, a, Core27Op<T>(a, st));
  } else if (st.star == 3) {
    stream_body(in, out, a, Star7Op<T>(a, st));
  } else {
    stream_body(in, out, a, TabledOp<T>{a, st});
  }
}

// Dynamic shared memory of one CTA: both buffers in the accumulator type
// (the streamed kernel: its rings and offset tables).
template <typename S>
static size_t smem_bytes(const CasperArgs* a) {
  typedef typename Acc<S>::T T;
  if (a->stream) return stream_smem_bytes<S>(a);
  const Layout l = layout_of<S>(*a);
  return ((size_t)l.elems[0] + (size_t)l.elems[1]) * sizeof(T);
}

// CTAs of a launch: every tile of every group of `pack` batch elements,
// all on gridDim.x (at most 2**31 - 1; repro_torch.core.plan.launch_blocks
// mirrors this), so a batch is not held to gridDim.y's 65,535.  0 when it
// does not fit.
static unsigned int launch_blocks(const CasperArgs* a) {
  long long blocks = (a->batch + a->pack - 1) / a->pack;
  for (int d = 0; d < 3; ++d) blocks *= (a->out[d] + a->tile[d] - 1) / a->tile[d];
  return blocks < (1LL << 31) ? (unsigned int)blocks : 0u;
}

template <typename S, int R>
static int launch_rank(const void* in, void* out, const CasperArgs* a, size_t smem,
                       void* stream) {
  const unsigned int blocks = launch_blocks(a);
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  if (R == 3 && a->stream) {
    cudaError_t err = cudaFuncSetAttribute(casper_stream_kernel<S>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    casper_stream_kernel<S><<<blocks, CASPER_STREAM_THREADS, smem, (cudaStream_t)stream>>>(
        static_cast<const S*>(in), static_cast<S*>(out), *a);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(casper_chain_kernel<S, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  casper_chain_kernel<S, R><<<blocks, CASPER_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const S*>(in), static_cast<S*>(out), *a);
  return (int)cudaGetLastError();
}

template <typename S>
static int launch(int device, const void* in, void* out, const CasperArgs* a,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the host's rules for the cp.async paths, checked: a window that does
  // not start on the layout's lead, or a row or base not 16-byte aligned;
  // a copy per element only into the padded entry's f32/f64 windows
  const int vec = sizeof(S) >= 4 ? 16 / (int)sizeof(S) : 1;
  if (a->async_load == 1 && (sizeof(S) < 4 || a->tile[2] % vec ||
                             (a->src[2] * sizeof(S)) % 16 || (uintptr_t)in % 16))
    return (int)cudaErrorInvalidValue;
  if ((a->async_load == 2 && (sizeof(S) < 4 || !a->padded)) || a->async_load > 2)
    return (int)cudaErrorInvalidValue;
  if (a->stream && (a->rank != 3 || a->n_stages != 1)) return (int)cudaErrorInvalidValue;
  // packing: ranks 1-2 only, each grid one tile
  if (a->pack < 1 ||
      (a->pack > 1 && (a->rank > 2 || a->tile[1] < a->out[1] || a->tile[2] < a->out[2])))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<S>(a);
  // a packed CTA walks its grids as dim 0: the rank-3 instance
  switch (a->pack > 1 ? 3 : a->rank) {
    case 1: return launch_rank<S, 1>(in, out, a, smem, stream);
    case 2: return launch_rank<S, 2>(in, out, a, smem, stream);
    case 3: return launch_rank<S, 3>(in, out, a, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" {

int casper_args_size(void) { return (int)sizeof(CasperArgs); }

// The dynamic shared memory a launch with `args` asks for, by storage
// itemsize (2: bf16, 4: f32, 8: f64).
long long casper_smem_bytes(const void* args, int itemsize) {
  const CasperArgs* a = static_cast<const CasperArgs*>(args);
  switch (itemsize) {
    case 8: return (long long)smem_bytes<double>(a);
    case 4: return (long long)smem_bytes<float>(a);
    case 2: return (long long)smem_bytes<__nv_bfloat16>(a);
    default: return -1;
  }
}

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

// Copies a box of `depth` planes x `height` rows x `width` bytes between
// host and device memory on `stream`, as one DMA: the slab executor's
// upload of a run of grid rows from pinned host memory into the interior
// of a padded window.  Rows of each side sit `pitch` bytes apart and
// planes `pitch * rows_per_plane` bytes apart.  A box of one row per
// plane is a 2-D copy of `depth` rows, one row a 1-D copy.  `kind`: 1
// host to device, 2 device to host.
int casper_copy_box(int device, void* dst, const void* src, long long width,
                    long long height, long long depth, long long dst_pitch,
                    long long dst_rows, long long src_pitch, long long src_rows,
                    int kind, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaMemcpyKind k = kind == 1 ? cudaMemcpyHostToDevice
                                     : cudaMemcpyDeviceToHost;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (height * depth == 1) return (int)cudaMemcpyAsync(dst, src, width, k, s);
  if (height == 1 || depth == 1) {
    const size_t dp = height == 1 ? dst_pitch * dst_rows : dst_pitch;
    const size_t sp = height == 1 ? src_pitch * src_rows : src_pitch;
    return (int)cudaMemcpy2DAsync(dst, dp, src, sp, width, height * depth, k, s);
  }
  cudaMemcpy3DParms p = {};
  p.srcPtr = make_cudaPitchedPtr(const_cast<void*>(src), src_pitch, width, src_rows);
  p.dstPtr = make_cudaPitchedPtr(dst, dst_pitch, width, dst_rows);
  p.extent = make_cudaExtent(width, height, depth);
  p.kind = k;
  return (int)cudaMemcpy3DAsync(&p, s);
}

const char* casper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
