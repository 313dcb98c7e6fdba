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
// one output tile per CTA (blockIdx.x = tile, blockIdx.y = batch element).
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
//      end are masked to 0.  `origin` only shifts the global coordinates
//      used for ghost restoration.
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
// 2 or 3 in the paper stencils' tap order runs in strips of CASPER_STRIP
// rows per thread, the center column read once per strip (star_strips);
// other stages read their taps per point.  Each thread forms two points
// before it stores either, so their loads overlap.
//
// Loads: an interior tile of a pad-free f32/f64 launch whose grid rows
// are 16-byte aligned (decided by the host before the launch, args.async_load)
// copies its window with 16-byte cp.async, no register round trip; every
// other tile loads element by element.  Two CTAs fit on an SM at the 2-D
// default tile in f64, so one CTA's load overlaps the other's compute (a
// window prefetched by persistent CTAs would leave one: measured, the
// load overlaps all but about a tenth of the block already).
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
// so the kernels are bound by bytes; what keeps them from it is the
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
                                 // the paper stencils' tap order; else 0
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
  int async_load;                // 1: interior windows by 16-byte cp.async
  int grid[3];                   // global grid extents (ghost restoration)
  int tile[3];
  int halo[3];                   // sum of the stage radii
  int src[3];                    // input extents per batch element
  int out[3];                    // output extents per batch element
  int origin[3];                 // padded: global coordinate of the output origin
  int* tiles;                    // null, or counters: interior tiles, rim tiles
  CasperStage stage[CASPER_MAX_STAGES];
  int tap_lin[2][CASPER_MAX_TAPS];   // tap offsets in buffer 0 / buffer 1
  int term_fac[CASPER_MAX_TERMS];    // first factor of each term
  int term_nf[CASPER_MAX_TERMS];     // factors per term (1..3)
  int fac_first[CASPER_MAX_FACS];    // first offset of each factor in foff_lin
  int fac_n[CASPER_MAX_FACS];
  int foff_lin[2][CASPER_MAX_FOFF];  // factor offsets along their axis, per buffer
  double tap_c[CASPER_MAX_TAPS];
  double fc[CASPER_MAX_FOFF];    // factor coefficients, parallel to foff_lin
};

// The shared buffers: 0 holds the window, 1 the intermediates (from the
// first, the window less stage 0's radius per side, the largest).  An
// element at window coordinate (j0, j1, j2) sits at
// j0 * plane[b] + j1 * row + j2 + base[b] of buffer b.  Rows are rounded
// up to 16 bytes of storage (`vec` elements, 1 for bf16) and start at
// column `lead`, so that an aligned chunk of a grid row lands on an
// aligned chunk of the buffer when every tile's window starts at a
// column congruent to -sweeps*H (mod vec).
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
  Layout l;
  l.lead = (vec - (a.sweeps * a.halo[2]) % vec) % vec;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A thread's walk over the flat order of an n0 x n1 x n2 box (for rank R
// the leading 3 - R extents are 1), CASPER_THREADS points per step: the
// point is followed by adding per-stride deltas computed once per box
// and carrying into the next dim, so no step divides.
template <int R>
struct BoxWalk {
  int n1, n2, x0, x1, x2, d0, d1, d2;
  __device__ __forceinline__ BoxWalk(int n1_, int n2_) : n1(n1_), n2(n2_) {
    const int i = threadIdx.x;
    x2 = R == 1 ? i : i % n2;
    const int r = R == 1 ? 0 : i / n2;
    x1 = R == 3 ? r % n1 : r;
    x0 = R == 3 ? r / n1 : 0;
    d2 = R == 1 ? CASPER_THREADS : CASPER_THREADS % n2;
    const int dr = R == 1 ? 0 : CASPER_THREADS / n2;
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

// f(x0, x1, x2) on every point of an n0 x n1 x n2 box.
template <int R, typename F>
__device__ __forceinline__ void for_box(int n0, int n1, int n2, F&& f) {
  const int n = n0 * n1 * n2;
  BoxWalk<R> w(n1, n2);
  for (int i = threadIdx.x; i < n; i += CASPER_THREADS) {
    f(w.x0, w.x1, w.x2);
    w.next();
  }
}

// put(p, get(p)) on every point p of an n0 x n1 x n2 box, two points per
// thread at a time, both values formed before either is stored (the
// stores could alias the loads, so the compiler would not overlap them).
template <int R, typename G, typename P>
__device__ __forceinline__ void map_box(int n0, int n1, int n2, G&& get, P&& put) {
  const int n = n0 * n1 * n2;
  BoxWalk<R> w(n1, n2);
  for (int i = threadIdx.x; i < n; i += 2 * CASPER_THREADS) {
    const int a0 = w.x0, a1 = w.x1, a2 = w.x2;
    w.next();
    const int b0 = w.x0, b1 = w.x1, b2 = w.x2;
    w.next();
    const bool has_b = i + CASPER_THREADS < n;
    const auto va = get(a0, a1, a2);
    const auto vb = has_b ? get(b0, b1, b2) : va;
    put(a0, a1, a2, va);
    if (has_b) put(b0, b1, b2, vb);
  }
}

// One application of stage `st` at position L of buffer x; b selects the
// buffer's tap offsets.
template <typename T>
__device__ __forceinline__ T apply_point(const T* __restrict__ x, int L, int b,
                                         const CasperArgs& a, const CasperStage& st) {
  const T* __restrict__ c = x + L;
  if (st.n_terms == 0) {
    T acc = T(0);
    for (int k = st.tap_first; k < st.tap_first + st.n_taps; ++k)
      acc = add_rn(acc, mul_rn(T(a.tap_c[k]), c[a.tap_lin[b][k]]));
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
        v = add_rn(v, mul_rn(T(a.fc[b0 + j]), c[a.foff_lin[b][b0 + j]]));
    } else if (nf == 2) {
      const int b1 = a.fac_first[f0 + 1], n1 = a.fac_n[f0 + 1];
      for (int j1 = 0; j1 < n1; ++j1) {
        const T* __restrict__ c1 = c + a.foff_lin[b][b1 + j1];
        T u = T(0);
        for (int j0 = 0; j0 < n0; ++j0)
          u = add_rn(u, mul_rn(T(a.fc[b0 + j0]), c1[a.foff_lin[b][b0 + j0]]));
        v = add_rn(v, mul_rn(T(a.fc[b1 + j1]), u));
      }
    } else {
      const int b1 = a.fac_first[f0 + 1], n1 = a.fac_n[f0 + 1];
      const int b2 = a.fac_first[f0 + 2], n2 = a.fac_n[f0 + 2];
      for (int j2 = 0; j2 < n2; ++j2) {
        const T* __restrict__ c2 = c + a.foff_lin[b][b2 + j2];
        T w = T(0);
        for (int j1 = 0; j1 < n1; ++j1) {
          const T* __restrict__ c1 = c2 + a.foff_lin[b][b1 + j1];
          T u = T(0);
          for (int j0 = 0; j0 < n0; ++j0)
            u = add_rn(u, mul_rn(T(a.fc[b0 + j0]), c1[a.foff_lin[b][b0 + j0]]));
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
    return apply_point(x, L, b, a, st);
  }
};

// A radius-1 star stage of rank 2 (5 taps: center, row -1, row +1,
// column -1, column +1) or rank 3 (7 taps: center, plane -1, plane +1,
// row -1, row +1, column -1, column +1), each thread computing a strip of
// M rows of one column: the center column is read once for the strip's
// M + 2 rows and held in registers, so a point costs 3 (rank 2) or 5
// (rank 3) shared-memory loads instead of 5 or 7.  Every point's sum is
// formed in tap order, as FixedTaps forms it.
template <int R, int M, typename T, typename Put>
__device__ __forceinline__ void star_strips(const T* __restrict__ x, int pin, int row,
                                            const int* cur, const int* c,
                                            const CasperArgs& a, const CasperStage& st,
                                            Put&& put) {
  constexpr int NT = R == 2 ? 5 : 7;
  T k[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) k[t] = T(a.tap_c[st.tap_first + t]);
  const int strips = (cur[1] + M - 1) / M;
  for_box<R>(cur[0], strips, cur[2], [&](int q0, int sq, int q2) {
    const int q1 = sq * M;
    const int rows = min(M, cur[1] - q1);
    const T* __restrict__ p = x + (c[0] + q0) * pin + (c[1] + q1) * row + c[2] + q2;
    T col[M + 2];
#pragma unroll
    for (int i = 0; i < M + 2; ++i) col[i] = i <= rows + 1 ? p[(i - 1) * row] : T(0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (m < rows) {
        const T* __restrict__ pm = p + m * row;
        T acc = T(0);
        acc = add_rn(acc, mul_rn(k[0], col[m + 1]));
        if (R == 2) {
          acc = add_rn(acc, mul_rn(k[1], col[m]));
          acc = add_rn(acc, mul_rn(k[2], col[m + 2]));
          acc = add_rn(acc, mul_rn(k[3], pm[-1]));
          acc = add_rn(acc, mul_rn(k[4], pm[1]));
        } else {
          acc = add_rn(acc, mul_rn(k[1], pm[-pin]));
          acc = add_rn(acc, mul_rn(k[2], pm[pin]));
          acc = add_rn(acc, mul_rn(k[3], col[m]));
          acc = add_rn(acc, mul_rn(k[4], col[m + 2]));
          acc = add_rn(acc, mul_rn(k[5 % NT], pm[-1]));
          acc = add_rn(acc, mul_rn(k[6 % NT], pm[1]));
        }
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
  int win[3], gorg[3], full[3], rem[3];
  bool interior = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    full[d] = sweeps * a.halo[d];
    rem[d] = full[d];                                   // ghost depth left
    win[d] = a.tile[d] + 2 * full[d];
    gorg[d] = (a.padded ? a.origin[d] : 0) + base[d];  // global coord of tile origin
    interior = interior && gorg[d] - full[d] >= 0 && gorg[d] + a.tile[d] + full[d] <= a.grid[d];
  }
  if (a.tiles != nullptr && threadIdx.x == 0) atomicAdd(a.tiles + (interior ? 0 : 1), 1);
  const CasperStage& first = a.stage[0];
  const T fill0 = first.mode == MODE_CONSTANT ? Acc<S>::rounded(first.value) : T(0);

  // ---- load the window (stage 0's extension) into buffer 0 ----------------
  const size_t src_elems = (size_t)a.src[0] * a.src[1] * a.src[2];
  const S* __restrict__ src = in + (size_t)blockIdx.y * src_elems;
  T* const w0 = sm + ly.base[0];
  const int pl0 = ly.plane[0];
  if (a.padded) {
    for_box<R>(win[0], win[1], win[2], [&](int j0, int j1, int j2) {
      const int l0 = base[0] + j0, l1 = base[1] + j1, l2 = base[2] + j2;
      const bool inside = l0 < a.src[0] && l1 < a.src[1] && l2 < a.src[2];
      w0[j0 * pl0 + j1 * row + j2] =
          inside ? Acc<S>::load(src[((size_t)l0 * a.src[1] + l1) * a.src[2] + l2]) : T(0);
    });
  } else if (interior) {
    const S* __restrict__ g = src + ((size_t)(gorg[0] - full[0]) * a.src[1] + (gorg[1] - full[1])) *
                                        a.src[2] + (gorg[2] - full[2]);
    bool copied = false;
    if constexpr (sizeof(S) >= 4) {
      if (a.async_load) {
        // 16-byte chunks from the aligned column at or below the window's
        // first; the row pitch leaves room for the chunks past either end
        constexpr int vec = 16 / sizeof(S);
        const int chunks = (ly.lead + win[2] + vec - 1) / vec;
        const S* __restrict__ g16 = g - ly.lead;
        T* const s16 = sm;
        for_box<R>(win[0], win[1], chunks, [&](int j0, int j1, int ch) {
          cp_async16(s16 + j0 * pl0 + j1 * row + ch * vec,
                     g16 + (size_t)(j0 * a.src[1] + j1) * a.src[2] + ch * vec);
        });
        cp_async_wait_all();
        copied = true;
      }
    }
    if (!copied) {
      for_box<R>(win[0], win[1], win[2], [&](int j0, int j1, int j2) {
        w0[j0 * pl0 + j1 * row + j2] =
            Acc<S>::load(g[(size_t)(j0 * a.src[1] + j1) * a.src[2] + j2]);
      });
    }
  } else {
    for_box<R>(win[0], win[1], win[2], [&](int j0, int j1, int j2) {
      int gi[3] = {gorg[0] - full[0] + j0, gorg[1] - full[1] + j1, gorg[2] - full[2] + j2};
      bool inside = true;
#pragma unroll
      for (int d = 3 - R; d < 3; ++d) {
        if (first.mode == MODE_PERIODIC) {
          gi[d] = wrap_index(gi[d], a.grid[d]);
        } else if (first.mode == MODE_REFLECT) {
          gi[d] = reflect_index(gi[d], a.grid[d]);
        } else {
          inside = inside && gi[d] >= 0 && gi[d] < a.grid[d];
        }
      }
      w0[j0 * pl0 + j1 * row + j2] =
          inside ? Acc<S>::load(src[((size_t)gi[0] * a.src[1] + gi[1]) * a.src[2] + gi[2]])
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
        cur[d] = a.tile[d] + 2 * rem[d];
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
      S* __restrict__ dst = out + (size_t)blockIdx.y * ((size_t)a.out[0] * a.out[1] * a.out[2]);
      // where a value goes: the tile in global memory after the last
      // application; else the other buffer, a rim tile's out-of-grid
      // positions taking the fill of a zero/constant next stage
      auto put_last = [&](int q0, int q1, int q2, T v) {
        const int o0 = base[0] + q0, o1 = base[1] + q1, o2 = base[2] + q2;
        if (o0 < a.out[0] && o1 < a.out[1] && o2 < a.out[2])
          dst[((size_t)o0 * a.out[1] + o1) * a.out[2] + o2] = Acc<S>::store(v);
      };
      auto put_fill = [&](int q0, int q1, int q2, T v) {
        const int ga = g0[0] + q0, gb = g0[1] + q1, gc = g0[2] + q2;
        const bool inside = ga >= 0 && ga < a.grid[0] && gb >= 0 && gb < a.grid[1] &&
                            gc >= 0 && gc < a.grid[2];
        xout[(c[0] + q0) * pout + (c[1] + q1) * row + c[2] + q2] = inside ? v : fill;
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
        if (R >= 2 && st.star == R) {
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
          const int hi = min(max(g0[d] + cur[d] - a.grid[d], 0), cur[d] - lo);
          if (lo + hi == 0) continue;
          int box[3] = {cur[0], cur[1], cur[2]};
          box[d] = lo + hi;
          for_box<R>(box[0], box[1], box[2], [&](int q0, int q1, int q2) {
            int q[3] = {q0, q1, q2};
            const int qd = q[d] < lo ? q[d] : cur[d] - hi + (q[d] - lo);
            int from = reflect_index(g0[d] + qd, a.grid[d]) - g0[d];
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

// Dynamic shared memory of one CTA: both buffers in the accumulator type.
template <typename S>
static size_t smem_bytes(const CasperArgs* a) {
  typedef typename Acc<S>::T T;
  const Layout l = layout_of<S>(*a);
  return ((size_t)l.elems[0] + (size_t)l.elems[1]) * sizeof(T);
}

template <typename S, int R>
static int launch_rank(const void* in, void* out, const CasperArgs* a, size_t smem,
                       void* stream) {
  cudaError_t err = cudaFuncSetAttribute(casper_chain_kernel<S, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  unsigned int tiles = 1;
  for (int d = 0; d < 3; ++d) tiles *= (unsigned int)((a->out[d] + a->tile[d] - 1) / a->tile[d]);
  dim3 grid(tiles, (unsigned int)a->batch);
  casper_chain_kernel<S, R><<<grid, CASPER_THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const S*>(in), static_cast<S*>(out), *a);
  return (int)cudaGetLastError();
}

template <typename S>
static int launch(int device, const void* in, void* out, const CasperArgs* a,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // the host's rule for the cp.async path, checked: a window that does
  // not start on the layout's lead, or a row or base not 16-byte aligned
  const int vec = sizeof(S) >= 4 ? 16 / (int)sizeof(S) : 1;
  if (a->async_load && (sizeof(S) < 4 || a->padded || a->tile[2] % vec ||
                        (a->src[2] * sizeof(S)) % 16 || (uintptr_t)in % 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<S>(a);
  switch (a->rank) {
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

const char* casper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
