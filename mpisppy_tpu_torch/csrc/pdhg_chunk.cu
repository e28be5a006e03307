// Fused PDHG iteration chunk for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `mpisppy_tpu/ops/pallas_pdhg.py::fused_chunk`
// (body `_chunk_kernel`, launched through `pl.pallas_call`).  Runs
// `n_steps` PDHG iterations for every scenario of a batch and returns the
// final iterates and the chunk's running sums.  Per scenario s and step,
// in the order of the Pallas body and of the torch twin:
//
//   aty  = A^T y
//   grad = cs + qs*x + aty
//   xn   = clip(x - tau*grad, lb, ub)
//   xt   = 2*xn - x
//   v    = y + sigma * (A xt)
//   yn   = v - sigma*clip(v/sigma, rlo, rhi)        (clip = min(max(.)))
//   x, y = xn, yn;  xsum += xn;  ysum += yn
//
// Inputs are solver-space (already Ruiz-scaled) and contiguous: cs, qs,
// lb, ub, x (S, N); rlo, rhi, y (S, M); tau, sigma (S,).  The operator
// A(s) comes in one of three forms (template parameter FORM):
//   dense   A (S, M, N), one matrix per scenario;
//   shared  A (1, M, N), one matrix for every scenario (ir.bmatvec's
//           shared-A form);
//   split   shared (M, N) plus vals (S, nnz) at (rows, cols) (ir.SplitA):
//           A(s) = shared + scatter-add of vals[s].
// The shared and split forms may hold B matrices (B, M, N) instead of
// one: a coalesced group of B requests of one bucket (serve/), each
// with its own matrix, which the `per_base` = S / B consecutive
// scenarios of a request read (matrix s / per_base; per_base is the
// kernel's last argument, S for one matrix, which gives the matrix
// every scenario reads).  The split form's rows and cols are the same
// for the whole group.
// Every form builds the same per-scenario tile, from which the step loop
// runs unchanged.  The shared and split forms read `shared` instead of
// the scenario's slab (every block reads the same M x N matrix, which
// stays in L2); the split form then adds its scenario's deltas that
// fall inside the tile, each element owned by one thread, in k order,
// rounding each sum to the storage type as A.to_dense() does.  Since
// shared holds zeros at the delta slots (0 + v = v), the tile holds
// exactly the values of to_dense(), and each form gives the dense
// kernel's result on to_dense() bit for bit.  The JAX package sends both
// forms to XLA (ops/pdhg.py:931-933); here they keep the solves that
// the split prep feeds on this kernel.
// Three entry points: f32 (all float), f64 (all double) and bf16 (A in
// __nv_bfloat16, every vector and every output float).  The bf16 form
// converts A with __bfloat162float once, as the tile enters registers,
// as the Pallas body casts its VMEM tile once per chunk.  The
// elementwise steps use the _rn intrinsics, so none of them is
// contracted into an FMA: only the summation order inside the two
// matvecs differs from the twin.
//
// What bounds it on this card.  Per scenario and step the two matvecs
// are 4*M*N FLOP, against ~10*N + 8*M elementwise.  The bytes it must
// move are A once per chunk plus the vectors.  At the main path's shape
// (S=1000, M=61, N=120, n_steps=40) that is 1.24 GFLOP against 34 MB in
// f32: 18.5 us at the FP32 CUDA-core peak and 10 us at the memory rate
// of an H100 SXM (data sheet, 700 W).  So it is bound by operations,
// provided A crosses from device memory once and the FMA pipes are kept
// fed.  Tensor cores do not help: each scenario has its own A and the
// steps depend on each other, so a matvec has no operand reuse; and TF32
// would break the IEEE-f32 contract that the solver's eps floor and
// promotion rule rest on (device.py).
//
// What held the first version back.  One block of 128 threads per
// scenario: each step walked 61 rows with 4 warps, one row after another,
// each row ending in a 5-step shuffle chain and a dual update on lane 0;
// the A^T y pass was one 61-long dependent FMA chain per thread; and A
// was read from shared memory again on every matvec (2 x 29 KB per step),
// with 33.6 KB of shared memory per block capping residency.
//
// The design.
//   * 2-D thread tiling.  A block of W warps owns one scenario.  Warp w
//     owns a band of R consecutive rows; lane l owns V groups of 4
//     consecutive columns, 4*(l + 32*v) .. +3.  A tile covers W*R rows
//     and 128*V columns.  Each thread keeps its R x 4V values of A in
//     registers for the whole chunk, so A is read from device memory
//     exactly once, with 16-byte loads (8 in bf16) in which neighbouring
//     lanes read neighbouring addresses.  Rows and columns past M and N
//     are zero.
//   * Both matvecs come from that register tile.  A^T y: each thread
//     sums its R rows for each of its columns (y is a shared-memory
//     broadcast); the W partial sums of a column meet in a (W x N)
//     shared buffer, where one thread per column adds them and does the
//     primal update.  A xt: each thread sums its columns for each of its
//     R rows; a reduce-scatter butterfly over the warp (R/2 + R/4 + ...
//     + 1 shuffles, then log2(32/R) to finish) lands each row's total
//     on its own group of 32/R lanes, so the dual updates of R rows run
//     at once.  Three __syncthreads() per step.
//   * (R, V, W) are template parameters.  Shapes beyond the register
//     tile (64 x 128) take the cluster kernel (below).
//     `ops/pdhg_chunk.py::pick_variant` chooses the variant from (S, M,
//     N, dtype) and the card's occupancy; PDHG_*_VARIANTS and
//     PDHG_CLUSTER_VARIANTS below are exactly the variants it can choose.
//   * State (x, x~, the bounds, the sums, y) lives in shared memory:
//     under 9 KB in f32 at the main path's shape, so registers, not
//     shared memory, set the residency: 64 registers a thread in f32
//     and bf16, 4 blocks per SM, 1.9 waves at S=1000; 128 in f64, 2
//     blocks, 3.8 waves.
//   * What bounds this design: instruction issue.  The step loop issues
//     ~190 instructions a warp, 64 of them the matvec FMAs; the rest are
//     the butterfly's selects and shuffles, the elementwise updates and
//     shared-memory addressing.  That is why it reaches ~1/5 of the FMA
//     bound on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
//
// The cluster kernel (`pdhg_chunk_cluster`), for every shape beyond the
// register tile.  Those shapes reach the kernel with few scenarios
// (S = 3..12 in the corpus and aircondB's bundles) or with A too large
// for registers (FWPH's hull QP, UC's fallback), and one block per
// scenario left most of the 132 SMs idle while each streamed its A
// twice a step.  Here:
//   * One scenario per thread-block cluster of C blocks (C <= 16, 8 warps
//     a block).  Block r owns a band of ~M/C consecutive rows and a slice
//     of ~N/C columns.  C is chosen on the card from what
//     cudaOccupancyMaxActiveClusters reports (pick_variant): C = 1 where
//     S alone fills the card.
//   * One pass over A a step.  The block that owns row i computes
//     (A x~)_i and updates y_i, and in the same pass adds A[i, :] y_i(new)
//     into its partial A^T y for the next step; one carry-only pass
//     before the first step forms A^T y0, and the last step skips the
//     carry: n_steps + 1 passes instead of 2 n_steps.  Within a pass a
//     row is read twice from shared memory (its dot by one warp, then its
//     carry column by column), once from device memory.
//   * The partial A^T y meet through distributed shared memory: block r
//     sums its slice over the C peers in rank order, does the primal
//     update there, and every block gathers the full x~ from its peers.
//     Two cluster barriers a step, no atomics: the sums run in a fixed
//     order, so the forms stay bit-equal to each other.
//   * Where A lives.  Resident: each block holds its band in its own
//     shared memory, loaded once per chunk.  Streamed (A that no cluster
//     can hold, e.g. aircondB's 9.9 MB a bundle): each block streams its
//     band once a pass through a ring of 2 stages of up to 8 rows in
//     shared memory, one in flight beside the one consumed, filled by
//     16-byte asynchronous copies (cp.async) spread over the block's
//     threads and completed by cp.async.wait_group; a stage's ragged head
//     and tail (a band need not start or end on 16 bytes) are copied by
//     plain loads.  (1-D bulk copies, cp.async.bulk completing on
//     mbarriers, were slower at aircondB's shape.)  A stage's dot splits
//     its columns over the 8 warps, whose partials meet in shared
//     memory.
//   * No padding: lanes take columns strided by 32, and the state is
//     sized to N and to the band.
//   * The split form patches its scenario's deltas into the block's own
//     copy of its band (each stage, when streamed), element e by thread
//     e % 256, in k order, each sum rounded to the storage type.
// What bounds it: the latency of each step's chain of dependent phases
// (dot, dual update, carry, the peers' sums, the gather), each a few
// hundred cycles of shared-memory round trips and barriers; resident
// rows at large S also by shared-memory traffic (a row read twice a
// pass), streamed rows by that chain a stage (~3 us on an H100), which
// keeps them under the bytes of A a pass over device memory (|A| each
// pass for a batch larger than the card's shared memory and L2).
// Nothing is allocated here: the caller passes the outputs.  Each entry
// point returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

// where the matvecs read A from
enum Src : int { kRegisters = 0, kResident = 1, kStreamed = 2 };
// how A is given (ops/pdhg_chunk.py FORMS)
enum Form : int { kDense = 0, kSharedA = 1, kSplit = 2 };

// elementwise arithmetic, rounded after each operation (never an FMA)
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
// matvec accumulation
__device__ __forceinline__ float mad(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  // min(max(v, lo), hi): exact with +-inf bounds, propagates NaN
  T a = (v < lo) ? lo : v;
  return (a > hi) ? hi : a;
}

// one stored element of A in the compute type
__device__ __forceinline__ float up(float v) { return v; }
__device__ __forceinline__ double up(double v) { return v; }
__device__ __forceinline__ float up(__nv_bfloat16 v) { return __bfloat162float(v); }

// a compute-type value rounded to the storage type TS and back (the
// split form's delta sums, as A.to_dense() builds them in TS)
__device__ __forceinline__ float round_to(const float*, float v) { return v; }
__device__ __forceinline__ double round_to(const double*, double v) { return v; }
__device__ __forceinline__ float round_to(const __nv_bfloat16*, float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float down(float*, float v) { return v; }
__device__ __forceinline__ double down(double*, double v) { return v; }
__device__ __forceinline__ __nv_bfloat16 down(__nv_bfloat16*, float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bf16_word_half(unsigned w, int hi) {
  __nv_bfloat16_raw r;
  r.x = (unsigned short)(hi ? (w >> 16) : (w & 0xffffu));
  return __bfloat162float(__nv_bfloat16(r));
}

// four consecutive elements at an aligned address
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  o[0] = bf16_word_half(w.x, 0); o[1] = bf16_word_half(w.x, 1);
  o[2] = bf16_word_half(w.y, 0); o[3] = bf16_word_half(w.y, 1);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double (&v)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// This thread's R x 4V values of the tile whose first row is row0 and
// first column col0 (zero outside M x N).  vec: rows start 16-byte
// aligned (8 in bf16) and N % 4 == 0, so a group of 4 is one load.
template <typename TS, typename T, int R, int V>
__device__ __forceinline__ void load_tile(T (&a)[R][V][4],
                                          const TS* __restrict__ Ab, int M,
                                          int N, int row0, int col0,
                                          int lane, bool vec) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    const TS* Ai = Ab + (size_t)i * (size_t)N;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int c = col0 + 4 * (lane + 32 * v);
      if (i < M && vec && c + 4 <= N) {
        load4(Ai + c, a[r][v]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          a[r][v][k] = (i < M && c + k < N) ? up(Ai[c + k]) : T(0);
      }
    }
  }
}

// Split form, register tile: gather this scenario's deltas that fall in
// this thread's R x 4V values (rows row0.., columns 4*(lane + 32v)..+3)
// into its own 4RV slots of shared memory, `patch`, before the tile is
// loaded, so that no register of the tile is live during the walk.  A
// repeated (row, col) pair sums in k order, each sum rounded to TS as
// A.to_dense() builds it.  Returns the mask of the slots written.
template <typename TS, typename T, int R, int V>
__device__ __forceinline__ unsigned gather_deltas(T* __restrict__ patch,
                                                  const int* __restrict__ rows,
                                                  const int* __restrict__ cols,
                                                  const TS* __restrict__ vs,
                                                  int nnz, int row0, int lane) {
  static_assert(R * V * 4 <= 32, "one mask bit per slot");
  unsigned touched = 0;
#pragma unroll 1
  for (int k = 0; k < nnz; ++k) {
    const int i = __ldg(rows + k) - row0;
    if ((unsigned)i >= (unsigned)R) continue;  // the same on the whole warp
    const int c = __ldg(cols + k);
    const int g = (c >> 2) - lane;  // column group, relative to this lane
    if (g < 0 || (g & 31) != 0 || (g >> 5) >= V) continue;
    const int slot = (i * V + (g >> 5)) * 4 + (c & 3);
    const T d = up(vs[k]);
    const T p = ((touched >> slot) & 1u) ? add_rn(patch[slot], d) : d;
    patch[slot] = round_to((const TS*)nullptr, p);
    touched |= 1u << slot;
  }
  return touched;
}

// Sum each of the R values over the warp's 32 lanes.  Each stage sends
// half of the remaining values to the partner lane and keeps the other
// half, so after log2(R) stages lane l holds one row's partial sum over
// the lanes that differ from it in the stage bits; the last stages add
// the rest.  Returns the total of row `row`, the same on all 32/R lanes
// of the row's group.
template <typename T, int R>
__device__ __forceinline__ T reduce_scatter(T (&v)[R], int lane, int& row) {
  static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0,
                "rows per thread must be a power of two <= 32");
  row = 0;
#pragma unroll
  for (int st = 0; (R >> st) > 1; ++st) {
    const int half = (R >> st) >> 1;
    const int bit = 16 >> st;
    const bool upper = (lane & bit) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const T send = upper ? v[k] : v[k + half];
      const T keep = upper ? v[k + half] : v[k];
      v[k] = keep + __shfl_xor_sync(0xffffffffu, send, bit);
    }
    if (upper) row += half;
  }
#pragma unroll
  for (int bit = 16 / R; bit > 0; bit >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], bit);
  return v[0];
}

template <typename TS, typename T, int R, int V, int W, int FORM, int MINB>
__global__ void __launch_bounds__(W * 32, MINB)
pdhg_chunk_tiled(const TS* __restrict__ A, const int* __restrict__ drows,
                 const int* __restrict__ dcols,
                 const TS* __restrict__ dvals, int nnz,
                 const T* __restrict__ cs,
                 const T* __restrict__ qs, const T* __restrict__ lb,
                 const T* __restrict__ ub, const T* __restrict__ rlo,
                 const T* __restrict__ rhi, const T* __restrict__ x0,
                 const T* __restrict__ y0, const T* __restrict__ tau,
                 const T* __restrict__ sigma, T* __restrict__ xo,
                 T* __restrict__ yo, T* __restrict__ xso,
                 T* __restrict__ yso, int M, int N, int n_steps, int vec,
                 int per_base) {
  constexpr int NT = 32 * W;
  constexpr int RT = R * W;    // rows of one tile
  constexpr int CT = 128 * V;  // columns of one tile
  const int Mp = (M + RT - 1) / RT * RT;
  const int Np = (N + CT - 1) / CT * CT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* x = reinterpret_cast<T*>(smem_raw);
  T* xt = x + Np;
  T* c = xt + Np;
  T* q = c + Np;
  T* l = q + Np;
  T* u = l + Np;
  T* xsum = u + Np;
  T* y = xsum + Np;
  T* rl = y + Mp;
  T* rh = rl + Mp;
  T* ysum = rh + Mp;
  T* red = ysum + Mp;  // (W, Np): each warp's partial A^T y
  // then the split form's per-thread delta patch (32 W x 4RV values)

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t on = (size_t)s * N;
  const size_t om = (size_t)s * M;
  for (int j = tid; j < Np; j += NT) {
    const bool in = j < N;
    x[j] = in ? x0[on + j] : T(0);
    c[j] = in ? cs[on + j] : T(0);
    q[j] = in ? qs[on + j] : T(0);
    l[j] = in ? lb[on + j] : T(0);
    u[j] = in ? ub[on + j] : T(0);
    xt[j] = T(0);
    xsum[j] = T(0);
  }
  for (int i = tid; i < Mp; i += NT) {
    const bool in = i < M;
    y[i] = in ? y0[om + i] : T(0);
    rl[i] = in ? rlo[om + i] : T(0);
    rh[i] = in ? rhi[om + i] : T(0);
    ysum[i] = T(0);
  }
  // the shared and split forms read the matrix of the scenario's
  // request (the one shared matrix when per_base = S)
  const TS* Ag = A + (size_t)(FORM == kDense ? s : s / per_base) *
                         (size_t)M * (size_t)N;
  const TS* vs = FORM == kSplit ? dvals + (size_t)s * (size_t)nnz : dvals;
  const T tau_s = tau[s];
  const T sig = sigma[s];
  const int row0 = warp * R;
  const bool vec_ok = vec != 0;

  T a[R][V][4];
  if constexpr (FORM == kSplit) {
    // this thread's slots of the patch area (after the reduction buffer)
    T* patch = reinterpret_cast<T*>(red + W * Np) + tid * (R * V * 4);
    const unsigned touched =
        gather_deltas<TS, T, R, V>(patch, drows, dcols, vs, nnz, row0, lane);
    load_tile<TS, T, R, V>(a, Ag, M, N, row0, 0, lane, vec_ok);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int slot = (r * V + v) * 4 + e;
          if ((touched >> slot) & 1u)
            a[r][v][e] = round_to((const TS*)nullptr,
                                  add_rn(a[r][v][e], patch[slot]));
        }
  } else {
    load_tile<TS, T, R, V>(a, Ag, M, N, row0, 0, lane, vec_ok);
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    // A^T y: this warp's partial column sums -> red[warp][:]
    {
      T acc[V][4];
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[v][k] = T(0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T yr = y[row0 + r];
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[v][k] = mad(a[r][v][k], yr, acc[v][k]);
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        store4(red + warp * Np + 4 * (lane + 32 * v), acc[v]);
    }
    __syncthreads();
    // primal update, one thread per column
    for (int j = tid; j < N; j += NT) {
      T aty = red[j];
#pragma unroll
      for (int w = 1; w < W; ++w) aty = add_rn(aty, red[w * Np + j]);
      const T xj = x[j];
      const T grad = add_rn(add_rn(c[j], mul_rn(q[j], xj)), aty);
      const T xn = clip(sub_rn(xj, mul_rn(tau_s, grad)), l[j], u[j]);
      xt[j] = sub_rn(mul_rn(T(2), xn), xj);
      x[j] = xn;
      xsum[j] = add_rn(xsum[j], xn);
    }
    __syncthreads();
    // A xt: this thread's row sums, reduce-scatter, dual update
    {
      T acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = T(0);
      T xv[V][4];
#pragma unroll
      for (int v = 0; v < V; ++v) load4(xt + 4 * (lane + 32 * v), xv[v]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r] = mad(a[r][v][k], xv[v][k], acc[r]);
      int rr = 0;
      const T ax = reduce_scatter<T, R>(acc, lane, rr);
      const int i = row0 + rr;
      if ((lane & (32 / R - 1)) == 0 && i < M) {
        const T vi = add_rn(y[i], mul_rn(sig, ax));
        const T zc = clip(div_rn(vi, sig), rl[i], rh[i]);
        const T yn = sub_rn(vi, mul_rn(sig, zc));
        y[i] = yn;
        ysum[i] = add_rn(ysum[i], yn);
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < N; j += NT) {
    xo[on + j] = x[j];
    xso[on + j] = xsum[j];
  }
  for (int i = tid; i < M; i += NT) {
    yo[om + i] = y[i];
    yso[om + i] = ysum[i];
  }
}

// ---- the cluster kernel: A resident in shared memory, or streamed ----

constexpr int kClusterWarps = 8;
constexpr int kClusterThreads = 32 * kClusterWarps;
constexpr int kMaxCluster = 16;
constexpr int kStages = 2;     // the streamed source's ring
constexpr int kStageRows = 8;  // rows of a streamed stage, at most

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

// Byte offsets into one block's dynamic shared memory
// (ops/pdhg_chunk.py Variant.smem_bytes computes the same total):
// the streamed source's ring of stages, then the state (xt (N), part
// (max(N, threads)), the column slice's x, c, q, lb, ub, xsum (nc
// each), the band's y, rlo, rhi, ysum (mb each), the streamed dot's
// partials (W x kStageRows)), then the resident source's band of A (mb
// x N in the storage type).
struct Layout {
  size_t ring, stage_bytes, state, band, total;
  int nc, mb;
};

__host__ __device__ inline Layout cluster_layout(int M, int N, int C, int src,
                                                 int stage_rows, size_t cb,
                                                 size_t sb) {
  Layout L;
  L.nc = (N + C - 1) / C;
  L.mb = (M + C - 1) / C;
  size_t off = 0;
  L.stage_bytes = round16((size_t)stage_rows * (size_t)N * sb + 16);
  L.ring = off;
  if (src == kStreamed) off += (size_t)kStages * L.stage_bytes;
  L.state = off;
  const size_t part = N > kClusterThreads ? (size_t)N : kClusterThreads;
  const size_t red = src == kStreamed ? kClusterWarps * kStageRows : 0;
  off += round16(((size_t)N + part + 6 * (size_t)L.nc + 4 * (size_t)L.mb +
                  red) *
                 cb);
  L.band = off;
  if (src == kResident) off += round16((size_t)L.mb * (size_t)N * sb);
  L.total = off;
  return L;
}

// the block of the cluster whose column slice holds column j
// (slice p is [p N / C, (p + 1) N / C))
__device__ __forceinline__ int slice_owner(int j, int N, int C) {
  return (int)(((long long)C * (j + 1) - 1) / N);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// a 16-byte copy global -> shared memory that completes asynchronously
// (dst and src 16-byte aligned), its commit group, and the wait until
// at most kStages - 1 of this thread's groups are pending
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
}

// n elements from global memory to shared memory by plain loads (a
// stage's ragged head and tail: under 16 bytes each)
template <typename TS>
__device__ __forceinline__ void copy_elements(TS* dst, const TS* src, int n) {
  for (int k = 0; k < n; ++k) dst[k] = src[k];
}

// Add the band rows [i0, i1) of a scenario's deltas into a copy of
// those rows, `Ar` (row i0 first).  Element e of the copy belongs to
// thread e % threads, which applies the deltas that land on it in k
// order, each sum rounded to TS as A.to_dense() builds it.
template <typename TS, typename T>
__device__ __forceinline__ void patch_rows(TS* Ar, int i0, int i1, int N,
                                           const int* __restrict__ drows,
                                           const int* __restrict__ dcols,
                                           const TS* __restrict__ vs, int nnz,
                                           int row_base, int tid) {
#pragma unroll 1
  for (int k = 0; k < nnz; ++k) {
    const int i = __ldg(drows + k) - row_base;
    const int c = __ldg(dcols + k);
    if (i < i0 || i >= i1 || c < 0 || c >= N) continue;
    const size_t e = (size_t)(i - i0) * (size_t)N + (size_t)c;
    if (e % kClusterThreads != (size_t)tid) continue;
    Ar[e] = down((TS*)nullptr,
                 round_to((const TS*)nullptr, add_rn(up(Ar[e]), up(vs[k]))));
  }
}

// A x~ and the dual update on band rows [i0, i1) (row i0 at Ar): warp w
// takes rows i0 + 4w .. +3, then i0 + 4(w + W) .., four at a time; lane
// l sums columns l, l + 32, ... of each; a reduce-scatter over the warp
// lands each row's total on its own 8 lanes, whose first does the dual
// update, so the four rows' updates run at once.
constexpr int kDotRows = 4;

template <typename TS, typename T>
__device__ __forceinline__ void dot_rows(const TS* __restrict__ Ar, int i0,
                                         int i1, int N, const T* xt, T* y,
                                         const T* rl, const T* rh, T* ysum,
                                         T sig, int warp, int lane) {
  constexpr int R = kDotRows;
  for (int b = i0 + R * warp; b < i1; b += R * kClusterWarps) {
    const TS* Ai = Ar + (size_t)(b - i0) * (size_t)N;
    const int nr = min(R, i1 - b);
    T acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = T(0);
#pragma unroll 2
    for (int j = lane; j < N; j += 32) {
      const T xj = xt[j];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < nr) acc[r] = mad(up(Ai[(size_t)r * (size_t)N + j]), xj, acc[r]);
    }
    int rr = 0;
    const T ax = reduce_scatter<T, R>(acc, lane, rr);
    const int i = b + rr;
    if ((lane & (32 / R - 1)) == 0 && rr < nr) {
      const T vi = add_rn(y[i], mul_rn(sig, ax));
      const T zc = clip(div_rn(vi, sig), rl[i], rh[i]);
      const T yn = sub_rn(vi, mul_rn(sig, zc));
      y[i] = yn;
      ysum[i] = add_rn(ysum[i], yn);
    }
  }
}

// A x~ and the dual update on the rows [i0, i1) of a streamed stage (at
// most kStageRows; row i0 at Ar): warp w sums the columns [w N / W,
// (w + 1) N / W) of every row, lane-strided; a reduce-scatter over the
// warp lands each row's partial on its own 4 lanes, the warps' partials
// meet in red (W x kStageRows), and thread r adds row r's in warp order
// and does its dual update.  Ends with the block synchronised.

template <typename TS, typename T>
__device__ __forceinline__ void dot_stage(const TS* __restrict__ Ar, int i0,
                                          int i1, int N, const T* xt, T* y,
                                          const T* rl, const T* rh, T* ysum,
                                          T* red, T sig, int warp, int lane,
                                          int tid) {
  constexpr int R = kStageRows;
  const int nr = i1 - i0;
  const int j0 = (int)((long long)warp * N / kClusterWarps);
  const int j1 = (int)((long long)(warp + 1) * N / kClusterWarps);
  T acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
#pragma unroll 2
  for (int j = j0 + lane; j < j1; j += 32) {
    const T xj = xt[j];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) acc[r] = mad(up(Ar[(size_t)r * (size_t)N + j]), xj, acc[r]);
  }
  int rr = 0;
  const T part = reduce_scatter<T, R>(acc, lane, rr);
  if ((lane & (32 / R - 1)) == 0) red[warp * R + rr] = part;
  __syncthreads();
  if (tid < nr) {
    T ax = red[tid];
#pragma unroll
    for (int w = 1; w < kClusterWarps; ++w) ax += red[w * R + tid];
    const int i = i0 + tid;
    const T vi = add_rn(y[i], mul_rn(sig, ax));
    const T zc = clip(div_rn(vi, sig), rl[i], rh[i]);
    const T yn = sub_rn(vi, mul_rn(sig, zc));
    y[i] = yn;
    ysum[i] = add_rn(ysum[i], yn);
  }
  __syncthreads();
}

// The carry: part[g N + j] (+)= sum over band rows i in [i0, i1) with
// i % G == g, of A[i][j] y[i] (row i0 at Ar), in four running sums over
// every fourth such row, added pairwise at the end; `first` starts the
// sums at 0.  Slot (g, j) belongs to one thread: with G > 1 (N below the
// block's threads) thread t owns slot t, else columns t, t + 256, ...
template <typename TS, typename T>
__device__ __forceinline__ void carry_slot(T* part, const TS* __restrict__ Ar,
                                           int i0, int i1, int N, int G,
                                           int g, int j, const T* y,
                                           bool first) {
  const int q = g * N + j;
  const size_t step = (size_t)G * (size_t)N;
  T a0 = first ? T(0) : part[q], a1 = T(0), a2 = T(0), a3 = T(0);
  int i = G == 1 ? i0 : i0 + ((g - i0 % G) + G) % G;
  const TS* a = Ar + (size_t)(i - i0) * (size_t)N + j;
  for (; i + 3 * G < i1; i += 4 * G, a += 4 * step) {
    a0 = mad(up(a[0]), y[i], a0);
    a1 = mad(up(a[step]), y[i + G], a1);
    a2 = mad(up(a[2 * step]), y[i + 2 * G], a2);
    a3 = mad(up(a[3 * step]), y[i + 3 * G], a3);
  }
  for (; i < i1; i += G, a += step) a0 = mad(up(a[0]), y[i], a0);
  part[q] = (a0 + a1) + (a2 + a3);
}

template <typename TS, typename T>
__device__ __forceinline__ void carry_rows(T* part, const TS* __restrict__ Ar,
                                           int i0, int i1, int N, int G,
                                           const T* y, bool first, int tid) {
  if (G == 1) {
#pragma unroll 2
    for (int j = tid; j < N; j += kClusterThreads)
      carry_slot<TS, T>(part, Ar, i0, i1, N, 1, 0, j, y, first);
  } else if (tid < G * N) {
    const int g = tid / N;
    carry_slot<TS, T>(part, Ar, i0, i1, N, G, g, tid - g * N, y, first);
  }
}

// One scenario per thread-block cluster of C blocks (cluster k holds
// scenario k).  Block r owns the band of rows [r M / C, (r + 1) M / C)
// and the column slice [r N / C, (r + 1) N / C).  Per step:
//   the cluster's partial A^T y meet: block r sums its slice over the C
//   peers' `part` in rank order (distributed shared memory) and does
//   the primal update there, writing x~ on its slice;
//   every block gathers the full x~ from its peers;
//   one pass over the band: A x~ and the dual update row by row, then
//   the carry A^T y(new) into `part` for the next step (skipped at the
//   last step; one carry-only pass before the first step forms A^T y0).
// Two cluster barriers a step; no atomics, so the sums are in a fixed
// order and the forms stay bit-equal.  SRC kResident holds the band in
// shared memory, loaded once per chunk; kStreamed streams it once per
// pass through a ring of kStages stages of `stage_rows` rows filled by
// asynchronous 16-byte copies.
template <typename TS, typename T, int SRC, int FORM>
__global__ void __launch_bounds__(kClusterThreads, 1)
pdhg_chunk_cluster(const TS* __restrict__ A, const int* __restrict__ drows,
                   const int* __restrict__ dcols,
                   const TS* __restrict__ dvals, int nnz,
                   const T* __restrict__ cs, const T* __restrict__ qs,
                   const T* __restrict__ lb, const T* __restrict__ ub,
                   const T* __restrict__ rlo, const T* __restrict__ rhi,
                   const T* __restrict__ x0, const T* __restrict__ y0,
                   const T* __restrict__ tau, const T* __restrict__ sigma,
                   T* __restrict__ xo, T* __restrict__ yo,
                   T* __restrict__ xso, T* __restrict__ yso, int M, int N,
                   int n_steps, int C, int stage_rows, int per_base) {
  constexpr int NT = kClusterThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int s = blockIdx.x / C;
  const int rank = blockIdx.x - s * C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (int)((long long)rank * M / C);
  const int mr = (int)((long long)(rank + 1) * M / C) - r0;
  const int c0 = (int)((long long)rank * N / C);
  const int c1 = (int)((long long)(rank + 1) * N / C);
  const int G = N < NT ? NT / N : 1;  // row groups of the carry
  const Layout L =
      cluster_layout(M, N, C, SRC, stage_rows, sizeof(T), sizeof(TS));

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + L.ring;
  T* xt = reinterpret_cast<T*>(smem_raw + L.state);
  T* part = xt + N;  // (G, N): this block's partial A^T y by row group
  T* x = part + (N > NT ? N : NT);
  T* c = x + L.nc;
  T* q = c + L.nc;
  T* l = q + L.nc;
  T* u = l + L.nc;
  T* xsum = u + L.nc;
  T* y = xsum + L.nc;
  T* rl = y + L.mb;
  T* rh = rl + L.mb;
  T* ysum = rh + L.mb;
  T* red = ysum + L.mb;  // the streamed dot's (W, kStageRows) partials
  TS* Ab = reinterpret_cast<TS*>(smem_raw + L.band);

  const size_t on = (size_t)s * N;
  const size_t om = (size_t)s * M + r0;
  for (int j = c0 + tid; j < c1; j += NT) {
    const int jl = j - c0;
    x[jl] = x0[on + j];
    c[jl] = cs[on + j];
    q[jl] = qs[on + j];
    l[jl] = lb[on + j];
    u[jl] = ub[on + j];
    xsum[jl] = T(0);
  }
  for (int i = tid; i < mr; i += NT) {
    y[i] = y0[om + i];
    rl[i] = rlo[om + i];
    rh[i] = rhi[om + i];
    ysum[i] = T(0);
  }
  // this block's band of its scenario's matrix (the shared and split
  // forms: of the matrix of the scenario's request, the one shared
  // matrix when per_base = S)
  const TS* Ag = A + (size_t)(FORM == kDense ? s : s / per_base) *
                         (size_t)M * (size_t)N +
                 (size_t)r0 * (size_t)N;
  const TS* vs = FORM == kSplit ? dvals + (size_t)s * (size_t)nnz : dvals;
  const int passes = n_steps > 0 ? n_steps + 1 : 0;
  const int n_chunks = SRC == kStreamed ? (mr + stage_rows - 1) / stage_rows
                                        : 1;
  const int total = passes * n_chunks;
  // a band that does not start or end on 16 bytes: stages get plain
  // copies of their head and tail
  const bool ragged =
      (((uintptr_t)Ag | ((uintptr_t)N * sizeof(TS))) & 15) != 0;

  // chunk k of the band (rows k R .. ) into its ring slot: the 16-byte
  // aligned middle by 16-byte asynchronous copies spread over the
  // block's threads, the ragged head and tail (under 16 bytes each) by
  // thread 0's plain copies; the rows start at byte (src & 15) of the
  // slot, so the middle lands 16-byte aligned.  Every thread calls it
  // and commits one group.
  auto fill = [&](int gidx) {
    const int k = gidx % n_chunks;
    const int slot = gidx % kStages;
    const int i0 = k * stage_rows;
    const int i1 = min(mr, i0 + stage_rows);
    const uintptr_t gs = (uintptr_t)(Ag + (size_t)i0 * (size_t)N);
    const uintptr_t ge = (uintptr_t)(Ag + (size_t)i1 * (size_t)N);
    unsigned char* dst = ring + (size_t)slot * L.stage_bytes + (gs & 15);
    const uintptr_t a0 = (gs + 15) & ~(uintptr_t)15;
    const uintptr_t a1 = ge & ~(uintptr_t)15;
    if (a1 <= a0) {
      if (tid == 0)
        copy_elements<TS>(reinterpret_cast<TS*>(dst),
                          reinterpret_cast<const TS*>(gs),
                          (int)((ge - gs) / sizeof(TS)));
      cp_async_commit();
      return;
    }
    if (ragged && tid == 0) {
      copy_elements<TS>(reinterpret_cast<TS*>(dst),
                        reinterpret_cast<const TS*>(gs),
                        (int)((a0 - gs) / sizeof(TS)));
      copy_elements<TS>(reinterpret_cast<TS*>(dst + (a1 - gs)),
                        reinterpret_cast<const TS*>(a1),
                        (int)((ge - a1) / sizeof(TS)));
    }
    const int n16 = (int)((a1 - a0) >> 4);
    unsigned char* mid = dst + (a0 - gs);
    for (int t = tid; t < n16; t += NT)
      cp_async16(mid + 16 * (size_t)t,
                 reinterpret_cast<const void*>(a0 + 16 * (uintptr_t)t));
    cp_async_commit();
  };

  if constexpr (SRC == kResident) {
    const size_t n = (size_t)mr * (size_t)N;
    for (size_t e = tid; e < n; e += NT) Ab[e] = Ag[e];
    // element e belongs to thread e % NT, which also copied it
    if constexpr (FORM == kSplit)
      patch_rows<TS, T>(Ab, 0, mr, N, drows, dcols, vs, nnz, r0, tid);
  } else {
    // kStages - 1 chunks in flight ahead of the one consumed
    for (int gidx = 0; gidx < kStages - 1; ++gidx) {
      if (gidx < total)
        fill(gidx);
      else
        cp_async_commit();
    }
  }
  __syncthreads();

  const T tau_s = tau[s];
  const T sig = sigma[s];
  // one pass over the band: A x~ and the dual update (dot), then the
  // carry into part (carry)
  auto pass = [&](int p, bool dot, bool carry) {
    if constexpr (SRC == kResident) {
      if (dot) {
        dot_rows<TS, T>(Ab, 0, mr, N, xt, y, rl, rh, ysum, sig, warp, lane);
        __syncthreads();
      }
      if (carry) carry_rows<TS, T>(part, Ab, 0, mr, N, G, y, true, tid);
    } else {
      for (int k = 0; k < n_chunks; ++k) {
        const int gidx = p * n_chunks + k;
        const int slot = gidx % kStages;
        const int i0 = k * stage_rows;
        const int i1 = min(mr, i0 + stage_rows);
        const uintptr_t gs = (uintptr_t)(Ag + (size_t)i0 * (size_t)N);
        TS* Ar = reinterpret_cast<TS*>(ring + (size_t)slot * L.stage_bytes +
                                       (gs & 15));
        // refill the slot the previous chunk left (every thread is past
        // it), then wait for this chunk's group
        if (gidx + kStages - 1 < total)
          fill(gidx + kStages - 1);
        else
          cp_async_commit();
        cp_async_wait();
        __syncthreads();
        if constexpr (FORM == kSplit) {
          patch_rows<TS, T>(Ar, i0, i1, N, drows, dcols, vs, nnz, r0, tid);
          __syncthreads();
        }
        if (dot)
          dot_stage<TS, T>(Ar, i0, i1, N, xt, y, rl, rh, ysum, red, sig, warp,
                           lane, tid);
        if (carry) {
          carry_rows<TS, T>(part, Ar, i0, i1, N, G, y, k == 0, tid);
          __syncthreads();
        }
      }
    }
  };
  auto cluster_sync = [&]() {
    if (C > 1)
      cluster.sync();
    else
      __syncthreads();
  };

  if (passes > 0) pass(0, false, true);  // A^T y0
  for (int step = 0; step < n_steps; ++step) {
    cluster_sync();  // every block's part is complete
    // primal update on this block's column slice
    for (int j = c0 + tid; j < c1; j += NT) {
      const int jl = j - c0;
      T aty = T(0);
      if (C == 1) {
        for (int g = 0; g < G; ++g)
          aty = g == 0 ? part[j] : add_rn(aty, part[g * N + j]);
      } else {
        // the peers' sums, four loads in flight at a time
        for (int p0 = 0; p0 < C; p0 += 4) {
          for (int g = 0; g < G; ++g) {
            T v[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (p0 + k < C)
                v[k] = *cluster.map_shared_rank(part + g * N + j, p0 + k);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (p0 + k < C)
                aty = (p0 + k == 0 && g == 0) ? v[k] : add_rn(aty, v[k]);
          }
        }
      }
      const T xj = x[jl];
      const T grad = add_rn(add_rn(c[jl], mul_rn(q[jl], xj)), aty);
      const T xn = clip(sub_rn(xj, mul_rn(tau_s, grad)), l[jl], u[jl]);
      xt[j] = sub_rn(mul_rn(T(2), xn), xj);
      x[jl] = xn;
      xsum[jl] = add_rn(xsum[jl], xn);
    }
    cluster_sync();  // every block's slice of x~ is complete
    if (C > 1) {
#pragma unroll 4
      for (int j = tid; j < N; j += NT)
        if (j < c0 || j >= c1)
          xt[j] = *cluster.map_shared_rank(xt + j, slice_owner(j, N, C));
      __syncthreads();
    }
    pass(step + 1, true, step + 1 < n_steps);
  }
  // no block leaves while a peer may still read its shared memory
  cluster_sync();

  for (int j = c0 + tid; j < c1; j += NT) {
    xo[on + j] = x[j - c0];
    xso[on + j] = xsum[j - c0];
  }
  for (int i = tid; i < mr; i += NT) {
    yo[om + i] = y[i];
    yso[om + i] = ysum[i];
  }
}

// dynamic shared memory of one block of the tiled kernel
// (ops/pdhg_chunk.py Variant.smem_bytes)
template <typename TS, typename T, int R, int V, int W, int FORM>
size_t smem_bytes(int M, int N) {
  const size_t RT = (size_t)R * W, CT = (size_t)128 * V;
  const size_t Mp = ((size_t)M + RT - 1) / RT * RT;
  const size_t Np = ((size_t)N + CT - 1) / CT * CT;
  size_t b = ((7 + (size_t)W) * Np + 4 * Mp) * sizeof(T);
  if (FORM == kSplit)
    b += (size_t)32 * W * R * V * 4 * sizeof(T);
  return b;
}

struct Args {
  const void *A, *rows, *cols, *vals;
  int nnz;
  const void *cs, *qs, *lb, *ub, *rlo, *rhi, *x, *y, *tau, *sigma;
  void *xo, *yo, *xso, *yso;
  int S, M, N, n_steps, per_base;
  cudaStream_t stream;
};

// Launch one variant of the tiled kernel, or (occupancy != nullptr)
// report its blocks per SM and the clusters of one block that fit on
// the card at these shapes.
template <typename TS, typename T, int R, int V, int W, int FORM, int MINB>
int run(const Args& g, int* occupancy) {
  auto kernel = pdhg_chunk_tiled<TS, T, R, V, W, FORM, MINB>;
  const size_t smem = smem_bytes<TS, T, R, V, W, FORM>(g.M, g.N);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occupancy != nullptr) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kernel, 32 * W, smem);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    occupancy[1] = occupancy[0] * sms;
    return (int)e;
  }
  const uintptr_t align = sizeof(TS) == 2 ? 8 : 16;
  const int vec = (g.N % 4 == 0) && ((uintptr_t)g.A % align == 0);
  kernel<<<g.S, 32 * W, smem, g.stream>>>(
      (const TS*)g.A, (const int*)g.rows, (const int*)g.cols,
      (const TS*)g.vals, g.nnz, (const T*)g.cs, (const T*)g.qs, (const T*)g.lb,
      (const T*)g.ub, (const T*)g.rlo, (const T*)g.rhi, (const T*)g.x,
      (const T*)g.y, (const T*)g.tau, (const T*)g.sigma, (T*)g.xo,
      (T*)g.yo, (T*)g.xso, (T*)g.yso, g.M, g.N, g.n_steps, vec, g.per_base);
  return (int)cudaGetLastError();
}

// Launch the cluster kernel in clusters of C blocks, or (occupancy !=
// nullptr) report its blocks per SM and the clusters of C blocks that
// the card holds at once (cudaOccupancyMaxActiveClusters).
template <typename TS, typename T, int SRC, int FORM>
int run_cluster(const Args& g, int C, int stage_rows, int* occupancy) {
  auto kernel = pdhg_chunk_cluster<TS, T, SRC, FORM>;
  if (C < 1 || C > kMaxCluster || g.S > 0x7fffffff / C)
    return (int)cudaErrorInvalidValue;
  if (SRC == kStreamed && (stage_rows < 1 || stage_rows > kStageRows))
    return (int)cudaErrorInvalidValue;
  const Layout L =
      cluster_layout(g.M, g.N, C, SRC, stage_rows, sizeof(T), sizeof(TS));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(g.S * C), 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = g.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occupancy != nullptr) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kernel, kClusterThreads, L.total);
    if (e != cudaSuccess) return (int)e;
    cfg.gridDim = dim3((unsigned)C, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(occupancy + 1, kernel, &cfg);
  }
  e = cudaLaunchKernelEx(
      &cfg, kernel, (const TS*)g.A, (const int*)g.rows, (const int*)g.cols,
      (const TS*)g.vals, g.nnz, (const T*)g.cs, (const T*)g.qs,
      (const T*)g.lb, (const T*)g.ub, (const T*)g.rlo, (const T*)g.rhi,
      (const T*)g.x, (const T*)g.y, (const T*)g.tau, (const T*)g.sigma,
      (T*)g.xo, (T*)g.yo, (T*)g.xso, (T*)g.yso, g.M, g.N, g.n_steps, C,
      stage_rows, g.per_base);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// (rows per thread R, column vectors per lane V, warps W, form of A, min
// blocks per SM for __launch_bounds__): the variants of the tiled
// kernel, A held in registers, that
// ops/pdhg_chunk.py::pick_variant and pick_route can choose, per compute
// type.  The register tile holds 32 values a thread: 64 registers in
// f32, so 4 blocks fit on an SM; 128 in f64, 2 blocks.
#define PDHG_F32_VARIANTS(X) \
  X(8, 1, 8, kDense, 4)      \
  X(8, 1, 8, kSharedA, 4)    \
  X(8, 1, 8, kSplit, 4)
#define PDHG_F64_VARIANTS(X) \
  X(8, 1, 8, kDense, 2)      \
  X(8, 1, 8, kSharedA, 2)    \
  X(8, 1, 8, kSplit, 2)
// (source of A, form of A): the cluster kernel's instantiations, per
// storage type.  The shared and split forms reach the resident source
// only through pick_route (a shared matrix that one block cannot hold
// takes the matmul route); the streamed instantiations of those forms
// serve measurement and tests (fused_chunk's `variant`).
#define PDHG_CLUSTER_VARIANTS(X) \
  X(kResident, kDense)           \
  X(kResident, kSharedA)         \
  X(kResident, kSplit)           \
  X(kStreamed, kDense)           \
  X(kStreamed, kSharedA)         \
  X(kStreamed, kSplit)

template <typename TS, typename T>
int dispatch(const Args& g, int form, int R, int V, int W, int src, int C,
             int stage_rows, int* occupancy) {
  if (g.S <= 0 || g.M <= 0 || g.N <= 0 || g.n_steps < 0 || g.nnz < 0 ||
      g.per_base <= 0 || g.S % g.per_base != 0)
    return (int)cudaErrorInvalidValue;
#define PDHG_TRY(r, v, w, fm, mb)                                     \
  if (R == r && V == v && W == w && src == kRegisters && form == fm)  \
    return run<TS, T, r, v, w, fm, mb>(g, occupancy);
  if constexpr (sizeof(T) == 4) {
    PDHG_F32_VARIANTS(PDHG_TRY)
  } else {
    PDHG_F64_VARIANTS(PDHG_TRY)
  }
#undef PDHG_TRY
#define PDHG_TRY_CLUSTER(sr, fm)                                        \
  if (src == sr && form == fm)                                          \
    return run_cluster<TS, T, sr, fm>(g, C, stage_rows, occupancy);
  PDHG_CLUSTER_VARIANTS(PDHG_TRY_CLUSTER)
#undef PDHG_TRY_CLUSTER
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* A, const void* rows, const void* cols,
               const void* vals, int nnz, const void* cs, const void* qs,
               const void* lb, const void* ub, const void* rlo,
               const void* rhi, const void* x, const void* y,
               const void* tau, const void* sigma, void* xo, void* yo,
               void* xso, void* yso, int S, int M, int N, int n_steps,
               int per_base, void* stream) {
  return Args{A,   rows, cols, vals, nnz, cs,  qs,      lb,       ub,
              rlo, rhi,  x,    y,    tau, sigma, xo,    yo,       xso,
              yso, S,    M,    N,    n_steps, per_base, (cudaStream_t)stream};
}

}  // namespace

extern "C" {

// A (or the split form's shared block), rows, cols, vals, nnz, form
// (0 dense, 1 shared, 2 split), the scenarios that read one matrix of
// the shared and split forms' A (per_base: S for one matrix; the dense
// form does not read it), the vectors, the outputs, the sizes, the
// variant (R, V, W of the tiled kernel; source 0 registers, 1 resident,
// 2 streamed; cluster size and stage rows of the cluster kernel) and
// the stream.
#define PDHG_ENTRY(name, TS, T)                                              \
  int name(const void* A, const void* rows, const void* cols,               \
           const void* vals, int nnz, int form, int per_base,               \
           const void* cs,                                                  \
           const void* qs, const void* lb, const void* ub, const void* rlo, \
           const void* rhi, const void* x, const void* y, const void* tau,  \
           const void* sigma, void* xo, void* yo, void* xso, void* yso,     \
           int S, int M, int N, int n_steps, int R, int V, int W, int src,  \
           int C, int stage_rows, void* stream) {                           \
    return dispatch<TS, T>(                                                 \
        make_args(A, rows, cols, vals, nnz, cs, qs, lb, ub, rlo, rhi, x, y, \
                  tau, sigma, xo, yo, xso, yso, S, M, N, n_steps, per_base, \
                  stream),                                                  \
        form, R, V, W, src, C, stage_rows, nullptr);                        \
  }

PDHG_ENTRY(pdhg_chunk_f32, float, float)
PDHG_ENTRY(pdhg_chunk_f64, double, double)
PDHG_ENTRY(pdhg_chunk_bf16, __nv_bfloat16, float)
#undef PDHG_ENTRY

// Occupancy of a variant and form at (M, N) for storage kind 0 (f32),
// 1 (f64) or 2 (bf16): out[0] blocks per SM, out[1] the clusters (of C
// blocks; of one block for the tiled kernel) the card holds at once.
// Returns 0 or the CUDA error code.
int pdhg_chunk_occupancy(int kind, int form, int R, int V, int W, int src,
                         int M, int N, int C, int stage_rows, int* out) {
  const Args g = make_args(nullptr, nullptr, nullptr, nullptr, 0, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, 1, M, N, 0, 1, nullptr);
  out[0] = out[1] = 0;
  int rc = (int)cudaErrorInvalidValue;
  if (kind == 0)
    rc = dispatch<float, float>(g, form, R, V, W, src, C, stage_rows, out);
  if (kind == 1)
    rc = dispatch<double, double>(g, form, R, V, W, src, C, stage_rows, out);
  if (kind == 2)
    rc = dispatch<__nv_bfloat16, float>(g, form, R, V, W, src, C, stage_rows,
                                        out);
  return rc;
}

// The per-block shared-memory limit a kernel may opt in to (bytes), or
// -1 when the device cannot be queried.
int pdhg_chunk_smem_optin(void) {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return optin;
}

}  // extern "C"
