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
// Inputs are solver-space (already Ruiz-scaled) and contiguous: A (S, M,
// N); cs, qs, lb, ub, x (S, N); rlo, rhi, y (S, M); tau, sigma (S,).
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
//   * (R, V, W) and the source of A are template parameters.  Shapes
//     beyond the register tile (64 x 128) run the same decomposition,
//     looping over tiles, with A in shared memory, or in global memory
//     when that does not fit.  `ops/pdhg_chunk.py::pick_variant` chooses
//     the variant from (M, N, dtype); PDHG_*_VARIANTS below are exactly
//     the variants it can choose.
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
// Nothing is allocated here: the caller passes the outputs.  Each entry
// point returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// where the matvecs read A from
enum Src : int { kRegisters = 0, kShared = 1, kGlobal = 2 };

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

template <typename TS, typename T, int R, int V, int W, int SRC, int MINB>
__global__ void __launch_bounds__(W * 32, MINB)
pdhg_chunk_tiled(const TS* __restrict__ A, const T* __restrict__ cs,
                 const T* __restrict__ qs, const T* __restrict__ lb,
                 const T* __restrict__ ub, const T* __restrict__ rlo,
                 const T* __restrict__ rhi, const T* __restrict__ x0,
                 const T* __restrict__ y0, const T* __restrict__ tau,
                 const T* __restrict__ sigma, T* __restrict__ xo,
                 T* __restrict__ yo, T* __restrict__ xso,
                 T* __restrict__ yso, int M, int N, int n_steps, int vec) {
  constexpr int NT = 32 * W;
  constexpr int RT = R * W;    // rows of one tile
  constexpr int CT = 128 * V;  // columns of one tile
  const int Mp = (M + RT - 1) / RT * RT;
  const int Np = (N + CT - 1) / CT * CT;
  const int n_rt = SRC == kRegisters ? 1 : Mp / RT;
  const int n_ct = SRC == kRegisters ? 1 : Np / CT;

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
  TS* As = reinterpret_cast<TS*>(red + W * Np);  // (M, N), kShared only

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
  const TS* Ag = A + (size_t)s * (size_t)M * (size_t)N;
  if constexpr (SRC == kShared) {
    const size_t MN = (size_t)M * (size_t)N;
    for (size_t k = tid; k < MN; k += NT) As[k] = Ag[k];
  }
  const TS* Ak = SRC == kShared ? As : Ag;
  const T tau_s = tau[s];
  const T sig = sigma[s];
  const int row0 = warp * R;
  const bool vec_ok = vec != 0;

  T a[R][V][4];
  if constexpr (SRC == kRegisters)
    load_tile<TS, T, R, V>(a, Ag, M, N, row0, 0, lane, vec_ok);
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    // A^T y: this warp's partial column sums -> red[warp][:]
    for (int ct = 0; ct < n_ct; ++ct) {
      T acc[V][4];
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[v][k] = T(0);
      for (int rt = 0; rt < n_rt; ++rt) {
        if constexpr (SRC != kRegisters)
          load_tile<TS, T, R, V>(a, Ak, M, N, rt * RT + row0, ct * CT, lane,
                                 vec_ok);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T yr = y[rt * RT + row0 + r];
#pragma unroll
          for (int v = 0; v < V; ++v)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[v][k] = mad(a[r][v][k], yr, acc[v][k]);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        store4(red + warp * Np + ct * CT + 4 * (lane + 32 * v), acc[v]);
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
    for (int rt = 0; rt < n_rt; ++rt) {
      T acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = T(0);
      for (int ct = 0; ct < n_ct; ++ct) {
        if constexpr (SRC != kRegisters)
          load_tile<TS, T, R, V>(a, Ak, M, N, rt * RT + row0, ct * CT, lane,
                                 vec_ok);
        T xv[V][4];
#pragma unroll
        for (int v = 0; v < V; ++v)
          load4(xt + ct * CT + 4 * (lane + 32 * v), xv[v]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int v = 0; v < V; ++v)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[r] = mad(a[r][v][k], xv[v][k], acc[r]);
      }
      int rr = 0;
      const T ax = reduce_scatter<T, R>(acc, lane, rr);
      const int i = rt * RT + row0 + rr;
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

// dynamic shared memory of one block (ops/pdhg_chunk.py Variant.smem_bytes)
template <typename TS, typename T, int R, int V, int W, int SRC>
size_t smem_bytes(int M, int N) {
  const size_t RT = (size_t)R * W, CT = (size_t)128 * V;
  const size_t Mp = ((size_t)M + RT - 1) / RT * RT;
  const size_t Np = ((size_t)N + CT - 1) / CT * CT;
  size_t b = ((7 + (size_t)W) * Np + 4 * Mp) * sizeof(T);
  if (SRC == kShared) b += (size_t)M * (size_t)N * sizeof(TS);
  return b;
}

struct Args {
  const void *A, *cs, *qs, *lb, *ub, *rlo, *rhi, *x, *y, *tau, *sigma;
  void *xo, *yo, *xso, *yso;
  int S, M, N, n_steps;
  cudaStream_t stream;
};

// Launch one variant, or (occupancy != nullptr) report how many of its
// blocks fit on one SM at these shapes.
template <typename TS, typename T, int R, int V, int W, int SRC, int MINB>
int run(const Args& g, int* occupancy) {
  auto kernel = pdhg_chunk_tiled<TS, T, R, V, W, SRC, MINB>;
  const size_t smem = smem_bytes<TS, T, R, V, W, SRC>(g.M, g.N);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (occupancy != nullptr)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, kernel, 32 * W, smem);
  const uintptr_t align = sizeof(TS) == 2 ? 8 : 16;
  const int vec = (g.N % 4 == 0) && ((uintptr_t)g.A % align == 0);
  kernel<<<g.S, 32 * W, smem, g.stream>>>(
      (const TS*)g.A, (const T*)g.cs, (const T*)g.qs, (const T*)g.lb,
      (const T*)g.ub, (const T*)g.rlo, (const T*)g.rhi, (const T*)g.x,
      (const T*)g.y, (const T*)g.tau, (const T*)g.sigma, (T*)g.xo,
      (T*)g.yo, (T*)g.xso, (T*)g.yso, g.M, g.N, g.n_steps, vec);
  return (int)cudaGetLastError();
}

// (rows per thread R, column vectors per lane V, warps W, source of A,
// min blocks per SM for __launch_bounds__): the variants that
// ops/pdhg_chunk.py::pick_variant can choose, per compute type.  The
// register tile holds 32 values a thread: 64 registers in f32, so 4
// blocks fit on an SM; 128 in f64, 2 blocks.
#define PDHG_F32_VARIANTS(X) \
  X(8, 1, 8, kRegisters, 4)  \
  X(4, 1, 8, kShared, 2)     \
  X(4, 1, 8, kGlobal, 2)
#define PDHG_F64_VARIANTS(X) \
  X(8, 1, 8, kRegisters, 2)  \
  X(4, 1, 8, kShared, 2)     \
  X(4, 1, 8, kGlobal, 2)

template <typename TS, typename T>
int dispatch(const Args& g, int R, int V, int W, int src, int* occupancy) {
  if (g.S <= 0 || g.M <= 0 || g.N <= 0 || g.n_steps < 0)
    return (int)cudaErrorInvalidValue;
#define PDHG_TRY(r, v, w, sr, mb)                    \
  if (R == r && V == v && W == w && src == sr)       \
    return run<TS, T, r, v, w, sr, mb>(g, occupancy);
  if constexpr (sizeof(T) == 4) {
    PDHG_F32_VARIANTS(PDHG_TRY)
  } else {
    PDHG_F64_VARIANTS(PDHG_TRY)
  }
#undef PDHG_TRY
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* A, const void* cs, const void* qs, const void* lb,
               const void* ub, const void* rlo, const void* rhi,
               const void* x, const void* y, const void* tau,
               const void* sigma, void* xo, void* yo, void* xso, void* yso,
               int S, int M, int N, int n_steps, void* stream) {
  return Args{A,  cs, qs, lb,  ub,  rlo, rhi, x, y, tau, sigma, xo,
              yo, xso, yso, S, M, N, n_steps, (cudaStream_t)stream};
}

}  // namespace

extern "C" {

#define PDHG_ENTRY(name, TS, T)                                              \
  int name(const void* A, const void* cs, const void* qs, const void* lb,   \
           const void* ub, const void* rlo, const void* rhi, const void* x, \
           const void* y, const void* tau, const void* sigma, void* xo,     \
           void* yo, void* xso, void* yso, int S, int M, int N,             \
           int n_steps, int R, int V, int W, int src, void* stream) {       \
    return dispatch<TS, T>(make_args(A, cs, qs, lb, ub, rlo, rhi, x, y,     \
                                     tau, sigma, xo, yo, xso, yso, S, M, N, \
                                     n_steps, stream),                      \
                           R, V, W, src, nullptr);                          \
  }

PDHG_ENTRY(pdhg_chunk_f32, float, float)
PDHG_ENTRY(pdhg_chunk_f64, double, double)
PDHG_ENTRY(pdhg_chunk_bf16, __nv_bfloat16, float)
#undef PDHG_ENTRY

// Resident blocks per SM of a variant at (M, N) for storage kind 0 (f32),
// 1 (f64) or 2 (bf16); a negative CUDA error code on failure.
int pdhg_chunk_occupancy(int kind, int R, int V, int W, int src, int M,
                         int N) {
  const Args g = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, nullptr, 1, M,
                           N, 0, nullptr);
  int blocks = 0;
  int rc = (int)cudaErrorInvalidValue;
  if (kind == 0) rc = dispatch<float, float>(g, R, V, W, src, &blocks);
  if (kind == 1) rc = dispatch<double, double>(g, R, V, W, src, &blocks);
  if (kind == 2) rc = dispatch<__nv_bfloat16, float>(g, R, V, W, src, &blocks);
  return rc == 0 ? blocks : -rc;
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
