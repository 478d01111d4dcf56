// Hand-written Hopper (sm_90a) kernels for the def-CG and LSMR hot paths.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels/cg_fused.py:
//
//   fused_cg_update          <- fused_cg_update_pallas          (cg_fused.py:122)
//   fused_rz_reduce          <- fused_rz_reduce_pallas          (cg_fused.py:252)
//   fused_deflate_direction  <- fused_deflate_direction_pallas  (cg_fused.py:426)
//   self_gram                <- self_gram_pallas                (cg_fused.py:558)
//   recombine_blocks         <- recombine_blocks_pallas         (cg_fused.py:639)
//   lsmr_update              <- lsmr_update_pallas              (cg_fused.py:336)
//
// All six are bound by device-memory bytes on the H100 (a few flops per
// element read), so each reads every input element once and writes every
// output element once.  The Pallas kernels carry reductions across a
// sequential grid in SMEM; here blocks run in no order, so a reduction sums
// per-block partials in a fixed order: fused_cg_update and fused_rz_reduce
// in their own launch (the block that draws the last ticket of an integer
// counter sums them, in block order), self_gram in a second kernel.  No
// float atomics: a grid repeats bit for bit.  Ragged tails are masked
// in-kernel (the TPU wrappers pad to (rows*128) tiles instead).
//
// fused_cg_update, fused_rz_reduce, fused_deflate_direction and lsmr_update
// each have a second arm, a piece of the iteration's TAIL: besides the
// vector work the launch carries the solver's scalar recurrence (def-CG's
// breakdown test, alpha, beta, mu, the residual norm, the status, the trace
// slot, the iteration count and the next step's active flag; with a
// preconditioner beta, mu and the recorded alpha / beta after z = M^-1 r;
// the p select and the recording slot of the direction update; LSMR's
// Givens rotations, its exact-termination latch and the same bookkeeping)
// and the frozen-step mask, which the solver loops would otherwise run as
// small eager launches around the kernels.  Every scalar of a tail is
// rounded as the eager PyTorch op it replaces rounds it (one intrinsic with
// round-to-nearest per op: nvcc would fuse a*a + b*b into an FMA), so the
// card's scalars are bit for bit those of the plain versions beside the
// wrappers.  fused_rz_reduce has a third arm, the sharded def-CG's pair of
// reductions in one read.  lsmr_update's stall detector is compiled into
// its armed step arm only (a STALL template argument), so its window 0 runs
// the code it ran without one; fused_cg_update's is a runtime branch on the
// window, so both of its arms run the one kernel.
//
// The step arms of fused_cg_update, fused_rz_reduce,
// fused_deflate_direction and lsmr_update have a lane axis for batched
// solves: B independent steps in one launch (gridDim.y = B; the *_lanes
// kernels).
// Lane blockIdx.y moves every pointer to its own data (per-lane scalars at
// any lane stride, passed in a lane-only argument), takes the loads and
// the block count a one-lane launch on its data would take, and runs the
// one-lane body, so each lane's sums and scalars are bit for bit a
// one-lane launch's.
//
// Plain C interface: every entry point returns cudaGetLastError() (0 = ok)
// and launches on the stream it is given.  Scratch and outputs are allocated
// by the caller.  Accumulation is in the working type (f64 stays f64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;          // deflation basis rows (k)
constexpr int kMaxGramRows = 128;  // rows of the stacked window S = [Z; AZ]

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The per-thread sums acc of a block, summed over the block in a fixed order
// and written to row blockIdx.x of a (blocks, width) partials buffer.  acc
// holds Q groups of KMAX + 1 sums of which the first k + 1 are used; the
// used ones go to columns q (k + 1) + j, so width = Q (k + 1).  Every one
// of the N shuffle trees runs (the unused columns hold zeros), so they
// interleave without a branch per column.
template <typename T, int Q, int KMAX>
__device__ __forceinline__ void store_block_partials(const T (&acc)[Q * (KMAX + 1)], int k,
                                                     T* __restrict__ partials) {
  constexpr int N = Q * (KMAX + 1);
  __shared__ T warp_part[N][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T v = warp_sum(acc[j]);
    if (lane == 0) warp_part[j][warp] = v;
  }
  __syncthreads();
  const int width = Q * (k + 1);
  if ((int)threadIdx.x < width) {
    const int q = threadIdx.x / (k + 1);
    const int j = threadIdx.x - q * (k + 1);
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += warp_part[q * (KMAX + 1) + j][w];
    partials[(int64_t)blockIdx.x * width + threadIdx.x] = s;
  }
}

// The one-launch reduction of K1 and K6 over `blocks` blocks (gridDim.x of
// a one-lane launch; a lane's own count on the lane axis, whose grid is as
// wide as its widest lane).  Every block writes its partials,
// then takes an integer ticket; `after_ticket` runs between the ticket and
// the block's learning whether it drew the last one (K1 stores its last
// chunk there, so the partials' fence waits on no vector store).  The block
// that draws the last ticket sums each column over the blocks in block
// order into col[0 .. Q (k + 1)) (shared memory): lane l takes blocks l,
// l + 32, ..., kLoads of them in flight at once, then the shuffle tree.
// Returns true in every thread of that block, with col visible to all of
// them; the caller resets the counter.  No float atomics: a grid repeats
// bit for bit.
template <typename T, int Q, int KMAX, typename AfterTicket>
__device__ __forceinline__ bool ticket_sums(const T (&acc)[Q * (KMAX + 1)], int k,
                                            T* __restrict__ partials, unsigned* counter,
                                            int blocks, T* col, AfterTicket after_ticket) {
  store_block_partials<T, Q, KMAX>(acc, k, partials);
  const int width = Q * (k + 1);
  __shared__ bool last;
  if ((int)threadIdx.x < width) __threadfence();  // the partials' writers
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)blocks - 1;
  after_ticket();
  __syncthreads();
  if (!last) return false;
  __threadfence();
  constexpr int kLoads = 8;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int cc = warp; cc < width; cc += kWarps) {
    T sum = T(0);
    for (int b0 = 0; b0 < blocks; b0 += 32 * kLoads) {
      T v[kLoads];
#pragma unroll
      for (int q = 0; q < kLoads; ++q) {
        const int b = b0 + 32 * q + lane;
        v[q] = b < blocks ? __ldcg(partials + (int64_t)b * width + cc) : T(0);
      }
#pragma unroll
      for (int q = 0; q < kLoads; ++q) sum += v[q];
    }
    sum = warp_sum(sum);
    if (lane == 0) col[cc] = sum;
  }
  __syncthreads();
  return true;
}

// The codes of repro_torch.core.engine.SolveStatus that the tails write.
constexpr int kBreakdownNonfinite = 2;
constexpr int kBreakdownIndefinite = 3;
constexpr int kStagnated = 4;
// The stall detector's bar (kernels/cg_fused.py: STAGNATION_RTOL).
constexpr double kStagnationRtol = 0.99;

// One rounding per operation, as one eager PyTorch op on 0-d tensors.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ bool finite(double a) { return isfinite(a); }
__device__ __forceinline__ bool finite(float a) { return isfinite(a); }
// torch.minimum: a NaN in either operand is the result (fmin would drop it).
template <typename T>
__device__ __forceinline__ T minimum_nan(T a, T b) {
  return a != a ? a : b != b ? b : (b < a ? b : a);
}

// One step of the stall detector (kernels/cg_fused.py: stagnation_update),
// on the step's fresh residual norm: the best residual and the stall count
// move on an active step only, and STAGNATED is latched into the sticky
// fail once the best has not fallen below kStagnationRtol of itself for
// `window` active steps.  The bar rounds as the eager 0.99 * best.
template <typename T>
__device__ __forceinline__ void stagnation_step(T best, int stall, T norm_new, bool active,
                                                int window, int* fail, T* best_out,
                                                int* stall_out) {
  const bool improved = norm_new < mul_rn(T(kStagnationRtol), best);
  const int stall_new = improved ? 0 : stall + 1;
  if (*fail == 0 && active && stall_new >= window) *fail = kStagnated;
  *best_out = active ? minimum_nan(best, norm_new) : best;
  *stall_out = active ? stall_new : stall;
}
// torch.where(v == 0, 1, v): the guarded divisor of the solver loops.
template <typename T>
__device__ __forceinline__ T nonzero(T v) {
  return v == T(0) ? T(1) : v;
}

// 16-byte loads and stores: two doubles or four floats.
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Blocks of `kernel` (kThreads threads, no dynamic shared memory) that the
// whole card holds at once, from the occupancy API: the largest grid of a
// grid-stride kernel whose blocks all start at once.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return err;
}

// min(resident, cdiv(units, kThreads), cap), at least 1.
inline int stride_grid(int resident, int64_t units, int cap) {
  int64_t g = (units + kThreads - 1) / kThreads;
  if (g > resident) g = resident;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

// ---------------------------------------------------------------------------
// fused_cg_update: x + a p, r - a ap, |r_new|^2, AW r_new -- and def-CG's tail
// ---------------------------------------------------------------------------
//
// One launch.  Bound by bytes: (6 + k) n elements move for (6 + 2k) n flops
// (n = 36 551, k = 8, f64: 4.1 MB, 1.2 us at 3.35 TB/s).  At the main path's
// n that is a few microseconds of work, so the design is about latency: up
// to as many blocks as the card holds at once (occupancy API), each thread
// with four elements (two 16-byte groups where every row is aligned; half
// that past k = 8) loaded before any is used and before the scalars are
// formed; each block writes its k + 1 partial sums, takes an integer
// ticket, and the block that draws the last ticket sums the partials of
// every block in block order (all its loads in flight at once) and resets
// the counter.  The last chunk's results are stored after the ticket, so
// the partials' fence waits on no vector store.  The partials and the
// counter are allocated once by the wrapper and reused; a grid repeats bit
// for bit.
//
// The TAIL arm is def-CG's iteration around the update (solvers.py, defcg's
// step).  Prologue, every block alike, from the device scalars d = p^T Ap,
// rs, rnorm, diverged_at, active and fail: the breakdown code
// (engine.classify_breakdown) and alpha = (bad | !active) ? 0 : rs / d; a
// poisoned Ap is read as 0 and, only then, zeroed in place.  Epilogue, in
// the last block: rr, and with `recurrence` (no preconditioner) beta =
// rr / safe(rs) and mu = waw_inv (AW r) (lane i sums row i in column order),
// the recorded alpha / beta rows; then sqrt(rr), the status, rnorm, the
// trace slot, j, the next step's active flag and keep = active & !bad (the
// p select).  Outputs go to fresh buffers: so = [rr, rnorm, alpha, beta,
// mu], jo = [j, fail], bo = [active, keep].

// The step arms' lane axis (gridDim.y lanes, launched by the *_lanes
// kernels only, so a one-lane launch takes the one-lane arguments alone):
// elements between two lanes' per-lane scalars (ls, in each arm's order),
// rows between two lanes' partials, and the block counts of a lane that
// takes 16-byte or element loads.  Vectors are (lanes, n), bases (lanes, k,
// n), recording buffers (lanes, ell + 1, n).
struct Lanes {
  int64_t ls[8];
  int64_t partials;
  int blocks_vec;
  int blocks_elem;
};

template <typename T>
struct CgArgs {
  const T* x;
  const T* r;
  const T* p;
  T* ap;  // zeroed in place by a tail that finds a breakdown
  const T* aw;
  int k;
  int64_t n;
  T* xo;
  T* ro;
  T* partials;
  unsigned* counter;
  // the TPU function's arm
  const T* alpha;
  T* rr;
  T* awr;
  // the tail's arm
  const T* d;
  const T* rs;
  const T* rnorm;
  const T* threshold;
  const T* diverged_at;
  const int* js;  // [j, fail]
  const bool* active;
  const T* waw_inv;  // (k, k)
  int64_t maxiter;
  int recurrence;
  T* trace;
  T* a_rows;
  T* b_rows;
  int row;  // < 0: not a recording step
  int ell;
  int window;     // > 0: the stall detector is armed (js = [j, fail, stall])
  const T* best;  // its best residual; best' goes to so[4 + k]
  T* so;
  int* jo;
  bool* bo;
};

enum CgLaneScalar { kLsD, kLsRs, kLsRnorm, kLsThreshold, kLsDiverged, kLsJs, kLsActive, kLsBest };

// Lane blockIdx.y of the step arm's lane axis: every pointer moved to its
// lane, so a lane's blocks run the one-lane arm on that lane's data (same
// grid along x, same sums in the same order).
template <typename T>
__device__ __forceinline__ CgArgs<T> cg_lane(CgArgs<T> a, const Lanes& l) {
  const int64_t lane = blockIdx.y;
  if (lane == 0) return a;
  const int64_t n = a.n, k = a.k, armed = a.window > 0;
  const int64_t v = lane * n;
  a.x += v;
  a.r += v;
  a.p += v;
  a.ap += v;
  a.xo += v;
  a.ro += v;
  if (a.aw != nullptr) a.aw += lane * k * n;
  if (a.waw_inv != nullptr) a.waw_inv += lane * k * k;
  a.partials += lane * l.partials;
  a.counter += lane;
  a.d += lane * l.ls[kLsD];
  a.rs += lane * l.ls[kLsRs];
  a.rnorm += lane * l.ls[kLsRnorm];
  a.threshold += lane * l.ls[kLsThreshold];
  a.diverged_at += lane * l.ls[kLsDiverged];
  a.js += lane * l.ls[kLsJs];
  a.active += lane * l.ls[kLsActive];
  if (a.best != nullptr) a.best += lane * l.ls[kLsBest];
  if (a.trace != nullptr) a.trace += lane * (a.maxiter + 2);
  if (a.a_rows != nullptr) {
    a.a_rows += lane * (a.ell + 1);
    a.b_rows += lane * (a.ell + 1);
  }
  a.so += lane * (4 + k + armed);
  a.jo += lane * (2 + armed);
  a.bo += lane * 2;
  return a;
}

// Elements a thread loads at once: two 16-byte groups, or four elements
// (half that past k = 8 rows of AW, where the registers run out).
template <typename T, int KMAX, bool VEC>
struct CgLayout {
  static constexpr int kWidth = VEC ? kVec<T> : 1;                // elements a slot
  static constexpr int kSlots = (VEC ? 2 : 4) / (KMAX > 8 ? 2 : 1);  // slots a thread
};

template <typename T, int W>
__device__ __forceinline__ void load_slot(const T* p, T (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = *p;
  } else {
    load16(p, v);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_slot(T* p, const T (&v)[W]) {
  if constexpr (W == 1) {
    *p = v[0];
  } else {
    store16(p, v);
  }
}

// One thread's share of a grid-stride step: kSlots slots of kWidth
// elements, slot s at unit base + s * kThreads + threadIdx.x (a unit is a
// slot's first element / kWidth), every vector and row of AW loaded before
// any is used.
template <typename T, int KMAX, bool VEC>
struct CgChunk {
  static constexpr int S = CgLayout<T, KMAX, VEC>::kSlots;
  static constexpr int W = CgLayout<T, KMAX, VEC>::kWidth;
  T x[S][W], r[S][W], p[S][W], ap[S][W], aw[KMAX > 0 ? KMAX : 1][S][W];
  bool ok[S];

  __device__ __forceinline__ void load(const CgArgs<T>& a, int64_t base, int64_t units) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int64_t u = base + s * kThreads + threadIdx.x;
      ok[s] = u < units;
      const int64_t i = ok[s] ? u * W : 0;
      load_slot(a.x + i, x[s]);
      load_slot(a.r + i, r[s]);
      load_slot(a.p + i, p[s]);
      load_slot(a.ap + i, ap[s]);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < a.k) load_slot(a.aw + (int64_t)j * a.n + i, aw[j][s]);
      }
    }
  }
};

// `blocks` is unsigned, as gridDim.x is: an int block count, sign-extended
// into the 64-bit stride, took K1's element-load step kernel from 160 to
// 171 registers and 0.2-0.4 us on the H100.
template <typename T, int KMAX, bool VEC, bool TAIL>
__device__ __forceinline__ void cg_update_body(const CgArgs<T>& a, unsigned blocks) {
  using L = CgLayout<T, KMAX, VEC>;
  constexpr int S = L::kSlots, W = L::kWidth;
  const int k = a.k;
  const int64_t n = a.n;
  const int64_t units = n / W;
  const int64_t stride = (int64_t)blocks * kThreads * S;
  int64_t base = (int64_t)blockIdx.x * kThreads * S;

  // The first step's vectors are in flight before the scalars are formed.
  CgChunk<T, KMAX, VEC> c;
  c.load(a, base, units);

  // Every scalar the launch reads, loaded once, together.
  T alpha, rs = T(0), rnorm_in = T(0), threshold = T(0);
  bool bad = false, active = true;
  int code = 0, j0 = 0, fail0 = 0;
  if constexpr (TAIL) {
    const T d = *a.d;
    const T diverged_at = *a.diverged_at;
    rs = *a.rs;
    rnorm_in = *a.rnorm;
    threshold = *a.threshold;
    active = *a.active;
    j0 = a.js[0];
    fail0 = a.js[1];
    const bool nonfinite = !finite(d);
    const bool indefinite = !nonfinite && d <= T(0);
    bad = nonfinite || indefinite || rnorm_in > diverged_at;
    code = !bad ? 0 : nonfinite ? kBreakdownNonfinite
                                : indefinite ? kBreakdownIndefinite : kStagnated;
    alpha = (bad || !active) ? T(0) : div_rn(rs, d);
  } else {
    alpha = *a.alpha;
  }
  T acc[KMAX + 1];
#pragma unroll
  for (int j = 0; j <= KMAX; ++j) acc[j] = T(0);

  // A step's results wait in registers until the next step's loads are
  // issued; the last step's, until after the ticket, so the partials'
  // fence does not wait for them.
  T xn[S][W], rn[S][W];
  int64_t done_base = -1;
  auto store_done = [&]() {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (done_base < 0 || !c.ok[s]) continue;
      const int64_t i = (done_base + s * kThreads + threadIdx.x) * W;
      store_slot(a.xo + i, xn[s]);
      store_slot(a.ro + i, rn[s]);
      if (bad) store_slot(a.ap + i, c.ap[s]);
    }
  };
  for (bool first = true; base < units; base += stride, first = false) {
    if (!first) {
      store_done();
      c.load(a, base, units);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!c.ok[s]) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (bad) c.ap[s][w] = T(0);
        rn[s][w] = c.r[s][w] - alpha * c.ap[s][w];
        xn[s][w] = c.x[s][w] + alpha * c.p[s][w];
        acc[0] += rn[s][w] * rn[s][w];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) acc[j + 1] += c.aw[j][s][w] * rn[s][w];
        }
      }
    }
    done_base = base;
  }
  // The ragged tail of the 16-byte path: fewer than kWidth elements.
  const int64_t tail = (int64_t)blockIdx.x * kThreads + threadIdx.x + units * W;
  if (VEC && tail < n) {
    T api = a.ap[tail];
    if (bad) {
      api = T(0);
      a.ap[tail] = T(0);
    }
    const T rn = a.r[tail] - alpha * api;
    a.xo[tail] = a.x[tail] + alpha * a.p[tail];
    a.ro[tail] = rn;
    acc[0] += rn * rn;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) acc[j + 1] += a.aw[(int64_t)j * n + tail] * rn;
    }
  }

  // (W^T AW)^-1, which the last block's epilogue reads, in flight before the ticket.
  T winv = T(0);
  if (TAIL && a.recurrence && (int)threadIdx.x < k * k) winv = a.waw_inv[threadIdx.x];

  // Partials, then the ticket: the block that draws the last one sums them.
  __shared__ T col[KMAX + 1];
  if (!ticket_sums<T, 1, KMAX>(acc, k, a.partials, a.counter, (int)blocks, col, store_done)) {
    return;
  }
  if (threadIdx.x == 0) *a.counter = 0u;
  if constexpr (TAIL) {
    __shared__ T winv_s[kMaxK * kMaxK];
    if ((int)threadIdx.x < k * k) winv_s[threadIdx.x] = winv;
    __syncthreads();
    const T rr = col[0];
    const T beta = a.recurrence ? div_rn(rr, nonzero(rs)) : T(0);
    if (a.recurrence && (int)threadIdx.x < k) {
      T m = T(0);
      for (int j = 0; j < k; ++j) m = add_rn(m, mul_rn(winv_s[threadIdx.x * k + j], col[j + 1]));
      a.so[4 + threadIdx.x] = m;
    }
    if (threadIdx.x == 0) {
      int fail = fail0;
      if (fail == 0 && active) fail = code;
      const T rnorm_new = sqrt_rn(rr);
      if (fail == 0 && active && !finite(rnorm_new)) fail = kBreakdownNonfinite;
      if (a.window > 0) {
        stagnation_step(*a.best, a.js[2], rnorm_new, active, a.window, &fail, a.so + 4 + k,
                        a.jo + 2);
      }
      const T rnorm = active ? rnorm_new : rnorm_in;
      if (a.trace != nullptr && active) a.trace[j0 + 1] = rnorm;
      const int jn = j0 + (active ? 1 : 0);
      if (a.recurrence && a.row >= 0) {
        const int slot = active ? a.row : a.ell;
        a.a_rows[slot] = alpha;
        a.b_rows[slot] = beta;
      }
      a.so[0] = rr;
      a.so[1] = rnorm;
      a.so[2] = alpha;
      a.so[3] = beta;
      a.jo[0] = jn;
      a.jo[1] = fail;
      a.bo[0] = jn < a.maxiter && rnorm > threshold && fail == 0;
      a.bo[1] = active && !bad;
    }
  } else {
    if (threadIdx.x == 0) *a.rr = col[0];
    if ((int)threadIdx.x < k) a.awr[threadIdx.x] = col[threadIdx.x + 1];
  }
}

inline __host__ __device__ bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// The loads of K1's launch: 16-byte where every vector and every row of AW
// is 16-byte aligned.  The host applies it to a one-lane launch, a lane of
// the lane axis to itself, so each lane loads as a one-lane launch on its
// data would.
template <typename T>
__host__ __device__ __forceinline__ bool cg_vec(const CgArgs<T>& a) {
  const bool rows = (a.n * (int64_t)sizeof(T)) % 16 == 0;
  return aligned16(a.x) && aligned16(a.r) && aligned16(a.p) && aligned16(a.ap) &&
         aligned16(a.xo) && aligned16(a.ro) && (a.k == 0 || (aligned16(a.aw) && rows));
}

// The one-lane kernel reads its arguments where the launch put them.
template <typename T, int KMAX, bool VEC, bool TAIL>
__global__ void __launch_bounds__(kThreads) cg_update(const CgArgs<T> a) {
  cg_update_body<T, KMAX, VEC, TAIL>(a, gridDim.x);
}

// The step arm's lane axis: lane blockIdx.y moves the arguments to its data,
// takes the loads and the block count a one-lane launch on that data takes
// (the grid along x is the wider of the two counts), and runs the one-lane
// body: its sums in the one-lane order, bit for bit.
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads) cg_update_lanes(const CgArgs<T> a_in, const Lanes l) {
  const CgArgs<T> a = cg_lane(a_in, l);
  const bool vec = cg_vec(a);
  const int blocks = vec ? l.blocks_vec : l.blocks_elem;
  if ((int)blockIdx.x >= blocks) return;
  if (vec) {
    cg_update_body<T, KMAX, true, true>(a, (unsigned)blocks);
  } else {
    cg_update_body<T, KMAX, false, true>(a, (unsigned)blocks);
  }
}

// ---------------------------------------------------------------------------
// fused_rz_reduce: r^T z, (AW) z -- and the preconditioned def-CG tail
// ---------------------------------------------------------------------------
//
// The preconditioned iteration's second pass: z = M^-1 r exists only after
// the residual update, so r^T z and (AW) z cannot ride in K1.  Bound by
// bytes: (2 + k) n elements for 2 (1 + k) n flops (n = 36 551, k = 8, f64:
// 2.9 MB, 0.9 us at 3.35 TB/s), so at the main path's n the time is a
// launch's latency and the design is K1's: ONE launch, up to as many blocks
// as the card holds at once (occupancy API), four elements a thread (two
// 16-byte groups where r, z and every row of AW are aligned, element loads
// otherwise: n is odd on the main path), every vector of a thread's chunk
// loaded before any is used, per-block partials, an integer ticket, and the
// block that draws the last ticket sums the partials in block order (the
// partials and the counter are K1's, allocated once by the wrapper).
//
// Three arms, one accumulation:
//   SUMS  the TPU function: out = [r^T z, (AW) z].
//   STEP  the preconditioned def-CG and cg tail after z = M^-1 r
//         (solvers.py): the last block forms rs' = r^T z, beta = rs' /
//         safe(rs), mu = waw_inv (AW)^T z (lane i sums row i in column
//         order, as K1's step arm) and, on a recording step, a_rows[slot] =
//         alpha and b_rows[slot] = beta at slot = active ? row : ell; so =
//         [rs', beta, mu] (K2's step arm reads beta and mu from it).  Every
//         scalar rounds as the eager op it replaces.
//   PAIR  the sharded def-CG's fresh reductions of the incoming residual:
//         out = [r^T ap, (AW) ap, r^T r, (AW) r] in one read of r, ap and AW.
//         Each column is summed in the order of the one-vector arm on the
//         same grid (every arm of a (dtype, KMAX, VEC) takes the PAIR
//         instantiation's grid), so the pair is two SUMS calls bit for bit.

enum RzMode { kRzSums, kRzStep, kRzPair };

template <typename T>
struct RzArgs {
  const T* r;
  const T* z;  // the pair arm: ap
  const T* aw;
  int k;
  int64_t n;
  T* partials;
  unsigned* counter;
  T* out;  // the sums, [rs', beta, mu] of the step arm, or the pair's sums
  // the step arm
  const T* rs;
  const T* alpha;
  const bool* active;
  const T* waw_inv;  // (k, k), row-major
  T* a_rows;
  T* b_rows;
  int row;  // < 0: not a recording step
  int ell;
};

template <typename T>
__device__ __forceinline__ RzArgs<T> rz_lane(RzArgs<T> a, const Lanes& l) {
  const int64_t lane = blockIdx.y;
  if (lane == 0) return a;
  const int64_t n = a.n, k = a.k;
  a.r += lane * n;
  a.z += lane * n;
  if (a.aw != nullptr) a.aw += lane * k * n;
  if (a.waw_inv != nullptr) a.waw_inv += lane * k * k;
  a.partials += lane * l.partials;
  a.counter += lane;
  a.out += lane * (2 + k);
  a.rs += lane * l.ls[0];
  if (a.row >= 0) {
    a.alpha += lane * l.ls[1];
    a.active += lane * l.ls[2];
    a.a_rows += lane * (a.ell + 1);
    a.b_rows += lane * (a.ell + 1);
  }
  return a;
}

template <typename T, int KMAX, bool VEC, int MODE>
__device__ __forceinline__ void rz_reduce_body(const RzArgs<T>& a, int blocks) {
  using L = CgLayout<T, KMAX, VEC>;
  constexpr int S = L::kSlots, W = L::kWidth;
  constexpr int Q = MODE == kRzPair ? 2 : 1;
  constexpr int KA = KMAX > 0 ? KMAX : 1;
  const int k = a.k;
  const int64_t n = a.n;
  const int64_t units = n / W;
  const int64_t stride = (int64_t)blocks * kThreads * S;
  T acc[Q * (KMAX + 1)];
#pragma unroll
  for (int j = 0; j < Q * (KMAX + 1); ++j) acc[j] = T(0);

  // acc[q (KMAX + 1) + j]: q = 0 against z, q = 1 (the pair) against r.
  auto add = [&](T ri, T zi, const T* awi) {
    acc[0] = fma(ri, zi, acc[0]);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) acc[j + 1] = fma(awi[j], zi, acc[j + 1]);
    }
    if constexpr (MODE == kRzPair) {
      acc[KMAX + 1] = fma(ri, ri, acc[KMAX + 1]);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) acc[KMAX + 2 + j] = fma(awi[j], ri, acc[KMAX + 2 + j]);
      }
    }
  };
  for (int64_t base = (int64_t)blockIdx.x * kThreads * S; base < units; base += stride) {
    T r[S][W], z[S][W], aw[KA][S][W];
    bool ok[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int64_t u = base + s * kThreads + threadIdx.x;
      ok[s] = u < units;
      const int64_t i = ok[s] ? u * W : 0;
      load_slot(a.r + i, r[s]);
      load_slot(a.z + i, z[s]);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k) load_slot(a.aw + (int64_t)j * n + i, aw[j][s]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (!ok[s]) continue;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        T awi[KA];
#pragma unroll
        for (int j = 0; j < KA; ++j) awi[j] = aw[j][s][w];
        add(r[s][w], z[s][w], awi);
      }
    }
  }
  // The ragged tail of the 16-byte path: fewer than W elements.
  const int64_t tail = (int64_t)blockIdx.x * kThreads + threadIdx.x + units * W;
  if (VEC && tail < n) {
    T awi[KA];
#pragma unroll
    for (int j = 0; j < KA; ++j) awi[j] = j < k ? a.aw[(int64_t)j * n + tail] : T(0);
    add(a.r[tail], a.z[tail], awi);
  }

  // The step arm's scalars, in flight before the ticket.
  T winv = T(0), rs = T(0), alpha = T(0);
  bool active = true;
  if constexpr (MODE == kRzStep) {
    if ((int)threadIdx.x < k * k) winv = a.waw_inv[threadIdx.x];
    if (threadIdx.x == 0) {
      rs = *a.rs;
      if (a.row >= 0) {
        alpha = *a.alpha;
        active = *a.active;
      }
    }
  }

  __shared__ T col[Q * (KMAX + 1)];
  if (!ticket_sums<T, Q, KMAX>(acc, k, a.partials, a.counter, blocks, col, [] {})) return;
  if (threadIdx.x == 0) *a.counter = 0u;
  if constexpr (MODE == kRzStep) {
    __shared__ T winv_s[kMaxK * kMaxK];
    if ((int)threadIdx.x < k * k) winv_s[threadIdx.x] = winv;
    __syncthreads();
    if ((int)threadIdx.x < k) {
      T m = T(0);
      for (int j = 0; j < k; ++j) m = add_rn(m, mul_rn(winv_s[threadIdx.x * k + j], col[j + 1]));
      a.out[2 + threadIdx.x] = m;
    }
    if (threadIdx.x == 0) {
      const T rz = col[0];
      const T beta = div_rn(rz, nonzero(rs));
      a.out[0] = rz;
      a.out[1] = beta;
      if (a.row >= 0) {
        const int slot = active ? a.row : a.ell;
        a.a_rows[slot] = alpha;
        a.b_rows[slot] = beta;
      }
    }
  } else {
    if ((int)threadIdx.x < Q * (k + 1)) a.out[threadIdx.x] = col[threadIdx.x];
  }
}

// K6's loads: 16-byte where r, z and every row of AW are 16-byte aligned.
template <typename T>
__host__ __device__ __forceinline__ bool rz_vec(const RzArgs<T>& a) {
  return aligned16(a.r) && aligned16(a.z) &&
         (a.k == 0 || (aligned16(a.aw) && (a.n * (int64_t)sizeof(T)) % 16 == 0));
}

template <typename T, int KMAX, bool VEC, int MODE>
__global__ void __launch_bounds__(kThreads) rz_reduce(const RzArgs<T> a) {
  rz_reduce_body<T, KMAX, VEC, MODE>(a, (int)gridDim.x);
}

// The step arm's lane axis, as K1's (cg_update_lanes).
template <typename T, int KMAX>
__global__ void __launch_bounds__(kThreads) rz_reduce_lanes(const RzArgs<T> a_in, const Lanes l) {
  const RzArgs<T> a = rz_lane(a_in, l);
  const bool vec = rz_vec(a);
  const int blocks = vec ? l.blocks_vec : l.blocks_elem;
  if ((int)blockIdx.x >= blocks) return;
  if (vec) {
    rz_reduce_body<T, KMAX, true, kRzStep>(a, blocks);
  } else {
    rz_reduce_body<T, KMAX, false, kRzStep>(a, blocks);
  }
}

// ---------------------------------------------------------------------------
// fused_deflate_direction: p' = beta p + z - mu^T W, the (p, ap) row -- and
// the direction step of the def-CG and cg loops
// ---------------------------------------------------------------------------
//
// Bound by bytes: (3 + k) n elements (+3n recording) for (2 + 2k) n flops
// (n = 36 551, k = 8, f64: 3.2 MB, 1.0 us), so again a launch's latency:
// one grid-stride pass with up to one 16-byte group a thread (where z, p,
// every row of W and, recording, ap and the buffers' rows are aligned;
// elements otherwise), as many blocks as the card holds at once (occupancy
// API), beta and mu in registers, loaded once with the first group's
// vectors; a warp's stores fill whole 32-byte sectors.  p' takes one fused
// multiply-add a term (beta p + z, then - mu_j W_j for j in order), the
// arithmetic of the element-a-thread kernel this layout replaced: the
// directions, and so the iteration counts, of the unpreconditioned loops
// do not move with it (the plain version rounds each eager op: the two
// agree to the kernel bar).
//
// The STEP arm is the direction update of the solver loops with the `p`
// select: po = keep ? p' : p (keep = K1's active & !bad, or the sharded
// loops' own), beta and mu read from the device (views of K1's or K6's
// packed step outputs), and while recording the incoming (p, ap) go to row
// active ? row : ell of the (ell + 1, n) buffers, formed in the kernel.  The
// TPU function's arm keeps every p' and takes its row from the device.

template <typename T>
struct DirArgs {
  const T* z;
  const T* p;
  const T* beta;
  const T* w;
  const T* mu;
  int k;
  int64_t n;
  T* po;
  const T* ap;  // recording: p_buf != nullptr
  T* p_buf;
  T* ap_buf;
  const int64_t* idx;  // the TPU function's arm: the recording row
  const bool* keep;    // the step arm
  const bool* active;  // the step arm, recording: row active ? row : ell
  int row;
  int ell;
};

template <typename T>
__device__ __forceinline__ DirArgs<T> dir_lane(DirArgs<T> a, const Lanes& l) {
  const int64_t lane = blockIdx.y;
  if (lane == 0) return a;
  const int64_t n = a.n, k = a.k;
  a.z += lane * n;
  a.p += lane * n;
  a.po += lane * n;
  if (a.w != nullptr) {
    a.w += lane * k * n;
    a.mu += lane * l.ls[1];
  }
  a.beta += lane * l.ls[0];
  a.keep += lane * l.ls[2];
  if (a.p_buf != nullptr) {
    a.ap += lane * n;
    a.p_buf += lane * (a.ell + 1) * n;
    a.ap_buf += lane * (a.ell + 1) * n;
    a.active += lane * l.ls[3];
  }
  return a;
}

template <typename T, int KMAX, bool VEC, bool STEP>
__device__ __forceinline__ void deflate_direction_body(const DirArgs<T>& a) {
  constexpr int W = VEC ? kVec<T> : 1;
  constexpr int KA = KMAX > 0 ? KMAX : 1;
  const int k = a.k;
  const int64_t n = a.n;
  const int64_t units = n / W;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool record = a.p_buf != nullptr;

  T zv[W], pv[W], apv[W], wv[KA][W];
  auto load = [&](int64_t i) {
    load_slot(a.z + i, zv);
    load_slot(a.p + i, pv);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) load_slot(a.w + (int64_t)j * n + i, wv[j]);
    }
    if (record) load_slot(a.ap + i, apv);
  };
  // The first group's vectors go out with the scalars.
  if (first < units) load(first * W);
  const T beta = *a.beta;
  T mu[KA];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) mu[j] = j < k ? a.mu[j] : T(0);
  bool keep = true;
  int64_t row = 0;
  if constexpr (STEP) {
    keep = *a.keep;
    if (record) row = *a.active ? a.row : a.ell;
  } else {
    if (record) row = *a.idx;
  }
  T* const pb = record ? a.p_buf + row * n : nullptr;
  T* const apb = record ? a.ap_buf + row * n : nullptr;

  auto direction = [&](T zi, T pi, const T* wi) {
    T v = fma(beta, pi, zi);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) v = fma(-mu[j], wi[j], v);
    }
    return keep ? v : pi;
  };
  for (int64_t q = first; q < units; q += stride) {
    if (q != first) load(q * W);
    T out[W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      T wi[KA];
#pragma unroll
      for (int j = 0; j < KA; ++j) wi[j] = wv[j][u];
      out[u] = direction(zv[u], pv[u], wi);
    }
    store_slot(a.po + q * W, out);
    if (record) {
      store_slot(pb + q * W, pv);
      store_slot(apb + q * W, apv);
    }
  }
  // The ragged tail of the 16-byte path: fewer than W elements.
  const int64_t tail = first + units * W;
  if (VEC && tail < n) {
    T wi[KA];
#pragma unroll
    for (int j = 0; j < KA; ++j) wi[j] = j < k ? a.w[(int64_t)j * n + tail] : T(0);
    const T pi = a.p[tail];
    a.po[tail] = direction(a.z[tail], pi, wi);
    if (record) {
      pb[tail] = pi;
      apb[tail] = a.ap[tail];
    }
  }
}

template <typename T, int KMAX, bool VEC, bool STEP>
__global__ void __launch_bounds__(kThreads) deflate_direction(const DirArgs<T> a) {
  deflate_direction_body<T, KMAX, VEC, STEP>(a);
}

// The step arm's lane axis: lane blockIdx.y on its own data.  No reduction,
// so the loads (one choice for every lane) do not move a bit.
template <typename T, int KMAX, bool VEC>
__global__ void __launch_bounds__(kThreads) deflate_direction_lanes(const DirArgs<T> a,
                                                                    const Lanes l) {
  deflate_direction_body<T, KMAX, VEC, true>(dir_lane(a, l));
}

// ---------------------------------------------------------------------------
// self_gram: S S^T for S of shape (m2, n), m2 <= 128
// ---------------------------------------------------------------------------
//
// G's upper triangle in 16 x 16 super-tiles (I <= J): 36 at 128 rows, 28 at
// 112, 6 at 40; rows past m2 are zero rows (they add nothing).  Two passes:
//
//   self_gram_partial: block b owns columns [b*cols, (b+1)*cols), one block
//     per SM.  It streams them through shared memory in chunks of
//     kGramCols columns, kGramStages deep, by cp.async (8-byte copies in
//     f64: n may be odd, so rows are only 8-byte aligned).  Warp w owns
//     super-tiles w, w + 8, ... (SLOTS of them, a template parameter: 1 at
//     40 rows, 4 at 112, 5 at 128; a slot past the last super-tile
//     computes super-tile 0 and stores nothing), and every lane holds the
//     same accumulator layout: (rows g, g + 8) x (cols 2t, 2t + 1) of the
//     left and the right 8 columns, lane = 4g + t.
//       f64: two FP64 tensor-core products (DMMA, mma.sync m16n8k4) per
//     super-tile and 4 columns; A = S[16I.., c..c+3] (lane: rows g and
//     g + 8, column t) and B = S[16J.., c..c+3]^T (lane: row g, column t)
//     are read from shared memory once per super-tile: four 8-byte loads
//     for two products.  The row stride of kGramCols + 4 doubles keeps
//     those loads free of bank conflicts.
//       f32: no TF32 (it would move the sums by ~1e-3): 8 FMAs per column
//     on 6 values read from shared memory, in the same layout.
//     The block writes the 8 x 8 tiles of the upper triangle it holds to
//     partials[b] as (tiles, 8, 8), row-major in a tile (the lower-left
//     8 x 8 of a diagonal super-tile is dropped).
//   self_gram_reduce: 32 consecutive tile elements a block; warp w sums the
//     partials of blocks w, w + 8, ... in order (reads of 256 contiguous
//     bytes), then warp 0 adds the 8 warp sums in order and writes G[i][j]
//     and G[j][i] from the one value (i <= j), so G is exactly symmetric.
//
// No atomics: runs repeat bit for bit.  Bound by bytes (m2 n elements read
// once; the f64 products need ~m2^2 n flops on 67 TFLOP/s of FP64 tensor
// cores, the smaller time at these widths).  The partials (one block per SM:
// 7 MB at 112 rows) stay in the 50 MB L2 between the passes.  What still
// separates it from its bound: the second launch and the gap before it,
// and two 8-byte shared-memory loads per DMMA in the partial pass.

constexpr int kGramCols = 32;
constexpr int kGramStages = 3;
constexpr int kGramMaxSlots = ((kMaxGramRows / 16) * (kMaxGramRows / 16 + 1) / 2 + kWarps - 1) /
                              kWarps;

template <typename T>
__host__ __device__ constexpr int gram_ld() {
  return sizeof(T) == 8 ? kGramCols + 4 : kGramCols + 1;
}

template <typename T>
size_t gram_smem_bytes(int m2) {
  return sizeof(T) * kGramStages * gram_ld<T>() * 16 * ((m2 + 15) / 16);
}

// (I, J) of tile t of the row-major upper triangle of an r x r tile grid.
__device__ __forceinline__ void tile_ij(int t, int r, int* i, int* j) {
  int row = 0;
  while (t >= r - row) {
    t -= r - row;
    ++row;
  }
  *i = row;
  *j = row + t;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(valid ? BYTES : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns [c, c + kGramCols) of S into a stage; zeros past c1 and m2.
template <typename T>
__device__ __forceinline__ void gram_load_chunk(T* stage, const T* __restrict__ s, int m2,
                                                int m2p, int64_t n, int64_t c, int64_t c1) {
  constexpr int LD = gram_ld<T>();
  for (int e = threadIdx.x; e < m2p * kGramCols; e += kThreads) {
    const int row = e / kGramCols;
    const int col = e - row * kGramCols;
    const bool valid = row < m2 && c + col < c1;
    cp_async<sizeof(T)>(stage + row * LD + col, valid ? s + (int64_t)row * n + c + col : s,
                        valid);
  }
}

// acc[h][v0 + 2 v1] += rows (g + 8 v1) x cols (8h + 2t + v0) of the
// super-tile at rows ri, cols rj over the kGramCols columns of a stage.
template <int SLOTS>
__device__ __forceinline__ void gram_step(const double* stage, const int (&ri)[SLOTS],
                                          const int (&rj)[SLOTS], double (&acc)[SLOTS][2][4]) {
  constexpr int LD = gram_ld<double>();
  const int lane = threadIdx.x & 31;
  const double* base = stage + (lane >> 2) * LD + (lane & 3);
#pragma unroll
  for (int kc = 0; kc < kGramCols; kc += 4) {
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const double a0 = base[ri[q] * LD + kc], a1 = base[(ri[q] + 8) * LD + kc];
      const double b0 = base[rj[q] * LD + kc], b1 = base[(rj[q] + 8) * LD + kc];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
            "{%0,%1,%2,%3};\n"
            : "+d"(acc[q][h][0]), "+d"(acc[q][h][1]), "+d"(acc[q][h][2]), "+d"(acc[q][h][3])
            : "d"(a0), "d"(a1), "d"(h ? b1 : b0));
      }
    }
  }
}

template <int SLOTS>
__device__ __forceinline__ void gram_step(const float* stage, const int (&ri)[SLOTS],
                                          const int (&rj)[SLOTS], float (&acc)[SLOTS][2][4]) {
  constexpr int LD = gram_ld<float>();
  const int lane = threadIdx.x & 31;
  const float* rows_a = stage + (lane >> 2) * LD;
  const float* rows_b = stage + 2 * (lane & 3) * LD;
#pragma unroll 4
  for (int k = 0; k < kGramCols; ++k) {
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      float a[2], b[4];
#pragma unroll
      for (int v = 0; v < 2; ++v) a[v] = rows_a[(ri[q] + 8 * v) * LD + k];
#pragma unroll
      for (int x = 0; x < 4; ++x) b[x] = rows_b[(rj[q] + 8 * (x >> 1) + (x & 1)) * LD + k];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[q][h][v] = fmaf(a[v >> 1], b[2 * h + (v & 1)], acc[q][h][v]);
    }
  }
}

template <typename T, int SLOTS>
__global__ void __launch_bounds__(kThreads) self_gram_partial(
    const T* __restrict__ s, int m2, int64_t n, int64_t cols, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char gram_smem[];
  T* stages = reinterpret_cast<T*>(gram_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r16 = (m2 + 15) / 16, r8 = (m2 + 7) / 8;
  const int m2p = 16 * r16;
  const int nsuper = r16 * (r16 + 1) / 2;
  const int stage_elems = m2p * gram_ld<T>();
  const int64_t c0 = (int64_t)blockIdx.x * cols;
  const int64_t c1 = c0 + cols < n ? c0 + cols : n;
  const int nchunks = (int)((c1 - c0 + kGramCols - 1) / kGramCols);

  int ri[SLOTS], rj[SLOTS];
  T acc[SLOTS][2][4];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    const int st = warp + kWarps * q;
    int i, j;
    tile_ij(st < nsuper ? st : 0, r16, &i, &j);
    ri[q] = 16 * i;
    rj[q] = 16 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[q][h][v] = T(0);
  }

#pragma unroll
  for (int st = 0; st < kGramStages - 1; ++st) {
    if (st < nchunks)
      gram_load_chunk(stages + st * stage_elems, s, m2, m2p, n, c0 + st * kGramCols, c1);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kGramStages - 2>();
    __syncthreads();  // chunk ch has landed; chunk ch - 1's stage is free
    const int next = ch + kGramStages - 1;
    if (next < nchunks)
      gram_load_chunk(stages + (next % kGramStages) * stage_elems, s, m2, m2p, n,
                      c0 + (int64_t)next * kGramCols, c1);
    cp_async_commit();
    gram_step(stages + (ch % kGramStages) * stage_elems, ri, rj, acc);
  }
  cp_async_wait<0>();

  T* out = partials + (int64_t)blockIdx.x * (r8 * (r8 + 1) / 2) * 64 + (lane >> 2) * 8 +
           2 * (lane & 3);
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    if (warp + kWarps * q >= nsuper) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int ti = ri[q] / 8 + v, tj = rj[q] / 8 + h;  // the 8 x 8 tile
        if (ti > tj || tj >= r8) continue;
        const int t = ti * r8 - ti * (ti - 1) / 2 + (tj - ti);
        out[t * 64] = acc[q][h][2 * v];
        out[t * 64 + 1] = acc[q][h][2 * v + 1];
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) self_gram_reduce(
    const T* __restrict__ partials, int nparts, int m2, T* __restrict__ out) {
  __shared__ T warp_sum_s[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r8 = (m2 + 7) / 8;
  const int width = r8 * (r8 + 1) / 2 * 64;
  const int e = blockIdx.x * 32 + lane;
  const int r = (e >> 3) & 7, c = e & 7;
  int ti = 0, tj = 0;
  if (e < width) tile_ij(e >> 6, r8, &ti, &tj);
  const int i = 8 * ti + r, j = 8 * tj + c;
  const bool used = e < width && j < m2 && (ti != tj || r <= c);
  T v = T(0);
  if (used) {
#pragma unroll 4
    for (int b = warp; b < nparts; b += kWarps) v += partials[(int64_t)b * width + e];
  }
  warp_sum_s[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && used) {
    T sum = T(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_sum_s[w][lane];
    out[i * m2 + j] = sum;
    out[j * m2 + i] = sum;
  }
}

// ---------------------------------------------------------------------------
// recombine_blocks: [u^T S_top; u^T S_bot] for S (2m, n), u (m, k)
// ---------------------------------------------------------------------------
//
// Bound by bytes: it reads 2m n + m k elements and writes 2k n for 4 k m n
// flops (m = 56, k = 8, n = 16 384: 16.8 MB, 5.0 us at 3.35 TB/s; the
// flops take 0.4 us on the FP64 tensor cores).  So the design is about
// bytes in flight.  The grid does not grow with n: as many blocks as fit
// on an SM (one at 2m = 112 rows, three at 40), on every SM, own the
// 32-column chunks b, b + grid, ... of S and stream them through shared
// memory, kRecStages deep, by cp.async: 16-byte copies when every row of S
// is 16-byte aligned, element copies otherwise (n is odd on the main path,
// 36 551).  A stage holds the m + 4 ceil(m / 4) rows the products read
// (rows past 2m zero-filled) with a row stride of kRecCols + 4.  A column
// belongs to one block and every output is written once: nothing is
// reduced across blocks, and runs repeat bit for bit.
//   f64: u^T stays in registers for the whole kernel as the A fragments of
// mma.sync m8n8k4 (DMMA; rows j of u^T, 8 per M tile, so k = 8 fills one
// tile and k = 16 two), A[j][i] = u[4q + t][j] for lane = 4j + t.  Warp w
// takes columns 8 (w % 4) .. + 7 of a chunk and half w / 4 (the top or the
// bottom block): each 4-row step of the stage is one B fragment
// (S[h m + 4q + t][c + j], conflict-free with the stride 36) and one DMMA
// per M tile into the 8 x 8 output tile, stored after quad shuffles in
// whole 32-byte sectors.
//   f32: FMAs, no TF32.  Thread (col, half, group of 4 j) runs down the
// stage's rows with u from shared memory.

constexpr int kRecCols = 32;
constexpr int kRecStages = 6;
constexpr int kRecMaxBlocksPerSm = 3;
constexpr int kRecLd = kRecCols + 4;
constexpr int kRecMaxQ = kMaxGramRows / 8;  // 4-row steps of one half

__host__ __device__ constexpr int rec_rows(int m) { return m + 4 * ((m + 3) / 4); }

template <typename T>
size_t recombine_smem_bytes(int m) {
  return sizeof(T) * ((size_t)kRecStages * rec_rows(m) * kRecLd + (size_t)m * kMaxK);
}

// Columns [c, c + kRecCols) of S's first 2m rows into a stage; zeros past
// n and 2m.  BYTES a copy: 16 when every row of S is 16-byte aligned.
template <typename T, int BYTES>
__device__ __forceinline__ void rec_load_chunk_w(T* stage, const T* __restrict__ s, int m,
                                                 int64_t n, int64_t c) {
  constexpr int kPer = BYTES / (int)sizeof(T);
  constexpr int kCopies = kRecCols / kPer;
  const int rows = rec_rows(m);
  for (int e = threadIdx.x; e < rows * kCopies; e += kThreads) {
    const int row = e / kCopies;
    const int col = (e - row * kCopies) * kPer;
    const bool valid = row < 2 * m && c + col < n;
    cp_async<BYTES>(stage + row * kRecLd + col, valid ? s + (int64_t)row * n + c + col : s,
                    valid);
  }
}

template <typename T>
__device__ __forceinline__ void rec_load_chunk(T* stage, const T* s, int m, int64_t n,
                                               int64_t c, bool vec) {
  if (vec) {
    rec_load_chunk_w<T, 16>(stage, s, m, n, c);
  } else {
    rec_load_chunk_w<T, (int)sizeof(T)>(stage, s, m, n, c);
  }
}

template <typename T, int KT>
__global__ void __launch_bounds__(kThreads) recombine_blocks(
    const T* __restrict__ s, const T* __restrict__ u, int m, int k, int64_t n, int vec,
    T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char rec_smem[];
  T* stages = reinterpret_cast<T*>(rec_smem);
  T* us = stages + kRecStages * rec_rows(m) * kRecLd;  // u, (m, kMaxK), zero past k
  const int stage_elems = rec_rows(m) * kRecLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t nchunks = (n + kRecCols - 1) / kRecCols;
  const int mine = (int)((nchunks - blockIdx.x + gridDim.x - 1) / gridDim.x);

  for (int e = threadIdx.x; e < m * kMaxK; e += kThreads) {
    const int i = e / kMaxK, j = e - i * kMaxK;
    us[e] = j < k ? u[i * k + j] : T(0);
  }
  __syncthreads();
  const int nq = (m + 3) / 4;
  const int g = lane >> 2, t = lane & 3;
  constexpr bool kDmma = sizeof(T) == 8;  // f64 on the FP64 tensor cores
  // DMMA: the A fragments of u^T (zero past m and k), for the whole kernel.
  T afrag[KT][kRecMaxQ];
  if constexpr (kDmma) {
#pragma unroll
    for (int mt = 0; mt < KT; ++mt)
#pragma unroll
      for (int q = 0; q < kRecMaxQ; ++q) {
        const int i = 4 * q + t;
        afrag[mt][q] = i < m ? us[i * kMaxK + 8 * mt + g] : T(0);
      }
  }

#pragma unroll
  for (int st = 0; st < kRecStages - 1; ++st) {
    if (st < mine)
      rec_load_chunk(stages + st * stage_elems, s, m, n,
                     (blockIdx.x + (int64_t)st * gridDim.x) * kRecCols, vec);
    cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    cp_async_wait<kRecStages - 2>();
    __syncthreads();  // chunk it has landed; chunk it - 1's stage is free
    const int next = it + kRecStages - 1;
    if (next < mine)
      rec_load_chunk(stages + (next % kRecStages) * stage_elems, s, m, n,
                     (blockIdx.x + (int64_t)next * gridDim.x) * kRecCols, vec);
    cp_async_commit();
    const T* stage = stages + (it % kRecStages) * stage_elems;
    const int64_t c0 = (blockIdx.x + (int64_t)it * gridDim.x) * kRecCols;
    if constexpr (kDmma) {
      const int half = warp >> 2;
      for (int col = 8 * (warp & 3); col < kRecCols; col += 32) {
        const T* b_base = stage + (half * m + t) * kRecLd + col + g;
        double acc[KT][2];
#pragma unroll
        for (int mt = 0; mt < KT; ++mt) acc[mt][0] = acc[mt][1] = 0.0;
#pragma unroll
        for (int q = 0; q < kRecMaxQ; ++q) {
          if (q < nq) {
            const double b = b_base[4 * q * kRecLd];
#pragma unroll
            for (int mt = 0; mt < KT; ++mt)
              asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, "
                  "{%0,%1};\n"
                  : "+d"(acc[mt][0]), "+d"(acc[mt][1])
                  : "d"(afrag[mt][q]), "d"(b));
          }
        }
        // Lane (j, t) holds columns 2t, 2t + 1 of row j; two rounds of quad
        // shuffles hand it columns t and 4 + t, so each store fills whole
        // 32-byte sectors of eight rows.
#pragma unroll
        for (int mt = 0; mt < KT; ++mt) {
          const int j = 8 * mt + g;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int src = (lane & ~3) + 2 * h + (t >> 1);
            const double v0 = __shfl_sync(0xffffffffu, acc[mt][0], src);
            const double v1 = __shfl_sync(0xffffffffu, acc[mt][1], src);
            const int64_t c = c0 + col + 4 * h + t;
            if (j < k && c < n) out[(int64_t)(half * k + j) * n + c] = (t & 1) ? v1 : v0;
          }
        }
      }
    } else {
      const int half = (threadIdx.x >> 5) & 1;
      const int j0 = 4 * (threadIdx.x >> 6);
      for (int col = threadIdx.x & 31; col < kRecCols && j0 < k; col += 32) {
        T acc[4] = {T(0), T(0), T(0), T(0)};
        const T* srow = stage + half * m * kRecLd + col;
        for (int i = 0; i < m; ++i) {
          const T z = srow[i * kRecLd];
          const T* ui = us + i * kMaxK + j0;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) acc[jj] += ui[jj] * z;
        }
        const int64_t c = c0 + col;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (j0 + jj < k && c < n) out[(int64_t)(half * k + j0 + jj) * n + c] = acc[jj];
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// lsmr_update: hbar' = h - c0 hbar, x' = x + c1 hbar', h' = v - c2 h -- and
// the rest of LSMR's iteration from the first Givens rotation on
// ---------------------------------------------------------------------------
//
// Bound by bytes: the TPU function reads x, hbar, h, v once and writes x',
// hbar', h' once (7n elements for 6n flops); one grid-stride pass keeps
// hbar' in a register between its two uses.  At the least-squares path's
// n = 16 384 it moves 0.9 MB, so its time is a launch's latency: the grid is
// what the card holds at once (occupancy API) up to one 16-byte group a
// thread, and nothing is reduced, so blocks share nothing.
//
// The STEP arm is everything of lsmr.py's step after its last reduction.
// It takes w = g+ - beta+ v (v+ before its normalisation), |w|^2 and beta+
// from the eager ops before it, and the carried scalars s = [alpha, zetabar,
// alphabar, rho, rhobar, cbar, sbar], [j, fail] and active.  Every block runs
// the prologue alike: alpha+ = sqrt(|w|^2), both rotations (_sym_ortho), the
// coefficients c0, c1, c2; the body forms v+ = w / safe(alpha+) and the
// three recurrences, each output the new value on a live step and the old
// one on a frozen step; block 0 writes the exact-termination latch, the two
// status updates, the trace slot j + 1, the next scalars (fresh buffers:
// the blocks read s while block 0 writes them), j + active and the next
// step's active flag.  Each thread's first group of vectors is in flight
// before the scalars (all loaded once, together) are formed, so the
// scalar chain overlaps the vectors' latency.

template <typename T>
struct LsmrArgs {
  const T* x;
  const T* hbar;
  const T* h;
  const T* v;
  const T* w;  // the step arm's g+ - beta+ v
  int64_t n;
  T* xo;
  T* hbo;
  T* ho;
  T* vo;  // the step arm's v+
  // the TPU function's arm
  const T* c0;
  const T* c1;
  const T* c2;
  // the step arm's scalars
  const T* wsq;
  const T* beta;
  const T* s;
  const int* js;  // [j, fail]
  const bool* active;
  const T* threshold;
  const T* diverged_at;
  int64_t maxiter;
  int window;  // > 0: the stall detector is armed (s[kLsmrSlots] = best,
               // js = [j, fail, stall])
  T* trace;
  T* so;
  int* jo;
  bool* ao;
};

// The slots of the carried LSMR scalars s.
enum LsmrSlot { kAlpha, kZetabar, kAlphabar, kRho, kRhobar, kCbar, kSbar, kLsmrSlots };

template <typename T>
struct Givens {
  T c, s, r;
};

// lsmr._sym_ortho: r = sqrt(a^2 + b^2), (a / safe(r), b / safe(r), r).
template <typename T>
__device__ __forceinline__ Givens<T> sym_ortho(T a, T b) {
  const T r = sqrt_rn(add_rn(mul_rn(a, a), mul_rn(b, b)));
  const T safe = nonzero(r);
  return {div_rn(a, safe), div_rn(b, safe), r};
}

template <typename T>
struct LsmrCoefficients {
  T c0, c1, c2, safe_alpha;
  bool active;
};

// Every scalar the step reads, loaded once, together, at the top.
template <typename T>
struct LsmrScalars {
  T s[kLsmrSlots], beta, wsq, threshold, diverged_at;
  int j, fail;
  bool active;

  __device__ __forceinline__ void load(const LsmrArgs<T>& a) {
#pragma unroll
    for (int q = 0; q < kLsmrSlots; ++q) s[q] = a.s[q];
    beta = *a.beta;
    wsq = *a.wsq;
    threshold = *a.threshold;
    diverged_at = *a.diverged_at;
    j = a.js[0];
    fail = a.js[1];
    active = *a.active;
  }
};

// The step's scalar recurrence, in the eager loop's order; `store` (one
// thread of the grid) also writes the next scalar state.
template <typename T, bool STALL>
__device__ __forceinline__ LsmrCoefficients<T> lsmr_tail(const LsmrArgs<T>& a, const LsmrScalars<T>& sc,
                                         bool store) {
  const T (&s)[kLsmrSlots] = sc.s;
  const T beta = sc.beta;
  const bool active = sc.active;
  const T alpha = sqrt_rn(sc.wsq);
  const Givens<T> g1 = sym_ortho(s[kAlphabar], beta);
  const T rho = g1.r;
  const T thetanew = mul_rn(g1.s, alpha);
  const T alphabar = mul_rn(g1.c, alpha);
  const T thetabar = mul_rn(s[kSbar], rho);
  const Givens<T> g2 = sym_ortho(mul_rn(s[kCbar], rho), thetanew);
  const T zeta = mul_rn(g2.c, s[kZetabar]);
  T zetabar = mul_rn(-g2.s, s[kZetabar]);
  LsmrCoefficients<T> t;
  t.c0 = div_rn(mul_rn(thetabar, rho), mul_rn(s[kRho], s[kRhobar]));
  t.c1 = div_rn(zeta, mul_rn(nonzero(rho), nonzero(g2.r)));
  t.c2 = div_rn(thetanew, nonzero(rho));
  t.safe_alpha = nonzero(alpha);
  t.active = active;
  if (store) {
    if (beta == T(0) || alpha == T(0)) zetabar = T(0);  // exact termination
    const T normar = abs_of(zetabar);
    int fail = sc.fail;
    if (fail == 0 && active && !finite(normar)) fail = kBreakdownNonfinite;
    if (fail == 0 && active && normar > sc.diverged_at) fail = kStagnated;
    if constexpr (STALL) {
      stagnation_step(a.s[kLsmrSlots], a.js[2], normar, active, a.window, &fail,
                      a.so + kLsmrSlots, a.jo + 2);
    }
    if (a.trace != nullptr && active) a.trace[sc.j + 1] = normar;
    const T next[kLsmrSlots] = {alpha, zetabar, alphabar, rho, g2.r, g2.c, g2.s};
#pragma unroll
    for (int q = 0; q < kLsmrSlots; ++q) a.so[q] = active ? next[q] : s[q];
    const int jn = sc.j + (active ? 1 : 0);
    a.jo[0] = jn;
    a.jo[1] = fail;
    const T zb = active ? zetabar : s[kZetabar];
    *a.ao = jn < a.maxiter && abs_of(zb) > sc.threshold && fail == 0;
  }
  return t;
}

// The kernel's body over a grid of `blocks` blocks along x.
template <typename T, bool STEP, bool VEC, bool STALL>
__device__ __forceinline__ void lsmr_update_body(const LsmrArgs<T>& a, unsigned blocks) {
  constexpr int W = VEC ? kVec<T> : 1;
  const int64_t units = a.n / W;
  const int64_t stride = (int64_t)blocks * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  // A live step reads w (the step arm) or v (the TPU function's arm).
  const T* vin = STEP ? a.w : a.v;
  // The first unit's vectors are in flight before the scalars are formed.
  T xv[W], hbv[W], hv[W], vv[W];
  if (first < units) {
    load_slot(a.x + first * W, xv);
    load_slot(a.hbar + first * W, hbv);
    load_slot(a.h + first * W, hv);
    load_slot(vin + first * W, vv);
  }
  T c0, c1, c2, safe_alpha = T(1);
  if constexpr (STEP) {
    LsmrScalars<T> sc;
    sc.load(a);
    const LsmrCoefficients<T> t = lsmr_tail<T, STALL>(a, sc, blockIdx.x == 0 && threadIdx.x == 0);
    if (!t.active) {  // a frozen step: every vector keeps its value
      for (int64_t i = first; i < a.n; i += stride) {
        a.xo[i] = a.x[i];
        a.hbo[i] = a.hbar[i];
        a.ho[i] = a.h[i];
        a.vo[i] = a.v[i];
      }
      return;
    }
    c0 = t.c0;
    c1 = t.c1;
    c2 = t.c2;
    safe_alpha = t.safe_alpha;
  } else {
    c0 = *a.c0;
    c1 = *a.c1;
    c2 = *a.c2;
  }
  auto update = [&](T xi, T hbi, T hi, T vi, T& xn, T& hbn, T& hn, T& vn) {
    vn = STEP ? div_rn(vi, safe_alpha) : vi;
    hbn = fma(-c0, hbi, hi);
    xn = fma(c1, hbn, xi);
    hn = fma(-c2, hi, vn);
  };
  for (int64_t q = first; q < units; q += stride) {
    if (q != first) {
      load_slot(a.x + q * W, xv);
      load_slot(a.hbar + q * W, hbv);
      load_slot(a.h + q * W, hv);
      load_slot(vin + q * W, vv);
    }
#pragma unroll
    for (int u = 0; u < W; ++u) update(xv[u], hbv[u], hv[u], vv[u], xv[u], hbv[u], hv[u], vv[u]);
    store_slot(a.xo + q * W, xv);
    store_slot(a.hbo + q * W, hbv);
    store_slot(a.ho + q * W, hv);
    if (STEP) store_slot(a.vo + q * W, vv);
  }
  // The ragged tail of the 16-byte path: fewer than W elements.
  const int64_t tail = first + units * W;
  if (VEC && tail < a.n) {
    T xn, hbn, hn, vn;
    update(a.x[tail], a.hbar[tail], a.h[tail], vin[tail], xn, hbn, hn, vn);
    a.xo[tail] = xn;
    a.hbo[tail] = hbn;
    a.ho[tail] = hn;
    if (STEP) a.vo[tail] = vn;
  }
}

// The one-lane kernel reads its arguments where the launch put them.
template <typename T, bool STEP, bool VEC, bool STALL>
__global__ void __launch_bounds__(kThreads) lsmr_update(const LsmrArgs<T> a) {
  lsmr_update_body<T, STEP, VEC, STALL>(a, gridDim.x);
}

// The step arm's per-lane scalars, in the order of Lanes::ls.
enum LsmrLaneScalar { kLmWsq, kLmBeta, kLmS, kLmJs, kLmActive, kLmThreshold, kLmDiverged,
                      kLmTrace };

// Lane blockIdx.y of the step arm's lane axis: every pointer moved to its
// lane (vectors (lanes, n); the per-lane scalars and trace rows at the lane
// strides of l.ls; the fresh scalar outputs packed), so a lane's blocks run
// the one-lane arm on that lane's data.
template <typename T>
__device__ __forceinline__ LsmrArgs<T> lsmr_lane(LsmrArgs<T> a, const Lanes& l) {
  const int64_t lane = blockIdx.y;
  if (lane == 0) return a;
  const int64_t v = lane * a.n, armed = a.window > 0;
  a.x += v;
  a.hbar += v;
  a.h += v;
  a.v += v;
  a.w += v;
  a.xo += v;
  a.hbo += v;
  a.ho += v;
  a.vo += v;
  a.wsq += lane * l.ls[kLmWsq];
  a.beta += lane * l.ls[kLmBeta];
  a.s += lane * l.ls[kLmS];
  a.js += lane * l.ls[kLmJs];
  a.active += lane * l.ls[kLmActive];
  a.threshold += lane * l.ls[kLmThreshold];
  a.diverged_at += lane * l.ls[kLmDiverged];
  if (a.trace != nullptr) a.trace += lane * l.ls[kLmTrace];
  a.so += lane * (kLsmrSlots + armed);
  a.jo += lane * (2 + armed);
  a.ao += lane;
  return a;
}

// The loads of the step arm: 16-byte where every vector is 16-byte
// aligned.  The host applies it to a one-lane launch, a lane of the lane
// axis to itself.
template <typename T, bool STEP>
__host__ __device__ __forceinline__ bool lsmr_vec(const LsmrArgs<T>& a) {
  return aligned16(a.x) && aligned16(a.hbar) && aligned16(a.h) && aligned16(a.v) &&
         aligned16(a.xo) && aligned16(a.hbo) && aligned16(a.ho) &&
         (!STEP || (aligned16(a.w) && aligned16(a.vo)));
}

// The step arm's lane axis: lane blockIdx.y moves the arguments to its
// data, takes the loads and the block count a one-lane launch on that data
// takes (the grid along x is the wider of the two counts; surplus blocks
// return) and runs the one-lane body.  Nothing is reduced across blocks, so
// a lane is bit for bit a one-lane launch on its data.
template <typename T, bool STALL>
__global__ void __launch_bounds__(kThreads) lsmr_update_lanes(const LsmrArgs<T> a_in,
                                                              const Lanes l) {
  const LsmrArgs<T> a = lsmr_lane(a_in, l);
  const bool vec = lsmr_vec<T, true>(a);
  const int blocks = vec ? l.blocks_vec : l.blocks_elem;
  if ((int)blockIdx.x >= blocks) return;
  if (vec) {
    lsmr_update_body<T, true, true, STALL>(a, (unsigned)blocks);
  } else {
    lsmr_update_body<T, true, false, STALL>(a, (unsigned)blocks);
  }
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------


// Blocks of a one-lane K1 launch; a lane of the lane axis takes the count
// a one-lane launch on its data takes, so the lane axis does not move the
// sums.
template <typename T, int KMAX, bool VEC, bool TAIL>
cudaError_t cg_blocks(int64_t n, int capacity, int* out) {
  static int resident = 0;  // once per instantiation
  if (resident == 0) {
    const cudaError_t err = resident_blocks(cg_update<T, KMAX, VEC, TAIL>, &resident);
    if (err != cudaSuccess) return err;
  }
  // Threads the grid needs: one per kSlots slots.
  constexpr int kSlots = CgLayout<T, KMAX, VEC>::kSlots;
  const int64_t units = VEC ? n / kVec<T> : n;
  *out = stride_grid(resident, (units + kSlots - 1) / kSlots, capacity);
  return cudaSuccess;
}

template <typename T, int KMAX, bool VEC, bool TAIL>
cudaError_t launch_cg_kernel(const CgArgs<T>& a, int capacity, cudaStream_t st) {
  int blocks = 0;
  const cudaError_t err = cg_blocks<T, KMAX, VEC, TAIL>(a.n, capacity, &blocks);
  if (err != cudaSuccess) return err;
  cg_update<T, KMAX, VEC, TAIL><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int KMAX>
cudaError_t launch_cg_lanes(const CgArgs<T>& a, int capacity, int lanes, Lanes l,
                            cudaStream_t st) {
  l.partials = (int64_t)capacity * 2 * (kMaxK + 1);
  cudaError_t err = cg_blocks<T, KMAX, true, true>(a.n, capacity, &l.blocks_vec);
  if (err == cudaSuccess) err = cg_blocks<T, KMAX, false, true>(a.n, capacity, &l.blocks_elem);
  if (err != cudaSuccess) return err;
  const int wide = l.blocks_vec > l.blocks_elem ? l.blocks_vec : l.blocks_elem;
  cg_update_lanes<T, KMAX><<<dim3(wide, lanes), kThreads, 0, st>>>(a, l);
  return cudaGetLastError();
}

template <typename T, int KMAX, bool TAIL>
cudaError_t launch_cg_arm(const CgArgs<T>& a, int capacity, int lanes, const Lanes& l,
                          cudaStream_t st) {
  if (TAIL && lanes > 1) return launch_cg_lanes<T, KMAX>(a, capacity, lanes, l, st);
  return cg_vec(a) ? launch_cg_kernel<T, KMAX, true, TAIL>(a, capacity, st)
                   : launch_cg_kernel<T, KMAX, false, TAIL>(a, capacity, st);
}

// `capacity`: the blocks the partials buffer has rows for (a lane's rows:
// lane i's partials start at row i * capacity, its counter at counter + i).
template <typename T, bool TAIL>
int launch_cg(const CgArgs<T>& a, int capacity, int lanes, const Lanes& l, void* stream) {
  if (a.k < 0 || a.k > kMaxK || a.n < 1 || capacity < 1 || lanes < 1 || (!TAIL && lanes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.k == 0) {
    err = launch_cg_arm<T, 0, TAIL>(a, capacity, lanes, l, st);
  } else if (a.k <= 8) {
    err = launch_cg_arm<T, 8, TAIL>(a, capacity, lanes, l, st);
  } else {
    err = launch_cg_arm<T, kMaxK, TAIL>(a, capacity, lanes, l, st);
  }
  return (int)err;
}

// Blocks of a one-lane K6 launch: every arm takes the pair arm's grid (the
// register-hungriest of the three), so each column is summed in one order
// whichever arm sums it.
template <typename T, int KMAX, bool VEC>
cudaError_t rz_blocks(int64_t n, int capacity, int* out) {
  static int resident = 0;  // once per instantiation
  if (resident == 0) {
    const cudaError_t err = resident_blocks(rz_reduce<T, KMAX, VEC, kRzPair>, &resident);
    if (err != cudaSuccess) return err;
  }
  constexpr int kSlots = CgLayout<T, KMAX, VEC>::kSlots;
  const int64_t units = VEC ? n / kVec<T> : n;
  *out = stride_grid(resident, (units + kSlots - 1) / kSlots, capacity);
  return cudaSuccess;
}

template <typename T, int KMAX, bool VEC, int MODE>
cudaError_t launch_rz_kernel(const RzArgs<T>& a, int capacity, cudaStream_t st) {
  int blocks = 0;
  const cudaError_t err = rz_blocks<T, KMAX, VEC>(a.n, capacity, &blocks);
  if (err != cudaSuccess) return err;
  rz_reduce<T, KMAX, VEC, MODE><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int KMAX, int MODE>
cudaError_t launch_rz_arm(const RzArgs<T>& a, int capacity, int lanes, Lanes l,
                          cudaStream_t st) {
  if (MODE == kRzStep && lanes > 1) {
    l.partials = (int64_t)capacity * 2 * (kMaxK + 1);
    cudaError_t err = rz_blocks<T, KMAX, true>(a.n, capacity, &l.blocks_vec);
    if (err == cudaSuccess) err = rz_blocks<T, KMAX, false>(a.n, capacity, &l.blocks_elem);
    if (err != cudaSuccess) return err;
    const int wide = l.blocks_vec > l.blocks_elem ? l.blocks_vec : l.blocks_elem;
    rz_reduce_lanes<T, KMAX><<<dim3(wide, lanes), kThreads, 0, st>>>(a, l);
    return cudaGetLastError();
  }
  return rz_vec(a) ? launch_rz_kernel<T, KMAX, true, MODE>(a, capacity, st)
                   : launch_rz_kernel<T, KMAX, false, MODE>(a, capacity, st);
}

// `capacity`: the blocks the partials buffer has rows for (2 (kMaxK + 1)
// columns a row; lane i's rows start at row i * capacity).
template <typename T, int MODE>
int launch_rz(const RzArgs<T>& a, int capacity, int lanes, const Lanes& l, void* stream) {
  if (a.k < 0 || a.k > kMaxK || a.n < 1 || capacity < 1 || lanes < 1 ||
      (MODE != kRzStep && lanes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.k == 0) {
    err = launch_rz_arm<T, 0, MODE>(a, capacity, lanes, l, st);
  } else if (a.k <= 8) {
    err = launch_rz_arm<T, 8, MODE>(a, capacity, lanes, l, st);
  } else {
    err = launch_rz_arm<T, kMaxK, MODE>(a, capacity, lanes, l, st);
  }
  return (int)err;
}

template <typename T, int KMAX, bool VEC, bool STEP>
cudaError_t launch_dir_kernel(const DirArgs<T>& a, int lanes, const Lanes& l, cudaStream_t st) {
  static int resident = 0;  // once per instantiation
  if (resident == 0) {
    const cudaError_t err = resident_blocks(deflate_direction<T, KMAX, VEC, STEP>, &resident);
    if (err != cudaSuccess) return err;
  }
  const int64_t units = VEC ? a.n / kVec<T> : a.n;
  const int blocks = stride_grid(resident, units, resident);
  if constexpr (STEP) {
    if (lanes > 1) {
      deflate_direction_lanes<T, KMAX, VEC><<<dim3(blocks, lanes), kThreads, 0, st>>>(a, l);
      return cudaGetLastError();
    }
  }
  deflate_direction<T, KMAX, VEC, STEP><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// 16-byte groups when z, p, po, every row of W and, recording, ap and every
// row of the buffers are 16-byte aligned (and, on the lane axis, every
// lane's rows).
template <typename T, int KMAX, bool STEP>
cudaError_t launch_dir_aligned(const DirArgs<T>& a, int lanes, const Lanes& l,
                               cudaStream_t st) {
  const bool rows = (a.n * (int64_t)sizeof(T)) % 16 == 0;
  const bool vec = aligned16(a.z) && aligned16(a.p) && aligned16(a.po) &&
                   (a.k == 0 || (aligned16(a.w) && rows)) &&
                   (a.p_buf == nullptr ||
                    (aligned16(a.ap) && aligned16(a.p_buf) && aligned16(a.ap_buf) && rows)) &&
                   (lanes == 1 || rows);
  return vec ? launch_dir_kernel<T, KMAX, true, STEP>(a, lanes, l, st)
             : launch_dir_kernel<T, KMAX, false, STEP>(a, lanes, l, st);
}

template <typename T, bool STEP>
int launch_dir(const DirArgs<T>& a, int lanes, const Lanes& l, void* stream) {
  if (a.k < 0 || a.k > kMaxK || a.n < 1 || lanes < 1 || (!STEP && lanes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a.k == 0) {
    err = launch_dir_aligned<T, 0, STEP>(a, lanes, l, st);
  } else if (a.k <= 8) {
    err = launch_dir_aligned<T, 8, STEP>(a, lanes, l, st);
  } else {
    err = launch_dir_aligned<T, kMaxK, STEP>(a, lanes, l, st);
  }
  return (int)err;
}

template <typename T, int SLOTS>
cudaError_t launch_gram_partial(const void* s, int m2, int64_t n, int64_t cols, int nblocks,
                                void* partials, cudaStream_t st) {
  // The opt-in above 48 KB, once per process at the largest size.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      self_gram_partial<T, SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gram_smem_bytes<T>(kMaxGramRows));
  if (opt_in != cudaSuccess) return opt_in;
  self_gram_partial<T, SLOTS><<<nblocks, kThreads, gram_smem_bytes<T>(m2), st>>>(
      static_cast<const T*>(s), m2, n, cols, static_cast<T*>(partials));
  return cudaGetLastError();
}

template <typename T>
int launch_self_gram(const void* s, int m2, int64_t n, int64_t cols,
                     int nblocks, void* partials, void* out, void* stream) {
  if (m2 < 1 || m2 > kMaxGramRows || n < 1 || cols % kGramCols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r16 = (m2 + 15) / 16;
  cudaError_t err;
  static_assert(kGramMaxSlots == 5, "one case per slot count");
  switch ((r16 * (r16 + 1) / 2 + kWarps - 1) / kWarps) {
    case 1: err = launch_gram_partial<T, 1>(s, m2, n, cols, nblocks, partials, st); break;
    case 2: err = launch_gram_partial<T, 2>(s, m2, n, cols, nblocks, partials, st); break;
    case 3: err = launch_gram_partial<T, 3>(s, m2, n, cols, nblocks, partials, st); break;
    case 4: err = launch_gram_partial<T, 4>(s, m2, n, cols, nblocks, partials, st); break;
    default: err = launch_gram_partial<T, 5>(s, m2, n, cols, nblocks, partials, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int r8 = (m2 + 7) / 8;
  self_gram_reduce<T><<<r8 * (r8 + 1), kThreads, 0, st>>>(
      static_cast<const T*>(partials), nblocks, m2, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, int KT>
cudaError_t launch_recombine_kt(const void* s, const void* u, int m, int k, int64_t n,
                                void* out, int nblocks, cudaStream_t st) {
  const auto kernel = recombine_blocks<T, KT>;
  // The opt-in above 48 KB, once per process at the largest size; then as
  // many blocks as fit on an SM (up to kRecMaxBlocksPerSm) on every SM,
  // counted once per window height.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)recombine_smem_bytes<T>(kMaxGramRows / 2));
  if (opt_in != cudaSuccess) return opt_in;
  static int resident[kMaxGramRows / 2 + 1] = {};
  const size_t smem = recombine_smem_bytes<T>(m);
  if (resident[m] == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    resident[m] = sms * (per_sm < kRecMaxBlocksPerSm ? (per_sm > 0 ? per_sm : 1)
                                                     : kRecMaxBlocksPerSm);
  }
  const int grid = nblocks < resident[m] ? nblocks : resident[m];
  const int vec = (uintptr_t)s % 16 == 0 && (n * (int64_t)sizeof(T)) % 16 == 0;
  kernel<<<grid, kThreads, smem, st>>>(static_cast<const T*>(s), static_cast<const T*>(u), m,
                                       k, n, vec, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
int launch_recombine(const void* s, const void* u, int m, int k, int64_t n,
                     void* out, int nblocks, void* stream) {
  if (m < 0 || 2 * m > kMaxGramRows || k < 1 || k > kMaxK || n < 1 || nblocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k > 8 ? launch_recombine_kt<T, 2>(s, u, m, k, n, out, nblocks, st)
            : launch_recombine_kt<T, 1>(s, u, m, k, n, out, nblocks, st);
  return (int)err;
}

// Blocks of a one-lane K7 launch; a lane of the lane axis takes the count
// a one-lane launch on its data takes.
template <typename T, bool STEP, bool VEC, bool STALL>
cudaError_t lsmr_blocks(int64_t n, int* out) {
  static int resident = 0;  // once per instantiation
  if (resident == 0) {
    const cudaError_t err = resident_blocks(lsmr_update<T, STEP, VEC, STALL>, &resident);
    if (err != cudaSuccess) return err;
  }
  const int64_t units = VEC ? n / kVec<T> : n;
  *out = stride_grid(resident, units, resident);
  return cudaSuccess;
}

template <typename T, bool STEP, bool VEC, bool STALL>
cudaError_t launch_lsmr_kernel(const LsmrArgs<T>& a, cudaStream_t st) {
  int blocks = 0;
  const cudaError_t err = lsmr_blocks<T, STEP, VEC, STALL>(a.n, &blocks);
  if (err != cudaSuccess) return err;
  lsmr_update<T, STEP, VEC, STALL><<<blocks, kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool STEP>
int launch_lsmr(const LsmrArgs<T>& a, void* stream) {
  if (a.n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = lsmr_vec<T, STEP>(a);
  // The stall detector is compiled into the armed arm only (window > 0).
  const bool stall = STEP && a.window > 0;
  const cudaError_t err =
      vec ? (stall ? launch_lsmr_kernel<T, STEP, true, STEP>(a, st)
                   : launch_lsmr_kernel<T, STEP, true, false>(a, st))
          : (stall ? launch_lsmr_kernel<T, STEP, false, STEP>(a, st)
                   : launch_lsmr_kernel<T, STEP, false, false>(a, st));
  return (int)err;
}

template <typename T, bool STALL>
cudaError_t launch_lsmr_lanes_kernel(const LsmrArgs<T>& a, int lanes, Lanes l,
                                     cudaStream_t st) {
  cudaError_t err = lsmr_blocks<T, true, true, STALL>(a.n, &l.blocks_vec);
  if (err == cudaSuccess) err = lsmr_blocks<T, true, false, STALL>(a.n, &l.blocks_elem);
  if (err != cudaSuccess) return err;
  const int wide = l.blocks_vec > l.blocks_elem ? l.blocks_vec : l.blocks_elem;
  lsmr_update_lanes<T, STALL><<<dim3(wide, lanes), kThreads, 0, st>>>(a, l);
  return cudaGetLastError();
}

// The step arm on the lane axis: `lanes` independent LSMR tails in one
// launch, lane i's per-lane scalars at lane strides l.ls.
template <typename T>
int launch_lsmr_lanes(const LsmrArgs<T>& a, int lanes, const Lanes& l, void* stream) {
  if (a.n < 1 || lanes < 1 || lanes > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a.window > 0 ? launch_lsmr_lanes_kernel<T, true>(a, lanes, l, st)
                                       : launch_lsmr_lanes_kernel<T, false>(a, lanes, l, st);
  return (int)err;
}

}  // namespace

#define REPRO_CG_FUSED_ENTRY_POINTS(T, SUFFIX)                                 \
  extern "C" int fused_cg_update_##SUFFIX(                                     \
      const void* x, const void* r, const void* p, const void* ap,             \
      const void* alpha, const void* aw, int k, int64_t n, void* xo,           \
      void* ro, void* partials, int capacity, void* counter, void* rr,         \
      void* awr, void* stream) {                                               \
    CgArgs<T> a = {};                                                          \
    a.x = static_cast<const T*>(x);                                            \
    a.r = static_cast<const T*>(r);                                            \
    a.p = static_cast<const T*>(p);                                            \
    a.ap = const_cast<T*>(static_cast<const T*>(ap));                          \
    a.aw = static_cast<const T*>(aw);                                          \
    a.k = k;                                                                   \
    a.n = n;                                                                   \
    a.xo = static_cast<T*>(xo);                                                \
    a.ro = static_cast<T*>(ro);                                                \
    a.partials = static_cast<T*>(partials);                                    \
    a.counter = static_cast<unsigned*>(counter);                               \
    a.alpha = static_cast<const T*>(alpha);                                    \
    a.rr = static_cast<T*>(rr);                                                \
    a.awr = static_cast<T*>(awr);                                              \
    return launch_cg<T, false>(a, capacity, 1, Lanes{}, stream);               \
  }                                                                            \
  extern "C" int fused_cg_step_##SUFFIX(                                       \
      const void* x, const void* r, const void* p, void* ap, const void* aw,   \
      int k, int64_t n, void* xo, void* ro, void* partials, int capacity,      \
      void* counter, const void* d, const void* rs, const void* rnorm,         \
      const void* threshold, const void* diverged_at, const void* js,          \
      const void* active, const void* waw_inv, int64_t maxiter,                \
      int recurrence, void* trace, void* a_rows, void* b_rows, int row,        \
      int ell, int window, const void* best, void* so, void* jo, void* bo,     \
      int lanes, const int64_t* lane_strides, void* stream) {                  \
    CgArgs<T> a = {};                                                          \
    Lanes l = {};                                                              \
    for (int q = 0; q < 8 && lane_strides != nullptr; ++q)                     \
      l.ls[q] = lane_strides[q];                                               \
    a.x = static_cast<const T*>(x);                                            \
    a.r = static_cast<const T*>(r);                                            \
    a.p = static_cast<const T*>(p);                                            \
    a.ap = static_cast<T*>(ap);                                                \
    a.aw = static_cast<const T*>(aw);                                          \
    a.k = k;                                                                   \
    a.n = n;                                                                   \
    a.xo = static_cast<T*>(xo);                                                \
    a.ro = static_cast<T*>(ro);                                                \
    a.partials = static_cast<T*>(partials);                                    \
    a.counter = static_cast<unsigned*>(counter);                               \
    a.d = static_cast<const T*>(d);                                            \
    a.rs = static_cast<const T*>(rs);                                          \
    a.rnorm = static_cast<const T*>(rnorm);                                    \
    a.threshold = static_cast<const T*>(threshold);                            \
    a.diverged_at = static_cast<const T*>(diverged_at);                        \
    a.js = static_cast<const int*>(js);                                        \
    a.active = static_cast<const bool*>(active);                               \
    a.waw_inv = static_cast<const T*>(waw_inv);                                \
    a.maxiter = maxiter;                                                       \
    a.recurrence = recurrence;                                                 \
    a.trace = static_cast<T*>(trace);                                          \
    a.a_rows = static_cast<T*>(a_rows);                                        \
    a.b_rows = static_cast<T*>(b_rows);                                        \
    a.row = row;                                                               \
    a.ell = ell;                                                               \
    a.window = window;                                                         \
    a.best = static_cast<const T*>(best);                                      \
    a.so = static_cast<T*>(so);                                                \
    a.jo = static_cast<int*>(jo);                                              \
    a.bo = static_cast<bool*>(bo);                                             \
    return launch_cg<T, true>(a, capacity, lanes, l, stream);                  \
  }                                                                            \
  extern "C" int fused_rz_reduce_##SUFFIX(                                     \
      const void* r, const void* z, const void* aw, int k, int64_t n,          \
      void* partials, int capacity, void* counter, void* out, void* stream) {  \
    RzArgs<T> a = {};                                                          \
    a.r = static_cast<const T*>(r);                                            \
    a.z = static_cast<const T*>(z);                                            \
    a.aw = static_cast<const T*>(aw);                                          \
    a.k = k;                                                                   \
    a.n = n;                                                                   \
    a.partials = static_cast<T*>(partials);                                    \
    a.counter = static_cast<unsigned*>(counter);                               \
    a.out = static_cast<T*>(out);                                              \
    return launch_rz<T, kRzSums>(a, capacity, 1, Lanes{}, stream);             \
  }                                                                            \
  extern "C" int fused_rz_pair_##SUFFIX(                                       \
      const void* r, const void* ap, const void* aw, int k, int64_t n,         \
      void* partials, int capacity, void* counter, void* out, void* stream) {  \
    RzArgs<T> a = {};                                                          \
    a.r = static_cast<const T*>(r);                                            \
    a.z = static_cast<const T*>(ap);                                           \
    a.aw = static_cast<const T*>(aw);                                          \
    a.k = k;                                                                   \
    a.n = n;                                                                   \
    a.partials = static_cast<T*>(partials);                                    \
    a.counter = static_cast<unsigned*>(counter);                               \
    a.out = static_cast<T*>(out);                                              \
    return launch_rz<T, kRzPair>(a, capacity, 1, Lanes{}, stream);             \
  }                                                                            \
  extern "C" int fused_rz_step_##SUFFIX(                                       \
      const void* r, const void* z, const void* aw, int k, int64_t n,          \
      void* partials, int capacity, void* counter, const void* rs,             \
      const void* alpha, const void* active, const void* waw_inv,              \
      void* a_rows, void* b_rows, int row, int ell, void* so, int lanes,       \
      const int64_t* lane_strides, void* stream) {                             \
    RzArgs<T> a = {};                                                          \
    Lanes l = {};                                                              \
    for (int q = 0; q < 3 && lane_strides != nullptr; ++q)                     \
      l.ls[q] = lane_strides[q];                                               \
    a.r = static_cast<const T*>(r);                                            \
    a.z = static_cast<const T*>(z);                                            \
    a.aw = static_cast<const T*>(aw);                                          \
    a.k = k;                                                                   \
    a.n = n;                                                                   \
    a.partials = static_cast<T*>(partials);                                    \
    a.counter = static_cast<unsigned*>(counter);                               \
    a.rs = static_cast<const T*>(rs);                                          \
    a.alpha = static_cast<const T*>(alpha);                                    \
    a.active = static_cast<const bool*>(active);                               \
    a.waw_inv = static_cast<const T*>(waw_inv);                                \
    a.a_rows = static_cast<T*>(a_rows);                                        \
    a.b_rows = static_cast<T*>(b_rows);                                        \
    a.row = row;                                                               \
    a.ell = ell;                                                               \
    a.out = static_cast<T*>(so);                                               \
    return launch_rz<T, kRzStep>(a, capacity, lanes, l, stream);               \
  }                                                                            \
  extern "C" int fused_deflate_direction_##SUFFIX(                             \
      const void* z, const void* p, const void* beta, const void* w,           \
      const void* mu, int k, int64_t n, void* po, const void* ap,              \
      const void* idx, void* p_buf, void* ap_buf, void* stream) {              \
    DirArgs<T> a = {};                                                         \
    a.z = static_cast<const T*>(z);                                            \
    a.p = static_cast<const T*>(p);                                            \
    a.beta = static_cast<const T*>(beta);                                      \
    a.w = static_cast<const T*>(w);                                            \
    a.mu = static_cast<const T*>(mu);                                          \
    a.k = k;                                                                   \
    a.n = n;                                                                   \
    a.po = static_cast<T*>(po);                                                \
    a.ap = static_cast<const T*>(ap);                                          \
    a.idx = static_cast<const int64_t*>(idx);                                  \
    a.p_buf = static_cast<T*>(p_buf);                                          \
    a.ap_buf = static_cast<T*>(ap_buf);                                        \
    return launch_dir<T, false>(a, 1, Lanes{}, stream);                        \
  }                                                                            \
  extern "C" int fused_direction_step_##SUFFIX(                                \
      const void* z, const void* p, const void* beta, const void* w,           \
      const void* mu, int k, int64_t n, void* po, const void* keep,            \
      const void* ap, const void* active, int row, int ell, void* p_buf,       \
      void* ap_buf, int lanes, const int64_t* lane_strides, void* stream) {    \
    DirArgs<T> a = {};                                                         \
    Lanes l = {};                                                              \
    for (int q = 0; q < 4 && lane_strides != nullptr; ++q)                     \
      l.ls[q] = lane_strides[q];                                               \
    a.z = static_cast<const T*>(z);                                            \
    a.p = static_cast<const T*>(p);                                            \
    a.beta = static_cast<const T*>(beta);                                      \
    a.w = static_cast<const T*>(w);                                            \
    a.mu = static_cast<const T*>(mu);                                          \
    a.k = k;                                                                   \
    a.n = n;                                                                   \
    a.po = static_cast<T*>(po);                                                \
    a.keep = static_cast<const bool*>(keep);                                   \
    a.ap = static_cast<const T*>(ap);                                          \
    a.active = static_cast<const bool*>(active);                               \
    a.row = row;                                                               \
    a.ell = ell;                                                               \
    a.p_buf = static_cast<T*>(p_buf);                                          \
    a.ap_buf = static_cast<T*>(ap_buf);                                        \
    return launch_dir<T, true>(a, lanes, l, stream);                           \
  }                                                                            \
  extern "C" int self_gram_##SUFFIX(const void* s, int m2, int64_t n,          \
                                    int64_t cols, int nblocks, void* partials, \
                                    void* out, void* stream) {                 \
    return launch_self_gram<T>(s, m2, n, cols, nblocks, partials, out,         \
                               stream);                                        \
  }                                                                            \
  extern "C" int recombine_blocks_##SUFFIX(const void* s, const void* u,       \
                                           int m, int k, int64_t n, void* out, \
                                           int nblocks, void* stream) {        \
    return launch_recombine<T>(s, u, m, k, n, out, nblocks, stream);           \
  }                                                                            \
  extern "C" int lsmr_update_##SUFFIX(                                         \
      const void* x, const void* hbar, const void* h, const void* v,           \
      const void* c0, const void* c1, const void* c2, int64_t n, void* xo,     \
      void* hbo, void* ho, void* stream) {                                     \
    LsmrArgs<T> a = {};                                                        \
    a.x = static_cast<const T*>(x);                                            \
    a.hbar = static_cast<const T*>(hbar);                                      \
    a.h = static_cast<const T*>(h);                                            \
    a.v = static_cast<const T*>(v);                                            \
    a.n = n;                                                                   \
    a.xo = static_cast<T*>(xo);                                                \
    a.hbo = static_cast<T*>(hbo);                                              \
    a.ho = static_cast<T*>(ho);                                                \
    a.c0 = static_cast<const T*>(c0);                                          \
    a.c1 = static_cast<const T*>(c1);                                          \
    a.c2 = static_cast<const T*>(c2);                                          \
    return launch_lsmr<T, false>(a, stream);                                   \
  }                                                                            \
  extern "C" int lsmr_step_##SUFFIX(                                           \
      const void* x, const void* hbar, const void* h, const void* v,           \
      const void* w, int64_t n, const void* wsq, const void* beta,             \
      const void* s, const void* js, const void* active,                       \
      const void* threshold, const void* diverged_at, int64_t maxiter,         \
      int window, void* trace, void* xo, void* hbo, void* ho, void* vo,        \
      void* so, void* jo, void* ao, void* stream) {                            \
    LsmrArgs<T> a = {};                                                        \
    a.x = static_cast<const T*>(x);                                            \
    a.hbar = static_cast<const T*>(hbar);                                      \
    a.h = static_cast<const T*>(h);                                            \
    a.v = static_cast<const T*>(v);                                            \
    a.w = static_cast<const T*>(w);                                            \
    a.n = n;                                                                   \
    a.xo = static_cast<T*>(xo);                                                \
    a.hbo = static_cast<T*>(hbo);                                              \
    a.ho = static_cast<T*>(ho);                                                \
    a.vo = static_cast<T*>(vo);                                                \
    a.wsq = static_cast<const T*>(wsq);                                        \
    a.beta = static_cast<const T*>(beta);                                      \
    a.s = static_cast<const T*>(s);                                            \
    a.js = static_cast<const int*>(js);                                        \
    a.active = static_cast<const bool*>(active);                               \
    a.threshold = static_cast<const T*>(threshold);                            \
    a.diverged_at = static_cast<const T*>(diverged_at);                        \
    a.maxiter = maxiter;                                                       \
    a.window = window;                                                         \
    a.trace = static_cast<T*>(trace);                                          \
    a.so = static_cast<T*>(so);                                                \
    a.jo = static_cast<int*>(jo);                                              \
    a.ao = static_cast<bool*>(ao);                                             \
    return launch_lsmr<T, true>(a, stream);                                    \
  }                                                                            \
  extern "C" int lsmr_step_lanes_##SUFFIX(                                     \
      const void* x, const void* hbar, const void* h, const void* v,           \
      const void* w, int64_t n, const void* wsq, const void* beta,             \
      const void* s, const void* js, const void* active,                       \
      const void* threshold, const void* diverged_at, int64_t maxiter,         \
      int window, void* trace, void* xo, void* hbo, void* ho, void* vo,        \
      void* so, void* jo, void* ao, int lanes, const int64_t* lane_strides,    \
      void* stream) {                                                          \
    LsmrArgs<T> a = {};                                                        \
    Lanes l = {};                                                              \
    for (int q = 0; q < 8 && lane_strides != nullptr; ++q)                     \
      l.ls[q] = lane_strides[q];                                               \
    a.x = static_cast<const T*>(x);                                            \
    a.hbar = static_cast<const T*>(hbar);                                      \
    a.h = static_cast<const T*>(h);                                            \
    a.v = static_cast<const T*>(v);                                            \
    a.w = static_cast<const T*>(w);                                            \
    a.n = n;                                                                   \
    a.xo = static_cast<T*>(xo);                                                \
    a.hbo = static_cast<T*>(hbo);                                              \
    a.ho = static_cast<T*>(ho);                                                \
    a.vo = static_cast<T*>(vo);                                                \
    a.wsq = static_cast<const T*>(wsq);                                        \
    a.beta = static_cast<const T*>(beta);                                      \
    a.s = static_cast<const T*>(s);                                            \
    a.js = static_cast<const int*>(js);                                        \
    a.active = static_cast<const bool*>(active);                               \
    a.threshold = static_cast<const T*>(threshold);                            \
    a.diverged_at = static_cast<const T*>(diverged_at);                        \
    a.maxiter = maxiter;                                                       \
    a.window = window;                                                         \
    a.trace = static_cast<T*>(trace);                                          \
    a.so = static_cast<T*>(so);                                                \
    a.jo = static_cast<int*>(jo);                                              \
    a.ao = static_cast<bool*>(ao);                                             \
    return launch_lsmr_lanes<T>(a, lanes, l, stream);                          \
  }

REPRO_CG_FUSED_ENTRY_POINTS(float, f32)
REPRO_CG_FUSED_ENTRY_POINTS(double, f64)
