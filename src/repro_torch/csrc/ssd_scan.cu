// Hand-written Hopper (sm_90a) kernel for the Mamba2 SSD chunked scan (K10).
//
// ssd_scan_* replaces ssd_scan_pallas (src/repro/kernels/ssd_scan.py:92, body
// _ssd_kernel :41).  For each (batch, head), chunk by chunk in order, with
// cs = cumsum(a dt) inside the chunk (f32, one thread, a fixed order):
//
//   G  = C B^T                                          (c x c)
//   M  = exp(cs_t - cs_s) dt_s  for s <= t, else 0      (masked before the exp)
//   Y  = (M o G) X + exp(cs) (C H0^T)                   (c x p)
//   H1 = exp(cs_c) H0 + X^T (exp(cs_c - cs) dt o B)     (p x n, f32, carried)
//
// B and C are read by group (head / (h / g)), never repeated in memory.
// Beyond the Pallas kernel the state can start from `h0` (b, h, p, n) and the
// final state can be written to `h_out`: the serving path's prefill.  Rows
// past l (the padded tail of the last chunk) load dt = 0 and x = B = C = 0,
// so they leave the state unchanged and the final state is exact.
//
// What bounds it: operations.  Per chunk and head it does 2c^2(n + p) +
// 4c p n flops (C B^T, (M o G) X, C H0^T, X^T bw) on c(p + 2n + 1) inputs:
// at mamba2-1.3b's prefill (b 4, l 4096, h 64, p 64, g 1, n 128, c 128)
// 86 GFLOP on 0.2 GB.  This first kernel runs the Pallas body's f32
// arithmetic on the CUDA cores (no tensor cores).
//
// Design (simple and right first):
//
//   * One 256-thread block per (batch, head): 256 blocks at mamba2's
//     prefill.  The chunk loop runs inside the block, in order, with the
//     (p x n) state in shared memory: the Pallas "arbitrary" chunk axis.
//   * Shared memory holds, in f32, X (c x p), B (c x n+1) and C (c x n+1)
//     of the chunk and the state H (p x n+1): 198 KB at c = 128, p = 64,
//     n = 128 (opt-in above 48 KB).  The f32 G tile (64 KB) never exists
//     at once with C: G is formed in registers (an 8 x 8 tile a thread,
//     rows ty + 16i, columns tx + 16j), masked and scaled into M o G, and
//     written over C once every thread has read C.  exp(cs_c - cs) dt o B
//     is formed in place in B.
//   * c, p and n are rounded up to 16 in shared memory with zero rows and
//     columns (rows past c: dt = 0, which changes nothing), so every
//     thread runs the same register tiles.  c <= 128, p <= 64, n <= 128.
//   * Each thread owns fixed elements of Y (rows ty + 16i, columns tx +
//     16j) and of H (rows ty + 16i, columns tx + 16j): nothing is reduced
//     across threads or blocks, so two launches agree bit for bit.
//   * The D skip is not here: the wrapper adds y + x d in the reference's
//     dtype order.
//
// Plain C interface: the entry point returns cudaGetLastError() (0 = ok) and
// launches on the stream it is given.  Outputs are allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxC = 128, kMaxP = 64, kMaxN = 128;
constexpr int kTC = kMaxC / 16, kTP = kMaxP / 16, kTN = kMaxN / 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared floats for padded sizes cp, pp, np_ (multiples of 16).
__host__ __device__ inline size_t smem_floats(int cp, int pp, int np_) {
  const int ldn = np_ + 1;
  const int cw = cp * ldn > cp * (cp + 1) ? cp * ldn : cp * (cp + 1);
  return (size_t)cp * pp + (size_t)cp * ldn + cw + (size_t)pp * ldn + 2 * cp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bmat,
                const T* __restrict__ cmat, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out, int L, int H, int P, int G,
                int N, int c) {
  const int cp = round16(c), pp = round16(P), np_ = round16(N);
  const int ldn = np_ + 1, ldw = cp + 1;
  extern __shared__ float smem[];
  float* xs = smem;               // cp x pp
  float* bs = xs + cp * pp;       // cp x ldn: B, then exp(cs_c - cs) dt o B
  float* cw = bs + cp * ldn;      // cp x ldn: C, then cp x ldw: M o G
  const int cw_size = cp * ldn > cp * ldw ? cp * ldn : cp * ldw;
  float* hs = cw + cw_size;       // pp x ldn: the state
  float* cs = hs + pp * ldn;      // cp: cumulative a dt
  float* dts = cs + cp;           // cp

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int bi = bh / H, head = bh % H;
  const int grp = head / (H / G);
  const float a_h = a[head];
  const int tc = cp / 16, tp = pp / 16, tn = np_ / 16;

  for (int e = tid; e < pp * ldn; e += kThreads) {
    const int r = e / ldn, col = e % ldn;
    hs[e] = (h0 != nullptr && r < P && col < N) ? h0[((size_t)bh * P + r) * N + col] : 0.f;
  }

  const int n_chunks = (L + c - 1) / c;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * c;
    __syncthreads();  // the previous chunk's buffers are consumed
    for (int e = tid; e < cp * pp; e += kThreads) {
      const int r = e / pp, col = e % pp;
      const int t = t0 + r;
      xs[e] = (r < c && t < L && col < P)
                  ? to_f32(x[(((size_t)bi * L + t) * H + head) * P + col]) : 0.f;
    }
    for (int e = tid; e < cp * ldn; e += kThreads) {
      const int r = e / ldn, col = e % ldn;
      const int t = t0 + r;
      const bool in = r < c && t < L && col < N;
      const size_t src = (((size_t)bi * L + t) * G + grp) * N + col;
      bs[e] = in ? to_f32(bmat[src]) : 0.f;
      cw[e] = in ? to_f32(cmat[src]) : 0.f;
    }
    for (int r = tid; r < cp; r += kThreads) {
      const int t = t0 + r;
      dts[r] = (r < c && t < L) ? dt[((size_t)bi * L + t) * H + head] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int r = 0; r < cp; ++r) {
        run += dts[r] * a_h;
        cs[r] = run;
      }
    }
    __syncthreads();
    const float cs_tot = cs[cp - 1];

    // Y = exp(cs_t) (C H0^T): rows ty + 16i, columns tx + 16j.
    float yacc[kTC][kTP];
#pragma unroll
    for (int i = 0; i < kTC; ++i)
#pragma unroll
      for (int j = 0; j < kTP; ++j) yacc[i][j] = 0.f;
    for (int kk = 0; kk < np_; ++kk) {
      float cv[kTC], hv[kTP];
#pragma unroll
      for (int i = 0; i < kTC; ++i) cv[i] = i < tc ? cw[(ty + 16 * i) * ldn + kk] : 0.f;
#pragma unroll
      for (int j = 0; j < kTP; ++j) hv[j] = j < tp ? hs[(tx + 16 * j) * ldn + kk] : 0.f;
#pragma unroll
      for (int i = 0; i < kTC; ++i)
#pragma unroll
        for (int j = 0; j < kTP; ++j) yacc[i][j] = fmaf(cv[i], hv[j], yacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTC; ++i) {
      if (i >= tc) break;
      const float e = expf(cs[ty + 16 * i]);
#pragma unroll
      for (int j = 0; j < kTP; ++j) yacc[i][j] *= e;
    }

    // G = C B^T in registers: rows t = ty + 16i, columns s = tx + 16j.
    float g[kTC][kTC];
#pragma unroll
    for (int i = 0; i < kTC; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) g[i][j] = 0.f;
    for (int kk = 0; kk < np_; ++kk) {
      float cv[kTC], bv[kTC];
#pragma unroll
      for (int i = 0; i < kTC; ++i) {
        cv[i] = i < tc ? cw[(ty + 16 * i) * ldn + kk] : 0.f;
        bv[i] = i < tc ? bs[(tx + 16 * i) * ldn + kk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTC; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
    }
    __syncthreads();  // every thread has read C and B

    // M o G over C; exp(cs_c - cs_s) dt_s B_s over B.
#pragma unroll
    for (int i = 0; i < kTC; ++i) {
      if (i >= tc) break;
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < kTC; ++j) {
        if (j >= tc) break;
        const int s = tx + 16 * j;
        const float m = s <= t ? expf(cs[t] - cs[s]) * dts[s] : 0.f;
        cw[t * ldw + s] = m * g[i][j];
      }
    }
    for (int e = tid; e < cp * np_; e += kThreads) {
      const int r = e / np_, col = e % np_;
      bs[r * ldn + col] *= expf(cs_tot - cs[r]) * dts[r];
    }
    __syncthreads();

    // Y += (M o G) X, written in x's dtype.
    for (int s = 0; s < cp; ++s) {
      float wv[kTC], xv[kTP];
#pragma unroll
      for (int i = 0; i < kTC; ++i) wv[i] = i < tc ? cw[(ty + 16 * i) * ldw + s] : 0.f;
#pragma unroll
      for (int j = 0; j < kTP; ++j) xv[j] = j < tp ? xs[s * pp + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kTC; ++i)
#pragma unroll
        for (int j = 0; j < kTP; ++j) yacc[i][j] = fmaf(wv[i], xv[j], yacc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTC; ++i) {
      const int r = ty + 16 * i;
      const int t = t0 + r;
      if (i >= tc || r >= c || t >= L) continue;
#pragma unroll
      for (int j = 0; j < kTP; ++j) {
        const int col = tx + 16 * j;
        if (col < P) y[(((size_t)bi * L + t) * H + head) * P + col] = from_f32<T>(yacc[i][j]);
      }
    }

    // H1 = exp(cs_c) H0 + X^T bw: this thread's rows ty + 16i, columns tx + 16j.
    float hacc[kTP][kTN];
#pragma unroll
    for (int i = 0; i < kTP; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) hacc[i][j] = 0.f;
    for (int s = 0; s < cp; ++s) {
      float xv[kTP], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTP; ++i) xv[i] = i < tp ? xs[s * pp + ty + 16 * i] : 0.f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = j < tn ? bs[s * ldn + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kTP; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) hacc[i][j] = fmaf(xv[i], bv[j], hacc[i][j]);
    }
    const float decay = expf(cs_tot);
#pragma unroll
    for (int i = 0; i < kTP; ++i) {
      if (i >= tp) break;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        if (j >= tn) break;
        float* hp = hs + (ty + 16 * i) * ldn + tx + 16 * j;
        *hp = decay * *hp + hacc[i][j];
      }
    }
  }

  if (h_out != nullptr) {
    __syncthreads();
    for (int e = tid; e < P * N; e += kThreads) {
      const int r = e / N, col = e % N;
      h_out[(size_t)bh * P * N + e] = hs[r * ldn + col];
    }
  }
}

template <typename T>
int launch_ssd(const void* x, const void* dt, const void* a, const void* bmat,
               const void* cmat, const void* h0, void* y, void* h_out, int b, int L, int H,
               int P, int G, int N, int c, void* stream) {
  if (b <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G || P <= 0 || N <= 0 || c <= 0 ||
      c > kMaxC || P > kMaxP || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(round16(c), round16(P), round16(N));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<b * H, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bmat),
      static_cast<const T*>(cmat), static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_out), L, H, P, G, N, c);
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_SSD_ENTRY_POINT(T, SUFFIX)                                              \
  extern "C" int ssd_scan_##SUFFIX(const void* x, const void* dt, const void* a,      \
                                   const void* bmat, const void* cmat, const void* h0, \
                                   void* y, void* h_out, int b, int L, int H, int P,  \
                                   int G, int N, int c, void* stream) {               \
    return launch_ssd<T>(x, dt, a, bmat, cmat, h0, y, h_out, b, L, H, P, G, N, c,     \
                         stream);                                                     \
  }

REPRO_SSD_ENTRY_POINT(float, f32)
REPRO_SSD_ENTRY_POINT(__nv_bfloat16, bf16)
