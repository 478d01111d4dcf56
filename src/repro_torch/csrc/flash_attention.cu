// Hand-written Hopper (sm_90a) kernel for GQA softmax attention (K9).
//
// flash_attention_* replaces flash_attention_pallas
// (src/repro/kernels/flash_attention.py:116, body _flash_kernel :33):
//
//   O = softmax(scale * Q K^T + mask) V     Q (b, h, sq, dh), K, V (b, hkv, sk, dh)
//
// query head i reads KV head i / (h / hkv); keys at or past sk are masked and,
// under `causal`, keys above position q_offset + row are masked.  The scores
// never leave the chip: the online softmax carries the running max m (from
// the reference's finite sentinel -1e30, not -inf), the normaliser l and the
// accumulator in f32, and a row whose l ends at 0 is written as zeros.  The
// output is in the inputs' dtype.
//
// What bounds it: operations.  A call does 4 b h sq sk dh flops (half under
// causal masking) on (b h sq + 2 b hkv sk) dh elements read and b h sq dh
// written: at qwen1.5-0.5b's prefill (b 4, h = hkv = 16, s 4096, dh 64,
// causal) 69 GFLOP on 50 MB, far above the card's ~295 flops per byte.
// Its bound is the tensor cores' 989 TFLOP/s (bf16); this first kernel uses
// none: it runs the f32 arithmetic of the Pallas body on the CUDA cores, so
// it sits well above that bound (PERF.md).
//
// Design (simple and right first; mma.sync / wgmma tiles are later work):
//
//   * One 256-thread block per (batch*head, 64-row query tile); blocks are
//     independent, so each output element is written by one block, without
//     atomics, and two launches agree bit for bit.
//   * The query tile sits in shared memory as f32 for the whole block.  Key
//     and value tiles of 64 rows are staged through shared memory as f32
//     (bf16 widened on load), zeros past sk: the kernel masks the ragged
//     edges and the Pallas wrapper's padded copies are not made.
//   * Under causal masking the block visits only key tiles that start at or
//     before its last query row (the tiles above the diagonal are skipped,
//     as the TPU kernel skips them); in visited tiles every element is
//     masked by position.
//   * Per key tile: S = Q K^T with a 4 x 4 register tile per thread (rows
//     ty + 16a, columns tx + 16b), scaled and masked into a 64 x 65 shared
//     tile; four threads per row take the row max and the sum of
//     p = exp(s - m_new) (expf, a fixed order: 16 columns each, then two
//     xor shuffles), update m and l, and leave exp(m_prev - m_new) per row;
//     then each thread rescales and adds P V to its rows ty + 16a and
//     columns tx + 16c of the f32 accumulator held in registers.
//   * dh is a template parameter (16, 32, 64, 128), T float or bf16.  At
//     dh = 128 a block holds 115 KB of shared memory (opt-in above 48 KB).
//
// Plain C interface: the entry point returns cudaGetLastError() (0 = ok) and
// launches on the stream it is given.  The output is allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per staged tile
constexpr int kSub = kBQ / 16;  // rows (and score columns) per thread
constexpr int kLDP = kBK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as a dtype cast does
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (DH + 1) + kBK * DH + kBQ * kLDP + 3 * kBQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int h, int group,
                       int sq, int sk, float scale, int causal, long long q_offset) {
  constexpr int LD = DH + 1;
  constexpr int DSUB = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // kBQ x LD
  float* ks = qs + kBQ * LD;     // kBK x LD
  float* vs = ks + kBK * LD;     // kBK x DH
  float* ps = vs + kBK * DH;     // kBQ x kLDP: scores, then probabilities
  float* m_s = ps + kBQ * kLDP;  // running max per row
  float* l_s = m_s + kBQ;        // running normaliser per row
  float* c_s = l_s + kBQ;        // this tile's correction exp(m_prev - m_new)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int bi = bh / h, head = bh % h;
  const int kvh = bi * (h / group) + head / group;
  const int q0 = blockIdx.x * kBQ;
  const T* qp = q + (size_t)bh * sq * DH;
  const T* kp = k + (size_t)kvh * sk * DH;
  const T* vp = v + (size_t)kvh * sk * DH;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    qs[r * LD + c] = (q0 + r < sq) ? to_f32(qp[(size_t)(q0 + r) * DH + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[kSub][DSUB];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int c = 0; c < DSUB; ++c) acc[a][c] = 0.f;

  const long long q_first = q_offset + q0;  // absolute position of row 0
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const long long last = q_first + kBQ - 1;
    const long long visit = last < 0 ? 0 : last / kBK + 1;
    if (visit < n_tiles) n_tiles = (int)visit;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's ks, vs and ps are consumed
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const bool in = k0 + r < sk;
      ks[r * LD + c] = in ? to_f32(kp[(size_t)(k0 + r) * DH + c]) : 0.f;
      vs[r * DH + c] = in ? to_f32(vp[(size_t)(k0 + r) * DH + c]) : 0.f;
    }
    __syncthreads();

    float s[kSub][kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int b = 0; b < kSub; ++b) s[a][b] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qa[kSub], kb[kSub];
#pragma unroll
      for (int a = 0; a < kSub; ++a) qa[a] = qs[(ty + 16 * a) * LD + d];
#pragma unroll
      for (int b = 0; b < kSub; ++b) kb[b] = ks[(tx + 16 * b) * LD + d];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int b = 0; b < kSub; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int row = ty + 16 * a;
      const long long qpos = q_first + row;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int col = tx + 16 * b;
        const int kpos = k0 + col;
        const bool keep = kpos < sk && (!causal || kpos <= qpos);
        ps[row * kLDP + col] = keep ? s[a][b] * scale : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row, 16 columns each
      const int row = tid / 4, part = tid % 4;
      float* pr = ps + row * kLDP + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        c_s[row] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const float corr = c_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < DSUB; ++c) acc[a][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[kSub], vb[DSUB];
#pragma unroll
      for (int a = 0; a < kSub; ++a) pa[a] = ps[(ty + 16 * a) * kLDP + j];
#pragma unroll
      for (int c = 0; c < DSUB; ++c) vb[c] = vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int c = 0; c < DSUB; ++c) acc[a][c] = fmaf(pa[a], vb[c], acc[a][c]);
    }
  }
  __syncthreads();  // l_s is final

  T* op = o + (size_t)bh * sq * DH;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int row = ty + 16 * a;
    if (q0 + row >= sq) continue;
    float l = l_s[row];
    if (l == 0.f) l = 1.f;  // a row with no visited key gives zeros
#pragma unroll
    for (int c = 0; c < DSUB; ++c)
      op[(size_t)(q0 + row) * DH + tx + 16 * c] = from_f32<T>(acc[a][c] / l);
  }
}

template <typename T, int DH>
int launch_flash(const void* q, const void* k, const void* v, void* o, int b, int h,
                 int hkv, int sq, int sk, double scale, int causal, int64_t q_offset,
                 cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_attention_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, h / hkv, sq, sk, (float)scale, causal, (long long)q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_flash(const void* q, const void* k, const void* v, void* o, int b, int h,
                   int hkv, int sq, int sk, int dh, double scale, int causal,
                   int64_t q_offset, void* stream) {
  if (b <= 0 || h <= 0 || hkv <= 0 || h % hkv || sq <= 0 || sk <= 0 || b * h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_flash<T, 16>(q, k, v, o, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    case 32: return launch_flash<T, 32>(q, k, v, o, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    case 64: return launch_flash<T, 64>(q, k, v, o, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    case 128: return launch_flash<T, 128>(q, k, v, o, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define REPRO_FLASH_ENTRY_POINT(T, SUFFIX)                                          \
  extern "C" int flash_attention_##SUFFIX(                                          \
      const void* q, const void* k, const void* v, void* o, int b, int h, int hkv,  \
      int sq, int sk, int dh, double scale, int causal, int64_t q_offset,           \
      void* stream) {                                                               \
    return dispatch_flash<T>(q, k, v, o, b, h, hkv, sq, sk, dh, scale, causal,      \
                             q_offset, stream);                                     \
  }

REPRO_FLASH_ENTRY_POINT(float, f32)
REPRO_FLASH_ENTRY_POINT(__nv_bfloat16, bf16)
