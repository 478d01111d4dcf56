// Hand-written Hopper (sm_90a) kernels for GQA softmax attention (K9).
//
// flash_attention_* replaces flash_attention_pallas
// (src/repro/kernels/flash_attention.py:116, body _flash_kernel :33,
// pallas_call :158):
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
// causal) 137.4 GFLOP on 50 MB, far above the card's ~295 flops per byte,
// so its bound is the tensor cores' 989 TFLOP/s (bf16): 0.139 ms.
//
// Two kernels, by dtype:
//
// bf16: flash_attention_tc, on the tensor cores (FA2-style mma.sync).
//   * One 128-thread block (4 warps) per (batch*head, 64-row query tile);
//     each warp owns 16 query rows.  Grid (b*h, query tiles), the last
//     query tile first: under causal masking the heaviest tiles launch in
//     the first wave and the light ones fill the tail.
//   * Q (64 x dh), then K and V tiles of 64 keys, go to shared memory by
//     cp.async (16 bytes a copy, zeros past sq / sk, so ragged edges need
//     no padded copies); K/V are double-buffered: tile t + 1 loads while
//     tile t computes.  Rows of dh bf16 are XOR-swizzled in 16-byte chunks
//     (chunk ^ row-group, within each group of 8 chunks; swz below) so
//     that every ldmatrix phase reads 8 rows from 8 distinct bank groups.
//   * Each warp loads its Q fragments once (ldmatrix.x4) and keeps them in
//     registers.  Per KV tile: S = Q K^T by
//     mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (K fragments by
//     ldmatrix.x4), 16 x 64 f32 scores in registers (32 per thread); on
//     tiles that reach past sk or the diagonal, scale by scale*log2(e) and
//     mask by position; online softmax in registers: row max over the quad
//     by two xor shuffles, p = 2^(s*c - m) by one FMA (c = scale*log2(e)
//     folded in, or 1 on a masked tile) and one ex2.approx.ftz (results
//     below 2^-126 flush to 0), the normaliser summed per
//     thread and over the quad once at the end, the accumulator rescaled
//     by 2^(m_prev - m_new).  Then O += P V by the same mma: the score
//     accumulators, packed to bf16 pairs, are the A fragments as they lie
//     (the m16n8 C layout is the m16k16 A layout), V fragments by
//     ldmatrix.x4.trans.
//   * Numerics: P is rounded to bf16 before P V, as in every tensor-core
//     flash kernel (the Pallas body keeps p in f32); l sums the f32 p.
//     flash_attention_plain rounds P the same way for bf16 inputs, so the
//     two differ by summation order (and ex2.approx against exp) alone.
//   * Budget per block: shared memory 640 dh bytes (Q + 2 x (K + V)):
//     10 KB at dh 16, 20 KB at 32, 40 KB at 64, 80 KB at 128, 100 KB at 160
//     (opt-in above 48 KB).  Registers per thread: 32 scores, dh/2 output accumulators,
//     dh/4 Q fragment words (build log: ptxas -v).
//   * What still separates it from its bound: mma.sync reaches about two
//     thirds of the wgmma rate, and the exponentials (one MUFU op per
//     score) and the rescales run on the CUDA cores between the two
//     products of a warp instead of overlapping with another warpgroup's
//     products (FA3's ping-pong); the loads are cp.async, not TMA.
//
// f32: flash_attention_simt, the f32 arithmetic of the Pallas body on the
//   CUDA cores (no tensor cores, no TF32), kept for f32 callers and as the
//   f32 control of chip_smoke.py:
//   * One 256-thread block per (batch*head, 64-row query tile); blocks are
//     independent, so each output element is written by one block, without
//     atomics, and two launches agree bit for bit.
//   * The query tile sits in shared memory as f32 for the whole block.  Key
//     and value tiles of 64 rows are staged through shared memory as f32,
//     zeros past sk: the kernel masks the ragged edges and the Pallas
//     wrapper's padded copies are not made.
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
//   * dh is a template parameter (16, 32, 64, 128, 160: stablelm-12b's
//     5120 / 32).  A block holds 115 KB of shared memory at dh 128 and
//     140 KB at 160 (opt-in above 48 KB).
//
// Both kernels visit the KV tiles in a fixed order and write each output
// tile from one block: two launches agree bit for bit.
//
// Plain C interface: the entry point returns cudaGetLastError() (0 = ok) and
// launches on the stream it is given.  The output is allocated by the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBQ * (DH + 1) + kBK * DH + kBQ * kLDP + 3 * kBQ);
}

template <typename T, int DH, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_attention_simt(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       int h, int group, int sq, int sk, float scale, int causal,
                       long long q_offset) {
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
  if (LSE && tid < kBQ && q0 + tid < sq) {
    const float l = l_s[tid];  // natural-log units: m + log(l)
    lse[(size_t)bh * sq + q0 + tid] = l == 0.f ? INFINITY : m_s[tid] + logf(l);
  }

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

template <typename T, int DH, bool LSE>
int launch_simt(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                int h, int hkv, int sq, int sk, double scale, int causal, int64_t q_offset,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_simt<T, DH, LSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_attention_simt<T, DH, LSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, h, h / hkv, sq, sk, (float)scale, causal, (long long)q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBK = 64;           // keys per staged tile
constexpr int kNT = kBK / 8;      // 8-key column tiles of S
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * DH * (kBQ + 2 * 2 * kBK);  // Q, then K and V twice
}

// Element offset of 16-byte chunk `chunk` of row `row` in a tile of DH-wide
// rows: the chunk index is XORed with the row's group, so the 8 rows an
// ldmatrix phase reads (8 consecutive rows from a multiple of 8, one chunk
// each) fall in 8 distinct 16-byte bank groups.  The XOR stays within the
// chunk's group of 8, so the map is a bijection within each row.  At dh 160
// a row is 20 chunks (320 bytes: rows of one parity start on the same half
// of a 128-byte bank line): the two whole groups of 8 take row & 7 (bank
// group (chunk ^ row ^ 4 (row & 1)) & 7, distinct over 8 rows), the tail
// group of 4 takes (row >> 1) & 3 (the 4 rows of each parity on 4 distinct
// bank groups of their half line).
template <int DH>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int kChunks = DH / 8;
  if constexpr (kChunks % 8 == 0 || kChunks < 8) {
    constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;  // rows per 128 bytes
    constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
    return row * DH + ((chunk ^ ((row / kRowsPerLine) & kMask)) << 3);
  } else {
    static_assert(kChunks % 8 == 4, "a row must be whole groups of 8 chunks and one of 4");
    const int sw = chunk < kChunks - 4 ? chunk ^ (row & 7) : chunk ^ ((row >> 1) & 3);
    return row * DH + (sw << 3);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of a (rows, DH) bf16 matrix into a swizzled tile;
// rows at or past `rows` are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ src, int r0,
                                          int rows) {
  constexpr int kChunks = DH / 8;
#pragma unroll
  for (int i = 0; i < (ROWS * kChunks + kThreads - 1) / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    if (ROWS * kChunks % kThreads && e >= ROWS * kChunks) break;
    const int r = e / kChunks, c = e % kChunks;
    const bool valid = r0 + r < rows;
    cp_async16(tile + swz<DH>(r, c), src + (size_t)(valid ? r0 + r : 0) * DH + c * 8, valid);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), f32 d.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// 2^x by one MUFU.EX2 (exp2f adds a range fix-up for results below 2^-126,
// which only flush to zero here: p < 2^-126 adds nothing next to the row
// max's p = 1).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Fragment layouts (lane = 4 g + t): an m16n8 f32 accumulator holds
// (row g, cols 2t, 2t+1) in d[0..1] and (row g + 8, same cols) in d[2..3];
// an m16k16 A fragment holds (row g, cols 2t..) in a[0], (row g + 8) in
// a[1], cols 8 + 2t.. in a[2] and a[3]; a k16n8 B fragment holds
// (k 2t, 2t+1; col g) in b0 and k + 8 in b1.
template <int DH, bool LSE>
__global__ void __launch_bounds__(kThreads)
flash_attention_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                   int h, int group, int sq, int sk, float scale_log2, int causal,
                   long long q_offset) {
  constexpr int KS = DH / 16;  // k-steps of Q K^T
  constexpr int NO = DH / 8;   // 8-wide column tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kBQ * DH;     // two K tiles
  bf16* vs = ks + 2 * kBK * DH;  // two V tiles

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix and row this lane addresses
  const int bh = blockIdx.x;
  const int bi = bh / h, head = bh % h;
  const int kvh = bi * (h / group) + head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const bf16* qp = q + (size_t)bh * sq * DH;
  const bf16* kp = k + (size_t)kvh * sk * DH;
  const bf16* vp = v + (size_t)kvh * sk * DH;

  const long long q_first = q_offset + q0;              // absolute position of row 0
  const long long w_first = q_first + 16 * warp;        // ... of this warp's row 0
  const int q_rows = sq - q0 < kBQ ? sq - q0 : kBQ;
  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const long long last = q_first + q_rows - 1;
    const long long visit = last < 0 ? 0 : last / kBK + 1;
    if (visit < n_tiles) n_tiles = (int)visit;
  }

  load_tile<DH, kBQ>(qs, qp, q0, sq);
  if (n_tiles > 0) {
    load_tile<DH, kBK>(ks, kp, 0, sk);
    load_tile<DH, kBK>(vs, vp, 0, sk);
  }
  cp_async_commit();

  unsigned qf[KS][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the normaliser

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<DH, kBK>(ks + (stage ^ 1) * kBK * DH, kp, (t + 1) * kBK, sk);
      load_tile<DH, kBK>(vs + (stage ^ 1) * kBK * DH, vp, (t + 1) * kBK, sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but tile t + 1 has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], qs + swz<DH>(16 * warp + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
    }
    const bf16* kt = ks + stage * kBK * DH;
    const bf16* vt = vs + stage * kBK * DH;

    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kNT / 2; ++jp) {  // 16 keys: two column tiles
        unsigned b[4];
        ldsm_x4(b, kt + swz<DH>(16 * jp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1)));
        mma(s[2 * jp], qf[kk], b[0], b[1]);
        mma(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    const int k0 = t * kBK;
    const bool edge = k0 + kBK > sk || (causal && k0 + kBK - 1 > w_first);
    float sc = scale_log2;  // folded into the exponent's FMA below
    if (edge) {             // ... or applied here, before the mask
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          const int kpos = k0 + 8 * n + 2 * t4 + (e & 1);
          const long long qpos = w_first + g + 8 * (e >> 1);
          if (kpos >= sk || (causal && kpos > qpos)) x = kNegInf;
          s[n][e] = x;
        }
      }
      sc = 1.f;
    }

    float m_new[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      m_new[0] = fmaxf(m_new[0], fmaxf(s[n][0], s[n][1]));
      m_new[1] = fmaxf(m_new[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_run[r], quad_max(m_new[r]) * sc);
      const float corr = ex2(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
      l_run[r] *= corr;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[n][e], sc, -m_new[e >> 1]));
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // 16 keys a step
      const unsigned a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {  // 16 output columns: two tiles
        unsigned b[4];
        ldsm_x4_trans(b, vt + swz<DH>(16 * kk + mr + (mi & 1) * 8, 2 * dp + (mi >> 1)));
        mma(acc[2 * dp], a, b[0], b[1]);
        mma(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before tile t + 2 overwrites it
  }
  cp_async_wait<0>();

  bf16* op = o + (size_t)bh * sq * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = quad_sum(l_run[r]);
    const int row = q0 + 16 * warp + g + 8 * r;
    if (LSE && t4 == 0 && row < sq)  // m is in log2 units: (m + log2 l) ln 2
      lse[(size_t)bh * sq + row] = l == 0.f ? INFINITY : (m_run[r] + log2f(l)) * kLn2;
    if (l == 0.f) l = 1.f;  // a row with no visited key gives zeros
    if (row >= sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + (size_t)row * DH + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
  }
}

template <int DH, bool LSE>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h,
           int hkv, int sq, int sk, double scale, int causal, int64_t q_offset,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(  // once per process
      flash_attention_tc<DH, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  flash_attention_tc<DH, LSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, h, h / hkv, sq, sk, (float)(scale * 1.4426950408889634),
      causal, (long long)q_offset);
  return (int)cudaGetLastError();
}

}  // namespace tc


// ---------------------------------------------------------------------------
// Backward and forward-mode arms
// ---------------------------------------------------------------------------
//
// Both take the forward's O and its f32 row log-sum-exp (natural log) and
// recompute P = exp(scale q k^T - lse) tile by tile, so no score matrix is
// kept between the passes.  q_offset is 0 (the wrappers refuse any other).
//
// Backward, three launches (FA2's deterministic layout, no float atomics):
//   rowdot  D_i = sum_c dO_ic O_ic, one thread a row;
//   dkdv    a block owns a 64-key tile of one KV head and loops over the
//           query heads of its GQA group, then every query tile with a row
//           at or past its first key (all of them without causal masking):
//           S and dP = dO V^T, P = exp(S scale - lse), dS = P (dP - D) scale,
//           dV += P^T dO, dK += dS^T Q;
//   dq      a block owns a 64-row query tile (the heaviest first): the same
//           S, dP and dS over the key tiles it sees, dQ += dS K.
//   Every output element is written by one block after a loop in a fixed
//   order: two launches agree bit for bit.  Both kernels recompute S and dP
//   (seven products of the forward's size, not five): dQ partials per key
//   tile summed in a second pass would cost more in bytes (about 2 GB of f32
//   scratch at the training shape) than the two products in operations.
//
// Forward mode (JVP), one launch: a block owns a 64-row query tile and, per
// key tile, forms S and S' = q' k^T + q k'^T, P = exp(S scale - lse) and
// T = P (S' scale), then acc += T V + P V'; each row's r = sum_j T is summed
// per thread, then over the threads that share the row in a fixed order, and
//   O' = acc - r O.
// With the forward's lse no running max or rescale is needed: one pass.
//
// What bounds them: operations.  The backward and the JVP each need five
// products of the forward's size (2.5 x its flops): 343.5 GFLOP at
// qwen1.5-0.5b's training shape (b 4, h 16, s 4096, dh 64, causal), 0.347 ms
// at 989 TFLOP/s bf16.
//
// bf16: attn_bwd_dkdv_tc, attn_bwd_dq_tc, attn_jvp_tc, on the tensor cores
//   (mma.sync m16n8k16, f32 accumulators; the forward's swizzled cp.async
//   tiles, ldmatrix fragments and ex2 exponent):
//   * 128-thread blocks, 16 rows a warp: keys in dkdv (S^T = K Q^T and
//     dP^T = V dO^T, so the key-side outputs accumulate in the warp's
//     registers), queries in dq and jvp.  The warp's own operands (K and V
//     in dkdv; Q and dO in dq; Q and Q' in jvp) are ldmatrix fragments held
//     in registers for the whole loop (dkdv from dh 128 reloads K and V from
//     shared memory each step, dq and jvp at dh 160 their Q, dO and Q', to
//     stay within the register file); the
//     streamed tiles (Q, dO and their lse / D rows in dkdv; K and V in dq;
//     K, K', V, V' in jvp) are double-buffered by cp.async, zeros past sq /
//     sk, so ragged edges need no padded copies.
//   * The second products take the score accumulators packed to bf16 pairs
//     as their A fragments (the m16n8 C layout is the m16k16 A layout), B
//     by ldmatrix.trans: P and dS never touch shared memory.
//   * Positions are masked only on tiles that reach the diagonal or an edge.
//   * Numerics: operands bf16 as given; S, dP and S' in f32; P = 2^(S c -
//     lse log2 e) with c = scale log2 e by ex2.approx; D, r and the lse f32.
//     Rounding to bf16 happens only where a product takes an operand: P for
//     dV, dS for dQ and dK, P and T for the JVP's two output products.  The
//     plain versions round at the same points, so kernel and plain differ by
//     summation order and ex2.approx alone.
//   * Tiles: the steps that stream 64 rows stream 32 at dh 128 (dkdv's query
//     tiles, dq's and jvp's key tiles), and at dh 160 dkdv's query tiles
//     16 (its dK and dV accumulators alone take 160 registers a thread),
//     so that accumulators and fragments fit without spills (ptxas -v in
//     the build log).
//   * What still separates them from their bound: mma.sync's rate (about two
//     thirds of wgmma's), the exponentials between the products of a warp,
//     cp.async instead of TMA, and the two recomputed products.
//
// f32: attn_bwd_dkdv, attn_bwd_dq, attn_jvp, the same schedule in f32
//   arithmetic on the CUDA cores (no TF32): 256-thread blocks, 64 x 64 score
//   tiles with a 4 x 4 register tile a thread (rows ty + 16a, columns
//   tx + 16b), operand tiles staged as f32 through shared memory (zeros past
//   sq / sk), every score of a visited tile masked by position, P and dS (P
//   and T in the JVP) passed through shared memory to the second products.

namespace grad {

// Rows [r0, r0 + 64) of a (rows, DH) matrix into an f32 tile, zeros past rows.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* tile, const T* __restrict__ src, int r0, int rows) {
  constexpr int LD = DH + 1;
  for (int e = threadIdx.x; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    tile[r * LD + c] = r0 + r < rows ? to_f32(src[(size_t)(r0 + r) * DH + c]) : 0.f;
  }
}

__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int r0,
                                           int rows) {
  if (threadIdx.x < kBQ) dst[threadIdx.x] = r0 + threadIdx.x < rows ? src[r0 + threadIdx.x] : 0.f;
}

template <int DH>
constexpr size_t dkdv_smem() { return sizeof(float) * (4 * 64 * (DH + 1) + 2 * 64 * kLDP + 128); }
template <int DH>
constexpr size_t dq_smem() { return sizeof(float) * (4 * 64 * (DH + 1) + 64 * kLDP + 128); }
template <int DH>
constexpr size_t jvp_smem() {
  return sizeof(float) * (4 * 64 * (DH + 1) + 2 * 64 * kLDP + 64 * 17 + 64);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_rowdot(const T* __restrict__ dout, const T* __restrict__ out, float* __restrict__ dvec,
                long long rows) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const T* a = dout + r * DH;
  const T* b = out + r * DH;
  float acc = 0.f;
#pragma unroll 8
  for (int c = 0; c < DH; ++c) acc = fmaf(to_f32(a[c]), to_f32(b[c]), acc);
  dvec[r] = acc;
}

// S = Q K^T and X = A B^T for the thread's 4 x 4 tile: rows of (qs, as_),
// columns of (ks, bs), all four tiles 64 x DH with leading dimension DH + 1.
template <int DH>
__device__ __forceinline__ void two_tiles(const float* qs, const float* ks, const float* as_,
                                          const float* bs, float (&s)[kSub][kSub],
                                          float (&x)[kSub][kSub], int ty, int tx) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int b = 0; b < kSub; ++b) s[a][b] = x[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qa[kSub], aa[kSub], kb[kSub], bb[kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      qa[a] = qs[(ty + 16 * a) * LD + d];
      aa[a] = as_[(ty + 16 * a) * LD + d];
    }
#pragma unroll
    for (int b = 0; b < kSub; ++b) {
      kb[b] = ks[(tx + 16 * b) * LD + d];
      bb[b] = bs[(tx + 16 * b) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        x[a][b] = fmaf(aa[a], bb[b], x[a][b]);
      }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, int h,
              int group, int sq, int sk, float scale, int causal) {
  constexpr int LD = DH + 1;
  constexpr int DSUB = DH / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kBK * LD;
  float* qs = vs + kBK * LD;
  float* dos = qs + kBQ * LD;
  float* ps = dos + kBQ * LD;   // round(P), kBQ x kLDP
  float* dss = ps + kBQ * kLDP;  // dS
  float* lse_s = dss + kBQ * kLDP;
  float* d_s = lse_s + kBQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kv = blockIdx.y, hkv = h / group;
  const int bi = kv / hkv, kh = kv % hkv;
  const int k0 = blockIdx.x * kBK;
  stage<T, DH>(ks, k + (size_t)kv * sk * DH, k0, sk);
  stage<T, DH>(vs, v + (size_t)kv * sk * DH, k0, sk);

  float dk_acc[kSub][DSUB], dv_acc[kSub][DSUB];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int c = 0; c < DSUB; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int t_first = causal ? k0 / kBQ : 0;  // query tiles with a row at or past k0
  for (int gi = 0; gi < group; ++gi) {
    const size_t bh = (size_t)bi * h + kh * group + gi;
    const T* qp = q + bh * sq * DH;
    const T* dop = dout + bh * sq * DH;
    for (int t = t_first; t < n_qt; ++t) {
      const int q0 = t * kBQ;
      __syncthreads();  // the previous tile's qs, dos, ps and dss are consumed
      stage<T, DH>(qs, qp, q0, sq);
      stage<T, DH>(dos, dop, q0, sq);
      stage_rows(lse_s, lse + bh * sq, q0, sq);
      stage_rows(d_s, dvec + bh * sq, q0, sq);
      __syncthreads();

      float s[kSub][kSub], dp[kSub][kSub];
      two_tiles<DH>(qs, ks, dos, vs, s, dp, ty, tx);
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const int i = ty + 16 * a, qrow = q0 + i;
#pragma unroll
        for (int b = 0; b < kSub; ++b) {
          const int j = tx + 16 * b, kpos = k0 + j;
          const bool keep = qrow < sq && kpos < sk && (!causal || kpos <= qrow);
          const float p = keep ? expf(s[a][b] * scale - lse_s[i]) : 0.f;
          ps[i * kLDP + j] = to_f32(from_f32<T>(p));  // as the forward's P V takes P
          dss[i * kLDP + j] = p * (dp[a][b] - d_s[i]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float pa[kSub], sa[kSub], ob[DSUB], qb[DSUB];
#pragma unroll
        for (int a = 0; a < kSub; ++a) {
          pa[a] = ps[i * kLDP + ty + 16 * a];
          sa[a] = dss[i * kLDP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < DSUB; ++c) {
          ob[c] = dos[i * LD + tx + 16 * c];
          qb[c] = qs[i * LD + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < kSub; ++a)
#pragma unroll
          for (int c = 0; c < DSUB; ++c) {
            dv_acc[a][c] = fmaf(pa[a], ob[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(sa[a], qb[c], dk_acc[a][c]);
          }
      }
    }
  }

  T* dkp = dk + (size_t)kv * sk * DH;
  T* dvp = dv + (size_t)kv * sk * DH;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int kpos = k0 + ty + 16 * a;
    if (kpos >= sk) continue;
#pragma unroll
    for (int c = 0; c < DSUB; ++c) {
      dkp[(size_t)kpos * DH + tx + 16 * c] = from_f32<T>(dk_acc[a][c]);
      dvp[(size_t)kpos * DH + tx + 16 * c] = from_f32<T>(dv_acc[a][c]);
    }
  }
}

// Key tiles of `bk` keys a 64-row query tile starting at q0 visits (all of
// them, or under causal masking those that start at or before its last row).
__device__ __forceinline__ int key_tiles(int q0, int sq, int sk, int causal, int bk = kBK) {
  int n = (sk + bk - 1) / bk;
  if (causal) {
    const int last = (sq - q0 < kBQ ? sq : q0 + kBQ) - 1;
    const int visit = last / bk + 1;
    if (visit < n) n = visit;
  }
  return n;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ dvec, T* __restrict__ dq, int h, int group, int sq, int sk,
            float scale, int causal) {
  constexpr int LD = DH + 1;
  constexpr int DSUB = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kBQ * LD;
  float* ks = dos + kBQ * LD;
  float* vs = ks + kBK * LD;
  float* dss = vs + kBK * LD;
  float* lse_s = dss + kBQ * kLDP;
  float* d_s = lse_s + kBQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, bi = bh / h, head = bh % h;
  const int kvh = bi * (h / group) + head / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the heaviest tiles first
  stage<T, DH>(qs, q + (size_t)bh * sq * DH, q0, sq);
  stage<T, DH>(dos, dout + (size_t)bh * sq * DH, q0, sq);
  stage_rows(lse_s, lse + (size_t)bh * sq, q0, sq);
  stage_rows(d_s, dvec + (size_t)bh * sq, q0, sq);
  const T* kp = k + (size_t)kvh * sk * DH;
  const T* vp = v + (size_t)kvh * sk * DH;

  float acc[kSub][DSUB];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int c = 0; c < DSUB; ++c) acc[a][c] = 0.f;

  const int n_tiles = key_tiles(q0, sq, sk, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's ks, vs and dss are consumed
    stage<T, DH>(ks, kp, k0, sk);
    stage<T, DH>(vs, vp, k0, sk);
    __syncthreads();

    float s[kSub][kSub], dp[kSub][kSub];
    two_tiles<DH>(qs, ks, dos, vs, s, dp, ty, tx);
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int i = ty + 16 * a, qrow = q0 + i;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int j = tx + 16 * b, kpos = k0 + j;
        const bool keep = qrow < sq && kpos < sk && (!causal || kpos <= qrow);
        const float p = keep ? expf(s[a][b] * scale - lse_s[i]) : 0.f;
        dss[i * kLDP + j] = p * (dp[a][b] - d_s[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float sa[kSub], kb[DSUB];
#pragma unroll
      for (int a = 0; a < kSub; ++a) sa[a] = dss[(ty + 16 * a) * kLDP + j];
#pragma unroll
      for (int c = 0; c < DSUB; ++c) kb[c] = ks[j * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int c = 0; c < DSUB; ++c) acc[a][c] = fmaf(sa[a], kb[c], acc[a][c]);
    }
  }

  T* dqp = dq + (size_t)bh * sq * DH;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sq) continue;
#pragma unroll
    for (int c = 0; c < DSUB; ++c) dqp[(size_t)row * DH + tx + 16 * c] = from_f32<T>(acc[a][c]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_jvp(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
         const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ tq,
         const T* __restrict__ tk, const T* __restrict__ tv, T* __restrict__ to, int h,
         int group, int sq, int sk, float scale, int causal) {
  constexpr int LD = DH + 1;
  constexpr int DSUB = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* tqs = qs + kBQ * LD;
  float* bufa = tqs + kBQ * LD;  // K, then V
  float* bufb = bufa + kBK * LD;  // K', then V'
  float* ps = bufb + kBK * LD;   // P
  float* ts = ps + kBQ * kLDP;   // T = P (S' scale)
  float* red = ts + kBQ * kLDP;  // kBQ x 17: each row's sum of T over its 16 threads
  float* lse_s = red + kBQ * 17;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y, bi = bh / h, head = bh % h;
  const int kvh = bi * (h / group) + head / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  stage<T, DH>(qs, q + (size_t)bh * sq * DH, q0, sq);
  stage<T, DH>(tqs, tq + (size_t)bh * sq * DH, q0, sq);
  stage_rows(lse_s, lse + (size_t)bh * sq, q0, sq);
  const size_t kvo = (size_t)kvh * sk * DH;

  float acc[kSub][DSUB], rsum[kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    rsum[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DSUB; ++c) acc[a][c] = 0.f;
  }

  const int n_tiles = key_tiles(q0, sq, sk, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's V, V', P and T are consumed
    stage<T, DH>(bufa, k + kvo, k0, sk);
    stage<T, DH>(bufb, tk + kvo, k0, sk);
    __syncthreads();

    float s[kSub][kSub], sd[kSub][kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int b = 0; b < kSub; ++b) s[a][b] = sd[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qa[kSub], tqa[kSub], kb[kSub], tkb[kSub];
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        qa[a] = qs[(ty + 16 * a) * LD + d];
        tqa[a] = tqs[(ty + 16 * a) * LD + d];
      }
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        kb[b] = bufa[(tx + 16 * b) * LD + d];
        tkb[b] = bufb[(tx + 16 * b) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int b = 0; b < kSub; ++b) {
          s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
          sd[a][b] = fmaf(tqa[a], kb[b], sd[a][b]);
          sd[a][b] = fmaf(qa[a], tkb[b], sd[a][b]);
        }
    }
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int i = ty + 16 * a, qrow = q0 + i;
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int j = tx + 16 * b, kpos = k0 + j;
        const bool keep = qrow < sq && kpos < sk && (!causal || kpos <= qrow);
        const float p = keep ? expf(s[a][b] * scale - lse_s[i]) : 0.f;
        const float tt = p * (sd[a][b] * scale);
        ps[i * kLDP + j] = p;
        ts[i * kLDP + j] = tt;
        rsum[a] += tt;
      }
    }
    __syncthreads();  // every thread is done with K and K'
    stage<T, DH>(bufa, v + kvo, k0, sk);
    stage<T, DH>(bufb, tv + kvo, k0, sk);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float ta[kSub], pa[kSub], vb[DSUB], tvb[DSUB];
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        ta[a] = ts[(ty + 16 * a) * kLDP + j];
        pa[a] = ps[(ty + 16 * a) * kLDP + j];
      }
#pragma unroll
      for (int c = 0; c < DSUB; ++c) {
        vb[c] = bufa[j * LD + tx + 16 * c];
        tvb[c] = bufb[j * LD + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int c = 0; c < DSUB; ++c) {
          acc[a][c] = fmaf(ta[a], vb[c], acc[a][c]);
          acc[a][c] = fmaf(pa[a], tvb[c], acc[a][c]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < kSub; ++a) red[(ty + 16 * a) * 17 + tx] = rsum[a];
  __syncthreads();
  const T* op = o + (size_t)bh * sq * DH;
  T* top = to + (size_t)bh * sq * DH;
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = ty + 16 * a, row = q0 + i;
    if (row >= sq) continue;
    float r = 0.f;
    for (int x = 0; x < 16; ++x) r += red[i * 17 + x];  // a fixed order
#pragma unroll
    for (int c = 0; c < DSUB; ++c) {
      const size_t e = (size_t)row * DH + tx + 16 * c;
      top[e] = from_f32<T>(acc[a][c] - r * to_f32(op[e]));
    }
  }
}

template <typename T, int DH>
int launch_bwd_simt(const void* q, const void* k, const void* v, const void* o, const float* lse,
                    const void* dout, void* dq, void* dk, void* dv, float* dvec, int b, int h,
                    int hkv, int sq, int sk, double scale, int causal, cudaStream_t stream) {
  constexpr size_t s1 = dkdv_smem<DH>(), s2 = dq_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_bwd_dq<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)s2);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long long rows = (long long)b * h * sq;
  attn_bwd_rowdot<T, DH><<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      dot, static_cast<const T*>(o), dvec, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv<T, DH><<<dim3((sk + kBK - 1) / kBK, b * hkv), kThreads, s1, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), h, h / hkv, sq, sk,
      (float)scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<T, DH><<<dim3((sq + kBQ - 1) / kBQ, b * h), kThreads, s2, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<T*>(dq), h, h / hkv, sq, sk, (float)scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_jvp_simt(const void* q, const void* k, const void* v, const void* o, const float* lse,
                    const void* tq, const void* tk, const void* tv, void* to, int b, int h,
                    int hkv, int sq, int sk, double scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = jvp_smem<DH>();
  const cudaError_t err = cudaFuncSetAttribute(
      attn_jvp<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_jvp<T, DH><<<dim3((sq + kBQ - 1) / kBQ, b * h), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), lse, static_cast<const T*>(tq), static_cast<const T*>(tk),
      static_cast<const T*>(tv), static_cast<T*>(to), h, h / hkv, sq, sk, (float)scale, causal);
  return (int)cudaGetLastError();
}

// ---- bf16 on the tensor cores ----------------------------------------------

using tc::bf16;

// Rows a streamed step takes, so that the f32 accumulators and fragments
// stay in registers: dkdv's query tiles (kStepQ) 64, 32 at dh 128, 16 at
// 160; dq's and jvp's key tiles (kStepK) 64, 32 from dh 128.  dkdv keeps
// its warp's K and V fragments in registers below dh 128 and reloads them
// from shared memory each step from 128; dq and jvp hold their warp's row
// fragments (Q and dO; Q and Q') up to dh 128 and reload them at 160.
template <int DH>
struct TcTiles {
  static constexpr int kStepQ = DH <= 64 ? 64 : DH <= 128 ? 32 : 16;
  static constexpr int kStepK = DH <= 64 ? 64 : 32;
  static constexpr bool kKeepKV = DH <= 64;
  static constexpr bool kHoldRows = DH <= 128;
};

template <int DH>
constexpr size_t dkdv_tc_smem() {  // K, V; two stages of Q, dO and their lse, D rows
  constexpr int n = TcTiles<DH>::kStepQ;
  return sizeof(bf16) * DH * (2 * 64 + 2 * 2 * n) + sizeof(float) * 2 * 2 * n;
}
template <int DH>
constexpr size_t dq_tc_smem() {  // Q, dO; two stages of K and V
  return sizeof(bf16) * DH * (2 * 64 + 2 * 2 * TcTiles<DH>::kStepK);
}
template <int DH>
constexpr size_t jvp_tc_smem() {  // Q, Q'; two stages of K, K', V and V'
  return sizeof(bf16) * DH * (2 * 64 + 2 * 4 * TcTiles<DH>::kStepK);
}

// Entries [r0, r0 + N) of an f32 row vector into shared memory by threads
// [lo, lo + N), zeros past `rows`.
template <int N>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int rows, int lo) {
  const int i = (int)threadIdx.x - lo;
  if (i >= 0 && i < N) {
    const bool valid = r0 + i < rows;
    tc::cp_async4(dst + i, src + (valid ? r0 + i : 0), valid);
  }
}

// The m16k16 A fragment of rows [r0, r0 + 16) of a swizzled tile, k-step kk.
template <int DH>
__device__ __forceinline__ void ldsm_a(unsigned (&a)[4], const bf16* tile, int r0, int kk) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  tc::ldsm_x4(a, tile + tc::swz<DH>(r0 + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
}

// acc[n] += A B for the n-th 8-row group of `tile` (N rows of DH): B = the
// group's rows transposed, k-step kk; A a warp's 16 x 16 fragment.
template <int DH, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const unsigned (&a)[4],
                                        const bf16* tile, int kk) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int jp = 0; jp < N / 16; ++jp) {
    unsigned b[4];
    tc::ldsm_x4(b, tile + tc::swz<DH>(16 * jp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1)));
    tc::mma(acc[2 * jp], a, b[0], b[1]);
    tc::mma(acc[2 * jp + 1], a, b[2], b[3]);
  }
}

// acc (16 x DH) += round(X) Y: X the warp's 16 x N f32 accumulators, packed
// to bf16 pairs as they lie (the A fragments), Y the N x DH tile (B by
// ldmatrix.trans).
template <int DH, int N>
__device__ __forceinline__ void mma_xy(float (&acc)[DH / 8][4], const float (&x)[N / 8][4],
                                       const bf16* tile) {
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const unsigned a[4] = {tc::pack(x[2 * kk][0], x[2 * kk][1]),
                           tc::pack(x[2 * kk][2], x[2 * kk][3]),
                           tc::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           tc::pack(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      unsigned b[4];
      tc::ldsm_x4_trans(b, tile + tc::swz<DH>(16 * kk + mr + (mi & 1) * 8, 2 * dp + (mi >> 1)));
      tc::mma(acc[2 * dp], a, b[0], b[1]);
      tc::mma(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Rows r0 + g and r0 + g + 8 (below `rows`) of a warp's 16 x DH f32
// accumulator to a (rows, DH) bf16 matrix.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&acc)[DH / 8][4], int r0,
                                           int rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * DH + 8 * n + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dK and dV of a 64-key tile (blockIdx.y) of one KV head (blockIdx.x), warp
// w owning keys k0 + 16 w ...: S^T = K Q^T and dP^T = V dO^T, then P^T and
// dS^T element-wise (element e of column tile n is key g + 8 (e >> 1),
// query 8 n + 2 t + (e & 1)), dV += round(P^T) dO, dK += round(dS^T) Q.
template <int DH>
__global__ void __launch_bounds__(tc::kThreads)
attn_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int group, int sq, int sk,
                 float scale, float scale_log2, int causal) {
  constexpr int KS = DH / 16, NO = DH / 8;
  constexpr int NQ = TcTiles<DH>::kStepQ, NT = NQ / 8;
  constexpr bool KEEP = TcTiles<DH>::kKeepKV;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // 64 x DH
  bf16* vs = ks + 64 * DH;                       // 64 x DH
  bf16* qs = vs + 64 * DH;                       // two stages of NQ x DH
  bf16* dos = qs + 2 * NQ * DH;                  // two stages of NQ x DH
  float* ls = reinterpret_cast<float*>(dos + 2 * NQ * DH);  // two stages of NQ lse
  float* ds = ls + 2 * NQ;                                  // two stages of NQ D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kv = blockIdx.x, hkv = h / group;
  const int bi = kv / hkv, kh = kv % hkv;
  const int k0 = blockIdx.y * 64;
  const int kw = k0 + 16 * warp;  // this warp's first key
  const bf16* kp = k + (size_t)kv * sk * DH;
  const bf16* vp = v + (size_t)kv * sk * DH;

  const int n_qt = (sq + NQ - 1) / NQ;
  const int t_first = causal ? k0 / NQ : 0;  // query tiles with a row at or past k0
  const int per_head = n_qt > t_first ? n_qt - t_first : 0;
  const int n_steps = group * per_head;  // the GQA group's heads, then their tiles

  auto fetch = [&](int i, int st) {  // step i's tiles into stage st
    const size_t bh = (size_t)bi * h + kh * group + i / per_head;
    const int q0 = (t_first + i % per_head) * NQ;
    tc::load_tile<DH, NQ>(qs + st * NQ * DH, q + bh * sq * DH, q0, sq);
    tc::load_tile<DH, NQ>(dos + st * NQ * DH, dout + bh * sq * DH, q0, sq);
    load_rows<NQ>(ls + st * NQ, lse + bh * sq, q0, sq, 0);
    load_rows<NQ>(ds + st * NQ, dvec + bh * sq, q0, sq, NQ);
  };
  tc::load_tile<DH, 64>(ks, kp, k0, sk);
  tc::load_tile<DH, 64>(vs, vp, k0, sk);
  if (n_steps > 0) fetch(0, 0);
  tc::cp_async_commit();

  unsigned kf[KEEP ? KS : 1][4], vf[KEEP ? KS : 1][4];
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int i = 0; i < n_steps; ++i) {
    const int st = i & 1;
    if (i + 1 < n_steps) fetch(i + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // everything but step i + 1 has landed
    __syncthreads();
    if constexpr (KEEP) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_a<DH>(kf[kk], ks, 16 * warp, kk);
          ldsm_a<DH>(vf[kk], vs, 16 * warp, kk);
        }
      }
    }
    const int q0 = (t_first + i % per_head) * NQ;
    const bf16* qt = qs + st * NQ * DH;
    const bf16* dot = dos + st * NQ * DH;
    const float* lt = ls + st * NQ;
    const float* dt = ds + st * NQ;

    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (KEEP) {
        mma_abt<DH, NQ>(s, kf[kk], qt, kk);
        mma_abt<DH, NQ>(dp, vf[kk], dot, kk);
      } else {
        unsigned a[4];
        ldsm_a<DH>(a, ks, 16 * warp, kk);
        mma_abt<DH, NQ>(s, a, qt, kk);
        ldsm_a<DH>(a, vs, 16 * warp, kk);
        mma_abt<DH, NQ>(dp, a, dot, kk);
      }
    }

    const bool edge = q0 + NQ > sq || k0 + 64 > sk || (causal && kw + 15 > q0);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * n + 2 * t4 + (e & 1);  // the query within the tile
        float p = tc::ex2(fmaf(s[n][e], scale_log2, -lt[j] * tc::kLog2e));
        if (edge) {
          const int kpos = kw + g + 8 * (e >> 1), qpos = q0 + j;
          if (qpos >= sq || kpos >= sk || (causal && kpos > qpos)) p = 0.f;
        }
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dt[j]) * scale;
      }
    }
    mma_xy<DH, NQ>(dv_acc, s, dot);  // dV += round(P^T) dO
    mma_xy<DH, NQ>(dk_acc, dp, qt);  // dK += round(dS^T) Q
    __syncthreads();  // this stage is consumed before step i + 2 overwrites it
  }
  tc::cp_async_wait<0>();

  store_rows<DH>(dk + (size_t)kv * sk * DH, dk_acc, kw, sk);
  store_rows<DH>(dv + (size_t)kv * sk * DH, dv_acc, kw, sk);
}

// dQ of a 64-row query tile (the heaviest first) of one head, warp w owning
// rows q0 + 16 w ...: per key tile S = Q K^T and dP = dO V^T, P and dS
// element-wise, dQ += round(dS) K.
template <int DH>
__global__ void __launch_bounds__(tc::kThreads)
attn_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dvec,
               bf16* __restrict__ dq, int h, int group, int sq, int sk, float scale,
               float scale_log2, int causal) {
  constexpr int KS = DH / 16, NO = DH / 8;
  constexpr int BK = TcTiles<DH>::kStepK, NT = BK / 8;
  constexpr bool HOLD = TcTiles<DH>::kHoldRows;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // 64 x DH
  bf16* dos = qs + 64 * DH;                      // 64 x DH
  bf16* ks = dos + 64 * DH;                      // two stages of BK x DH
  bf16* vs = ks + 2 * BK * DH;                   // two stages of BK x DH

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bi = bh / h, head = bh % h;
  const int kvh = bi * (h / group) + head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * tc::kBQ;
  const int qw = q0 + 16 * warp;  // this warp's first row
  const bf16* kp = k + (size_t)kvh * sk * DH;
  const bf16* vp = v + (size_t)kvh * sk * DH;
  const int n_tiles = key_tiles(q0, sq, sk, causal, BK);

  tc::load_tile<DH, 64>(qs, q + (size_t)bh * sq * DH, q0, sq);
  tc::load_tile<DH, 64>(dos, dout + (size_t)bh * sq * DH, q0, sq);
  if (n_tiles > 0) {
    tc::load_tile<DH, BK>(ks, kp, 0, sk);
    tc::load_tile<DH, BK>(vs, vp, 0, sk);
  }
  tc::cp_async_commit();

  float lse2[2], dd[2];  // rows g and g + 8: lse in log2 units, D
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    lse2[r] = row < sq ? lse[(size_t)bh * sq + row] * tc::kLog2e : 0.f;
    dd[r] = row < sq ? dvec[(size_t)bh * sq + row] : 0.f;
  }

  unsigned qf[HOLD ? KS : 1][4], dof[HOLD ? KS : 1][4];
  float acc[NO][4];
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      tc::load_tile<DH, BK>(ks + (st ^ 1) * BK * DH, kp, (t + 1) * BK, sk);
      tc::load_tile<DH, BK>(vs + (st ^ 1) * BK * DH, vp, (t + 1) * BK, sk);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if constexpr (HOLD) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_a<DH>(qf[kk], qs, 16 * warp, kk);
          ldsm_a<DH>(dof[kk], dos, 16 * warp, kk);
        }
      }
    }
    const bf16* kt = ks + st * BK * DH;
    const bf16* vt = vs + st * BK * DH;

    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (HOLD) {
        mma_abt<DH, BK>(s, qf[kk], kt, kk);
        mma_abt<DH, BK>(dp, dof[kk], vt, kk);
      } else {
        unsigned a[4];
        ldsm_a<DH>(a, qs, 16 * warp, kk);
        mma_abt<DH, BK>(s, a, kt, kk);
        ldsm_a<DH>(a, dos, 16 * warp, kk);
        mma_abt<DH, BK>(dp, a, vt, kk);
      }
    }

    const int k0 = t * BK;
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = tc::ex2(fmaf(s[n][e], scale_log2, -lse2[r]));
        if (edge) {
          const int kpos = k0 + 8 * n + 2 * t4 + (e & 1), qpos = qw + g + 8 * r;
          if (kpos >= sk || (causal && kpos > qpos)) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - dd[r]) * scale;
      }
    }
    mma_xy<DH, BK>(acc, dp, kt);  // dQ += round(dS) K
    __syncthreads();
  }
  tc::cp_async_wait<0>();
  store_rows<DH>(dq + (size_t)bh * sq * DH, acc, qw, sq);
}

// The output tangent of a 64-row query tile (the heaviest first) of one
// head, warp w owning rows q0 + 16 w ...: per key tile S = Q K^T and
// S' = Q' K^T + Q K'^T (one accumulator), P, T = P (S' scale) and the
// thread's share of r = sum T, acc += round(T) V + round(P) V'; at the end
// r is summed over the quad and O' = acc - r O.
template <int DH>
__global__ void __launch_bounds__(tc::kThreads)
attn_jvp_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ o, const float* __restrict__ lse,
            const bf16* __restrict__ tq, const bf16* __restrict__ tk,
            const bf16* __restrict__ tv, bf16* __restrict__ to, int h, int group, int sq, int sk,
            float scale, float scale_log2, int causal) {
  constexpr int KS = DH / 16, NO = DH / 8;
  constexpr int BK = TcTiles<DH>::kStepK, NT = BK / 8;
  constexpr bool HOLD = TcTiles<DH>::kHoldRows;
  constexpr int TILE = BK * DH;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // 64 x DH
  bf16* tqs = qs + 64 * DH;                      // 64 x DH
  bf16* kvs = tqs + 64 * DH;                     // two stages of K, K', V, V'

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x, bi = bh / h, head = bh % h;
  const int kvh = bi * (h / group) + head / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * tc::kBQ;
  const int qw = q0 + 16 * warp;
  const size_t kvo = (size_t)kvh * sk * DH;
  const int n_tiles = key_tiles(q0, sq, sk, causal, BK);

  auto fetch = [&](int t, int st) {  // key tile t's four tiles into stage st
    bf16* dst = kvs + st * 4 * TILE;
    tc::load_tile<DH, BK>(dst, k + kvo, t * BK, sk);
    tc::load_tile<DH, BK>(dst + TILE, tk + kvo, t * BK, sk);
    tc::load_tile<DH, BK>(dst + 2 * TILE, v + kvo, t * BK, sk);
    tc::load_tile<DH, BK>(dst + 3 * TILE, tv + kvo, t * BK, sk);
  };
  tc::load_tile<DH, 64>(qs, q + (size_t)bh * sq * DH, q0, sq);
  tc::load_tile<DH, 64>(tqs, tq + (size_t)bh * sq * DH, q0, sq);
  if (n_tiles > 0) fetch(0, 0);
  tc::cp_async_commit();

  float lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    lse2[r] = row < sq ? lse[(size_t)bh * sq + row] * tc::kLog2e : 0.f;
  }

  unsigned qf[HOLD ? KS : 1][4], tqf[HOLD ? KS : 1][4];
  float acc[NO][4];
  float rsum[2] = {0.f, 0.f};
  zero(acc);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) fetch(t + 1, st ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
    if constexpr (HOLD) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          ldsm_a<DH>(qf[kk], qs, 16 * warp, kk);
          ldsm_a<DH>(tqf[kk], tqs, 16 * warp, kk);
        }
      }
    }
    const bf16* kt = kvs + st * 4 * TILE;
    const bf16* tkt = kt + TILE;
    const bf16* vt = kt + 2 * TILE;
    const bf16* tvt = kt + 3 * TILE;

    float s[NT][4], sd[NT][4];
    zero(s);
    zero(sd);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if constexpr (HOLD) {
        mma_abt<DH, BK>(s, qf[kk], kt, kk);
        mma_abt<DH, BK>(sd, tqf[kk], kt, kk);
        mma_abt<DH, BK>(sd, qf[kk], tkt, kk);
      } else {
        unsigned a[4], ta[4];
        ldsm_a<DH>(a, qs, 16 * warp, kk);
        ldsm_a<DH>(ta, tqs, 16 * warp, kk);
        mma_abt<DH, BK>(s, a, kt, kk);
        mma_abt<DH, BK>(sd, ta, kt, kk);
        mma_abt<DH, BK>(sd, a, tkt, kk);
      }
    }

    const int k0 = t * BK;
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > qw);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = tc::ex2(fmaf(s[n][e], scale_log2, -lse2[r]));
        if (edge) {
          const int kpos = k0 + 8 * n + 2 * t4 + (e & 1), qpos = qw + g + 8 * r;
          if (kpos >= sk || (causal && kpos > qpos)) p = 0.f;
        }
        const float tt = p * (sd[n][e] * scale);
        s[n][e] = p;
        sd[n][e] = tt;
        rsum[r] += tt;
      }
    }
    mma_xy<DH, BK>(acc, sd, vt);   // += round(T) V
    mma_xy<DH, BK>(acc, s, tvt);   // += round(P) V'
    __syncthreads();
  }
  tc::cp_async_wait<0>();

  const bf16* op = o + (size_t)bh * sq * DH;
  bf16* top = to + (size_t)bh * sq * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float rr = tc::quad_sum(rsum[r]);  // a fixed order over the quad
    const int row = qw + g + 8 * r;
    if (row >= sq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const size_t e = (size_t)row * DH + 8 * n + 2 * t4;
      const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + e));
      *reinterpret_cast<__nv_bfloat162*>(top + e) =
          __floats2bfloat162_rn(acc[n][2 * r] - rr * of.x, acc[n][2 * r + 1] - rr * of.y);
    }
  }
}

template <int DH>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o, const float* lse,
                  const void* dout, void* dq, void* dk, void* dv, float* dvec, int b, int h,
                  int hkv, int sq, int sk, double scale, int causal, cudaStream_t stream) {
  constexpr size_t s1 = dkdv_tc_smem<DH>(), s2 = dq_tc_smem<DH>();
  static const cudaError_t opt_in1 = cudaFuncSetAttribute(  // once per process
      attn_bwd_dkdv_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  static const cudaError_t opt_in2 = cudaFuncSetAttribute(
      attn_bwd_dq_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (opt_in1 != cudaSuccess) return (int)opt_in1;
  if (opt_in2 != cudaSuccess) return (int)opt_in2;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  const float sl = (float)(scale * 1.4426950408889634);
  const long long rows = (long long)b * h * sq;
  attn_bwd_rowdot<bf16, DH><<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0,
                              stream>>>(dot, static_cast<const bf16*>(o), dvec, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkdv_tc<DH><<<dim3(b * hkv, (sk + 63) / 64), tc::kThreads, s1, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<bf16*>(dk), static_cast<bf16*>(dv), h, h / hkv,
      sq, sk, (float)scale, sl, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_tc<DH><<<dim3(b * h, (sq + tc::kBQ - 1) / tc::kBQ), tc::kThreads, s2, stream>>>(
      qt, kt, vt, dot, lse, dvec, static_cast<bf16*>(dq), h, h / hkv, sq, sk, (float)scale, sl,
      causal);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_jvp_tc(const void* q, const void* k, const void* v, const void* o, const float* lse,
                  const void* tq, const void* tk, const void* tv, void* to, int b, int h, int hkv,
                  int sq, int sk, double scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = jvp_tc_smem<DH>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      attn_jvp_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opt_in != cudaSuccess) return (int)opt_in;
  attn_jvp_tc<DH><<<dim3(b * h, (sq + tc::kBQ - 1) / tc::kBQ), tc::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), lse, static_cast<const bf16*>(tq),
      static_cast<const bf16*>(tk), static_cast<const bf16*>(tv), static_cast<bf16*>(to), h,
      h / hkv, sq, sk, (float)scale, (float)(scale * 1.4426950408889634), causal);
  return (int)cudaGetLastError();
}

// bf16 on the tensor cores, f32 on the CUDA cores.
template <typename T, int DH>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, void* dq, void* dk, void* dv, float* dvec, int b, int h,
               int hkv, int sq, int sk, double scale, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_bwd_tc<DH>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, h, hkv, sq, sk, scale,
                             causal, stream);
  else
    return launch_bwd_simt<T, DH>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, h, hkv, sq, sk,
                                  scale, causal, stream);
}

template <typename T, int DH>
int launch_jvp(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* tq, const void* tk, const void* tv, void* to, int b, int h, int hkv,
               int sq, int sk, double scale, int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_jvp_tc<DH>(q, k, v, o, lse, tq, tk, tv, to, b, h, hkv, sq, sk, scale, causal,
                             stream);
  else
    return launch_jvp_simt<T, DH>(q, k, v, o, lse, tq, tk, tv, to, b, h, hkv, sq, sk, scale,
                                  causal, stream);
}

}  // namespace grad

template <typename T, int DH, bool LSE>
int launch_flash(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                 int h, int hkv, int sq, int sk, double scale, int causal, int64_t q_offset,
                 cudaStream_t stream) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return tc::launch<DH, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, scale, causal, q_offset,
                               stream);
  else
    return launch_simt<T, DH, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, scale, causal,
                                   q_offset, stream);
}

bool bad_shape(int b, int h, int hkv, int sq, int sk) {
  return b <= 0 || h <= 0 || hkv <= 0 || h % hkv || sq <= 0 || sk <= 0 || b * h > 65535 ||
         (sq + kBQ - 1) / kBQ > 65535;
}

template <typename T, bool LSE>
int dispatch_flash(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int h, int hkv, int sq, int sk, int dh, double scale, int causal,
                   int64_t q_offset, void* stream) {
  if (bad_shape(b, h, hkv, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch_flash<T, 16, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    case 32: return launch_flash<T, 32, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    case 64: return launch_flash<T, 64, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    case 128: return launch_flash<T, 128, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    case 160: return launch_flash<T, 160, LSE>(q, k, v, o, lse, b, h, hkv, sq, sk, scale, causal, q_offset, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o, const float* lse,
                 const void* dout, void* dq, void* dk, void* dv, float* dvec, int b, int h,
                 int hkv, int sq, int sk, int dh, double scale, int causal, void* stream) {
  if (bad_shape(b, h, hkv, sq, sk) || (sk + kBK - 1) / kBK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return grad::launch_bwd<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, h, hkv, sq, sk, scale, causal, st);
    case 32: return grad::launch_bwd<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, h, hkv, sq, sk, scale, causal, st);
    case 64: return grad::launch_bwd<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, h, hkv, sq, sk, scale, causal, st);
    case 128: return grad::launch_bwd<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, h, hkv, sq, sk, scale, causal, st);
    case 160: return grad::launch_bwd<T, 160>(q, k, v, o, lse, dout, dq, dk, dv, dvec, b, h, hkv, sq, sk, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_jvp(const void* q, const void* k, const void* v, const void* o, const float* lse,
                 const void* tq, const void* tk, const void* tv, void* to, int b, int h,
                 int hkv, int sq, int sk, int dh, double scale, int causal, void* stream) {
  if (bad_shape(b, h, hkv, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return grad::launch_jvp<T, 16>(q, k, v, o, lse, tq, tk, tv, to, b, h, hkv, sq, sk, scale, causal, st);
    case 32: return grad::launch_jvp<T, 32>(q, k, v, o, lse, tq, tk, tv, to, b, h, hkv, sq, sk, scale, causal, st);
    case 64: return grad::launch_jvp<T, 64>(q, k, v, o, lse, tq, tk, tv, to, b, h, hkv, sq, sk, scale, causal, st);
    case 128: return grad::launch_jvp<T, 128>(q, k, v, o, lse, tq, tk, tv, to, b, h, hkv, sq, sk, scale, causal, st);
    case 160: return grad::launch_jvp<T, 160>(q, k, v, o, lse, tq, tk, tv, to, b, h, hkv, sq, sk, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The forward arms: without the row log-sum-exp (serving) and with it (the
// forward of a differentiated call; lse is (b, h, sq) f32).
#define REPRO_FLASH_ENTRY_POINTS(T, SUFFIX)                                                 \
  extern "C" int flash_attention_##SUFFIX(                                                  \
      const void* q, const void* k, const void* v, void* o, int b, int h, int hkv,          \
      int sq, int sk, int dh, double scale, int causal, int64_t q_offset,                   \
      void* stream) {                                                                       \
    return dispatch_flash<T, false>(q, k, v, o, nullptr, b, h, hkv, sq, sk, dh, scale,      \
                                    causal, q_offset, stream);                              \
  }                                                                                         \
  extern "C" int flash_attention_lse_##SUFFIX(                                              \
      const void* q, const void* k, const void* v, void* o, void* lse, int b, int h,        \
      int hkv, int sq, int sk, int dh, double scale, int causal, int64_t q_offset,          \
      void* stream) {                                                                       \
    return dispatch_flash<T, true>(q, k, v, o, static_cast<float*>(lse), b, h, hkv, sq, sk, \
                                   dh, scale, causal, q_offset, stream);                    \
  }                                                                                         \
  extern "C" int flash_attention_bwd_##SUFFIX(                                              \
      const void* q, const void* k, const void* v, const void* o, const void* lse,          \
      const void* dout, void* dq, void* dk, void* dv, void* dvec, int b, int h, int hkv,    \
      int sq, int sk, int dh, double scale, int causal, void* stream) {                     \
    return dispatch_bwd<T>(q, k, v, o, static_cast<const float*>(lse), dout, dq, dk, dv,    \
                           static_cast<float*>(dvec), b, h, hkv, sq, sk, dh, scale, causal, \
                           stream);                                                         \
  }                                                                                         \
  extern "C" int flash_attention_jvp_##SUFFIX(                                              \
      const void* q, const void* k, const void* v, const void* o, const void* lse,          \
      const void* tq, const void* tk, const void* tv, void* to, int b, int h, int hkv,      \
      int sq, int sk, int dh, double scale, int causal, void* stream) {                     \
    return dispatch_jvp<T>(q, k, v, o, static_cast<const float*>(lse), tq, tk, tv, to, b,   \
                           h, hkv, sq, sk, dh, scale, causal, stream);                      \
  }

REPRO_FLASH_ENTRY_POINTS(float, f32)
REPRO_FLASH_ENTRY_POINTS(__nv_bfloat16, bf16)
