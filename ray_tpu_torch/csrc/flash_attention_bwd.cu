// Flash-attention backward for Hopper, sm_90a: kernels K2 (dK, dV) and
// K3 (dQ).
//
// Replaces the Pallas TPU kernels `_dkv_kernel` and `_dq_kernel` in
// ray_tpu/ops/pallas/flash_attention.py (driven by flash_attention_bwd).
// With q' = q * sm_scale rounded to the input type (as the forward K1 and
// both TPU kernels fold it), s = q'k^T, and the forward's lse per query
// row (flash_attention_fwd.cu), every kept (query i, key j) pair has
//     p_ij  = exp(s_ij - lse_i)                 (f32)
//     dS_ij = p_ij * (dO_i . v_j - delta_i)     delta_i = rowsum(dO_i o_i)
// and
//     K2: dV_j = sum_i p_ij dO_i,  dK_j = sum_i dS_ij q'_i
//         (summed over the g = h / kvh query heads that share kv head j)
//     K3: dQ_i = sm_scale * sum_j dS_ij k_j
// A pair is kept when j < sk and, if causal, j <= i + offset; rows and keys
// past the ends are masked here (the TPU wrapper pads to its block size
// instead). Fully masked rows have lse = -1e30 and no kept pair: they get
// zero gradient.
//
// Layout: q/dO/dQ (b, sq, h, d), k/v/dK/dV (b, sk, kvh, d), contiguous;
// lse and delta (b, h, sq) f32.
//
// Numerics: p is exp in f32. The TPU kernels take exp in bf16 for bf16
// inputs, a speed trick for the TPU's vector unit, and round p and dS to
// bf16 before the matrix unit; here p, dS and every product stay f32 until
// the single rounding of each output to the input type. K3 applies sm_scale
// to its f32 sum before that rounding: the TPU path rounds dQ' to the input
// type and then rounds dQ' * sm_scale again (flash_attention.py:377); this
// kernel rounds once.
//
// Design. K2: one thread block per (kv tile of BK keys, kv head, batch). It
// stages its K and V tile once, then loops over the g query heads of its
// group and, in each, over the q tiles from the first one that reaches the
// causal diagonal to the last. dK and dV accumulate in registers in f32 and
// are written once: the group sum happens inside the block, in a fixed
// order, with no atomics and no (b, s, h, d) per-query-head temporaries
// (the TPU path repeats K/V per query head and sums the repeats after).
// K3: one thread block per (q tile of BQ rows, query head, batch), reading
// kv head h_q / g; it stages q', dO, lse and delta once and loops over kv
// tiles up to the last one the causal diagonal reaches, accumulating dQ in
// registers. Both recompute s and dO v^T per tile in one pass over the
// head dimension.
//
// What bounds them on an H100: K2 does 8d flops per kept pair and K3 6d
// (at b 2, s 4096, 32/8 heads, d 128, causal: 0.55 and 0.41 TFLOP, 0.56 and
// 0.42 ms at the 989 TF/s bf16 tensor-core rate) and each moves ~0.2 GB
// (~60 us at 3.35 TB/s): operations-bound. These first kernels multiply
// with f32 FMA loops from shared memory, as K1 does, so they are bound by
// FMA issue and shared-memory reads, far above that bound; wgmma/TMA tiles
// are later work.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int NTHREADS = 256;     // 16 x 16 thread grid over a 64 x 64 tile
constexpr int PS = BK + 1;        // padded row stride of the p / dS tiles

// s[i][j] = q'_r . k_c and dp[i][j] = dO_r . v_c for rows r = ty + 16 i and
// keys c = tx + 16 j of the staged tiles (row stride DP).
template <int D, int DP>
__device__ __forceinline__ void tile_scores(const float* Qs, const float* Ks,
                                            const float* dOs, const float* Vs,
                                            int tx, int ty, float s[4][4],
                                            float dp[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], bk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bk[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, bk[j].x, x);
        x = fmaf(a[i].y, bk[j].y, x);
        x = fmaf(a[i].z, bk[j].z, x);
        x = fmaf(a[i].w, bk[j].w, x);
        s[i][j] = x;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(dOs + (ty + 16 * i) * DP + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bk[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * DP + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = dp[i][j];
        x = fmaf(a[i].x, bk[j].x, x);
        x = fmaf(a[i].y, bk[j].y, x);
        x = fmaf(a[i].z, bk[j].z, x);
        x = fmaf(a[i].w, bk[j].w, x);
        dp[i][j] = x;
      }
  }
}

// acc[i][.] += sum_r w[r][ty + 16 i] * X[r][tx * 4 + 64 g + e] over the 64
// rows r of a (row-major, stride PS) weight tile and a staged tile X: the
// transposed products p^T dO and dS^T q' of K2. With TRANS false the
// weight is read as w[ty + 16 i][r] instead (dS k of K3).
template <int D, int DP, bool TRANS>
__device__ __forceinline__ void tile_accumulate(const float* W, const float* X,
                                                int tx, int ty,
                                                float acc[4][D / 16]) {
  constexpr int NG = D / 64;
#pragma unroll 4
  for (int r = 0; r < 64; ++r) {
    float4 xv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g)
      xv[g] = *reinterpret_cast<const float4*>(X + r * DP + tx * 4 + 64 * g);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = TRANS ? W[r * PS + ty + 16 * i] : W[(ty + 16 * i) * PS + r];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        acc[i][4 * g + 0] = fmaf(w, xv[g].x, acc[i][4 * g + 0]);
        acc[i][4 * g + 1] = fmaf(w, xv[g].y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(w, xv[g].z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(w, xv[g].w, acc[i][4 * g + 3]);
      }
    }
  }
}

// Write rows r0 + ty + 16 i (those below n) of an accumulator, times scale.
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* dst, long stride, int r0, int n,
                                           int tx, int ty, float scale,
                                           const float acc[4][D / 16]) {
  constexpr int NG = D / 64;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= n) continue;
    T* row = dst + (long)r * stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(row + tx * 4 + 64 * g + e, acc[i][4 * g + e] * scale);
  }
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // Ks, Vs, Qs, dOs (padded rows) + Ps, dSs + per-row lse/delta
  return sizeof(float) * (4 * (size_t)64 * (D + 4) + 2 * (size_t)BQ * PS + 2 * BQ);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Qs, dOs, Ks, Vs (padded rows) + dSs + per-row lse/delta
  return sizeof(float) * (4 * (size_t)64 * (D + 4) + (size_t)BQ * PS + 2 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
                 int kvh, int offset, int causal, float scale) {
  static_assert(BQ == BK && BQ == 64, "thread mapping assumes 64 x 64 tiles");
  constexpr int DP = D + 4;       // padded row stride: conflict-free float4 reads
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // BK x DP
  float* Vs = Ks + BK * DP;                      // BK x DP
  float* Qs = Vs + BK * DP;                      // BQ x DP, q' (scaled)
  float* dOs = Qs + BQ * DP;                     // BQ x DP
  float* Ps = dOs + BQ * DP;                     // BQ x PS
  float* dSs = Ps + BQ * PS;                     // BQ x PS
  float* row_lse = dSs + BQ * PS;
  float* row_delta = row_lse + BQ;

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kvh;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const long q_stride = (long)h * D;
  const long kv_stride = (long)kvh * D;
  const long kv_base = (long)b * sk * kv_stride + (long)hk * D;
  stage_tile<D, DP>(Ks, k + kv_base, kv_stride, k0, BK, sk, 1.f, tid, NTHREADS);
  stage_tile<D, DP>(Vs, v + kv_base, kv_stride, k0, BK, sk, 1.f, tid, NTHREADS);

  float acc_dk[4][D / 16], acc_dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;

  // first q tile whose rows reach key k0 (row + offset >= k0)
  const int nq = (sq + BQ - 1) / BQ;
  const int first = causal ? max(0, k0 - offset) / BQ : 0;

  for (int hh = 0; hh < g; ++hh) {
    const int hq = hk * g + hh;
    const long q_base = (long)b * sq * q_stride + (long)hq * D;
    const float* lse_row = lse + ((long)b * h + hq) * sq;
    const float* delta_row = delta + ((long)b * h + hq) * sq;
    for (int t = first; t < nq; ++t) {
      const int q0 = t * BQ;
      __syncthreads();   // the previous tile is consumed (K/V staged)
      stage_tile<D, DP>(Qs, q + q_base, q_stride, q0, BQ, sq, scale, tid, NTHREADS);
      stage_tile<D, DP>(dOs, dout + q_base, q_stride, q0, BQ, sq, 1.f, tid, NTHREADS);
      if (tid < BQ) {
        const bool ok = q0 + tid < sq;
        row_lse[tid] = ok ? lse_row[q0 + tid] : 0.f;
        row_delta[tid] = ok ? delta_row[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_scores<D, DP>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i;
          const int c = tx + 16 * j;
          const int qi = q0 + r;
          const int kj = k0 + c;
          const bool keep = qi < sq && kj < sk && (!causal || qi + offset >= kj);
          const float p = keep ? expf(s[i][j] - row_lse[r]) : 0.f;
          Ps[r * PS + c] = p;
          dSs[r * PS + c] = p * (dp[i][j] - row_delta[r]);
        }
      __syncthreads();

      // dV += p^T dO, dK += dS^T q': keys ty + 16 i, dims tx * 4 + 64 g
      tile_accumulate<D, DP, true>(Ps, dOs, tx, ty, acc_dv);
      tile_accumulate<D, DP, true>(dSs, Qs, tx, ty, acc_dk);
    }
  }

  store_rows<D>(dk + kv_base, kv_stride, k0, sk, tx, ty, 1.f, acc_dk);
  store_rows<D>(dv + kv_base, kv_stride, k0, sk, tx, ty, 1.f, acc_dv);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int sq, int sk, int h, int kvh, int offset,
                int causal, float scale) {
  static_assert(BQ == BK && BQ == 64, "thread mapping assumes 64 x 64 tiles");
  constexpr int DP = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x DP, q' (scaled)
  float* dOs = Qs + BQ * DP;                     // BQ x DP
  float* Ks = dOs + BQ * DP;                     // BK x DP
  float* Vs = Ks + BK * DP;                      // BK x DP
  float* dSs = Vs + BK * DP;                     // BQ x PS
  float* row_lse = dSs + BQ * PS;
  float* row_delta = row_lse + BQ;

  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (h / kvh);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const long q_stride = (long)h * D;
  const long kv_stride = (long)kvh * D;
  const long q_base = (long)b * sq * q_stride + (long)hq * D;
  const long kv_base = (long)b * sk * kv_stride + (long)hk * D;
  stage_tile<D, DP>(Qs, q + q_base, q_stride, q0, BQ, sq, scale, tid, NTHREADS);
  stage_tile<D, DP>(dOs, dout + q_base, q_stride, q0, BQ, sq, 1.f, tid, NTHREADS);
  if (tid < BQ) {
    const bool ok = q0 + tid < sq;
    const long at = ((long)b * h + hq) * sq + q0 + tid;
    row_lse[tid] = ok ? lse[at] : 0.f;
    row_delta[tid] = ok ? delta[at] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[i][e] = 0.f;

  // last kv tile this q tile reaches (inclusive); -1 = none
  int last = (sk + BK - 1) / BK - 1;
  if (causal) {
    const int reach = q0 + BQ - 1 + offset;   // last key the last row may see
    last = reach < 0 ? -1 : min(last, reach / BK);
  }

  for (int t = 0; t <= last; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile is consumed (q' and dO staged)
    stage_tile<D, DP>(Ks, k + kv_base, kv_stride, k0, BK, sk, 1.f, tid, NTHREADS);
    stage_tile<D, DP>(Vs, v + kv_base, kv_stride, k0, BK, sk, 1.f, tid, NTHREADS);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_scores<D, DP>(Qs, Ks, dOs, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        const int qi = q0 + r;
        const int kj = k0 + c;
        const bool keep = qi < sq && kj < sk && (!causal || qi + offset >= kj);
        const float p = keep ? expf(s[i][j] - row_lse[r]) : 0.f;
        dSs[r * PS + c] = p * (dp[i][j] - row_delta[r]);
      }
    __syncthreads();

    // dQ' += dS k: rows ty + 16 i, dims tx * 4 + 64 g
    tile_accumulate<D, DP, false>(dSs, Ks, tx, ty, acc);
  }

  store_rows<D>(dq + q_base, q_stride, q0, sq, tx, ty, scale, acc);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int b, int sq, int sk, int h, int kvh, int offset, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sk + BK - 1) / BK, kvh, b);
  flash_dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, kvh, offset,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int b, int sq,
              int sk, int h, int kvh, int offset, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), sq, sk, h, kvh, offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = ok).
extern "C" int ray_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int b, int sq,
    int sk, int h, int kvh, int d, int offset, int causal, float scale,
    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define RAY_DKV(T, D) \
  return launch_dkv<T, D>(q, k, v, dout, l, dl, dk, dv, b, sq, sk, h, kvh, \
                          offset, causal, scale, s)
  if (dtype == 0 && d == 128) RAY_DKV(float, 128);
  if (dtype == 0 && d == 64) RAY_DKV(float, 64);
  if (dtype == 1 && d == 128) RAY_DKV(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) RAY_DKV(__nv_bfloat16, 64);
#undef RAY_DKV
  return (int)cudaErrorInvalidValue;
}

extern "C" int ray_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int b, int sq, int sk,
    int h, int kvh, int d, int offset, int causal, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define RAY_DQ(T, D) \
  return launch_dq<T, D>(q, k, v, dout, l, dl, dq, b, sq, sk, h, kvh, offset, \
                         causal, scale, s)
  if (dtype == 0 && d == 128) RAY_DQ(float, 128);
  if (dtype == 0 && d == 64) RAY_DQ(float, 64);
  if (dtype == 1 && d == 128) RAY_DQ(__nv_bfloat16, 128);
  if (dtype == 1 && d == 64) RAY_DQ(__nv_bfloat16, 64);
#undef RAY_DQ
  return (int)cudaErrorInvalidValue;
}
