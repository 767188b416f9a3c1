// Flash-attention forward for Hopper, sm_90a (kernel K1).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// ray_tpu/ops/pallas/flash_attention.py (driven by flash_attention_fwd).
// Computes, per query row i of one (batch, head):
//     o_i = sum_j softmax_j(q'_i . k_j) v_j   over keys j < sk with,
//     when causal, j <= i + offset
// where q' = q * sm_scale rounded to the input type (the TPU kernel folds
// the scale into q the same way). Rows that keep no key give 0.
// With an lse pointer (the training forward) it also writes, per row,
//     lse_i = m_i + log l_i   (f32, layout (b, h, sq))
// the log-sum-exp of the row's kept scores, which the backward kernels
// (flash_attention_bwd.cu) use to rebuild p = exp(q'k - lse). A row that
// keeps no key gets m + log 1 = -1e30, as the TPU kernel writes. A null
// lse (inference, the TPU's with_lse=False) writes nothing more.
//
// Layout: q/o (b, sq, h, d), k/v (b, sk, kvh, d), all contiguous; query
// head hq reads kv head hq / (h / kvh), so GQA needs no repeated K/V copy.
//
// Design: one thread block per (q tile of BQ rows, batch*head). A loop
// over kv tiles of BK keys replaces the TPU grid's sequential axis and
// stops at the last tile the causal diagonal reaches. K/V tiles are staged
// in shared memory as f32; scores, the running max/sum and the output
// accumulator stay in f32 (registers and shared memory). Products are
// plain FMA loops: no tensor cores yet, so at prefill shapes the kernel is
// bound by f32 FMA issue and shared-memory reads, not by device memory.
#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per kv tile
constexpr int NTHREADS = 256;     // 16 x 16 thread grid over the tile

template <int D>
constexpr size_t smem_bytes() {
  // Qs, Ks, Vs (padded rows) + Ps + per-row alpha/m/l
  return sizeof(float) * (3 * (size_t)BQ * (D + 4) + (size_t)BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int sq, int sk, int h, int kvh,
                 int offset, int causal, float scale) {
  static_assert(BQ == BK && BQ == 64, "thread mapping assumes 64 x 64 tiles");
  constexpr int DP = D + 4;       // padded row stride: conflict-free float4 reads
  constexpr int NG = D / 64;      // float4 column groups per thread in P.V
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x DP
  float* Ks = Qs + BQ * DP;                      // BK x DP
  float* Vs = Ks + BK * DP;                      // BK x DP
  float* Ps = Vs + BK * DP;                      // BQ x (BK + 1)
  float* row_alpha = Ps + BQ * (BK + 1);
  float* row_m = row_alpha + BQ;
  float* row_l = row_m + BQ;

  const int bh = blockIdx.y;
  const int b = bh / h;
  const int hq = bh % h;
  const int hk = hq / (h / kvh);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const long q_stride = (long)h * D;      // between consecutive positions
  const long kv_stride = (long)kvh * D;
  const T* qb = q + (long)b * sq * q_stride + (long)hq * D;
  const T* kb = k + (long)b * sk * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * sk * kv_stride + (long)hk * D;
  T* ob = o + (long)b * sq * q_stride + (long)hq * D;

  // stage the scaled q tile (rounded to T, as the TPU kernel folds it)
  for (int c = tid; c < BQ * D / 8; c += NTHREADS) {
    const int r = c / (D / 8);
    const int col = (c % (D / 8)) * 8;
    float x[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (q0 + r < sq) {
      load8(qb + (long)(q0 + r) * q_stride + col, x);
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = round_to(x[e] * scale, q);
    }
    store8(Qs + r * DP + col, x);
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  float acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NG * 4; ++e) acc[i][e] = 0.f;

  // last kv tile this q tile attends to (inclusive); -1 = none
  int last = (sk + BK - 1) / BK - 1;
  if (causal) {
    const int reach = q0 + BQ - 1 + offset;   // last key the last row may see
    last = reach < 0 ? -1 : min(last, reach / BK);
  }

  for (int t = 0; t <= last; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // previous tile consumed (and the q tile staged)
    for (int c = tid; c < BK * D / 8; c += NTHREADS) {
      const int r = c / (D / 8);
      const int col = (c % (D / 8)) * 8;
      float xk[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      float xv[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (k0 + r < sk) {
        load8(kb + (long)(k0 + r) * kv_stride + col, xk);
        load8(vb + (long)(k0 + r) * kv_stride + col, xv);
      }
      store8(Ks + r * DP + col, xk);
      store8(Vs + r * DP + col, xv);
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        const bool keep = kj < sk && (!causal || q0 + r + offset >= kj);
        Ps[r * (BK + 1) + c] = keep ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    // online softmax: each warp owns BQ / 8 rows, each lane two keys
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* pr = Ps + r * (BK + 1);
      const float a = pr[lane];
      const float c = pr[lane + 32];
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = a > 0.5f * NEG_INF ? expf(a - m_new) : 0.f;
      const float pc = c > 0.5f * NEG_INF ? expf(c - m_new) : 0.f;
      const float sum = warp_sum(pa + pc);
      pr[lane] = pa;
      pr[lane + 32] = pc;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        row_alpha[r] = alpha;
        row_l[r] = alpha * row_l[r] + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V: rows ty + 16 i, columns tx * 4 + 64 g
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = row_alpha[ty + 16 * i];
#pragma unroll
      for (int e = 0; e < NG * 4; ++e) acc[i][e] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float4 vv[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        vv[g] = *reinterpret_cast<const float4*>(Vs + kk * DP + tx * 4 + 64 * g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          acc[i][4 * g + 0] = fmaf(p, vv[g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(p, vv[g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p, vv[g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p, vv[g].w, acc[i][4 * g + 3]);
        }
      }
    }
  }
  __syncthreads();   // row_l final (also covers the no-tile case)

  if (lse != nullptr && tid < BQ && q0 + tid < sq) {
    const float l = row_l[tid];
    lse[(long)bh * sq + q0 + tid] = row_m[tid] + logf(l == 0.f ? 1.f : l);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    float l = row_l[r];
    if (l == 0.f) l = 1.f;   // fully masked row -> 0
    T* orow = ob + (long)(q0 + r) * q_stride;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store1(orow + tx * 4 + 64 * g + e, acc[i][4 * g + e] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kvh, int offset, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, b * h);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, h, kvh,
      offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; lse: null, or (b, h, sq) f32. Returns
// a cudaError_t code (0 = ok).
extern "C" int ray_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int b, int sq, int sk, int h, int kvh,
                                       int d, int offset, int causal,
                                       float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, o, l, b, sq, sk, h, kvh, offset, causal, scale, s);
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, o, l, b, sq, sk, h, kvh, offset, causal, scale, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, l, b, sq, sk, h, kvh, offset, causal, scale, s);
  if (dtype == 1 && d == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, l, b, sq, sk, h, kvh, offset, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
