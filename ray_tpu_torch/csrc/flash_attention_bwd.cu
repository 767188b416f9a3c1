// Flash-attention backward for Hopper, sm_90a: kernels K2 (dK, dV) and
// K3 (dQ).
//
// Replaces the Pallas TPU kernels `_dkv_kernel` and `_dq_kernel` in
// ray_tpu/ops/pallas/flash_attention.py (driven by flash_attention_bwd).
// With q' = q * sm_scale rounded to the input type (as the forward K1 and
// both TPU kernels fold it), s = q'k^T, and the forward's lse per query
// row (flash_attention_fwd.cu), every kept (query i, key j) pair has
//     p_ij  = exp(s_ij - lse_i)
//     dS_ij = p_ij * (dO_i . v_j - delta_i)     delta_i = rowsum(dO_i o_i)
// and
//     K2: dV_j = sum_i p_ij dO_i,  dK_j = sum_i dS_ij q'_i
//         (summed over the g = h / kvh query heads that share kv head j)
//     K3: dQ_i = sm_scale * sum_j dS_ij k_j
// A pair is kept when j < sk and, if causal, j <= i + offset; rows and keys
// past the ends are masked here (the TPU wrapper pads to its block size
// instead). Fully masked rows have lse = -1e30 and no kept pair: they get
// zero gradient. For bf16 the caller passes q' already folded
// (ops/flash_attention.py): K2 gets scale 1 and computes
// s = scale * (q . k) and dK = scale * sum dS q, exact for scale 1; K3 gets
// sm_scale itself, which it applies to dQ' once. The f32 kernels take q and
// fold q' = q * scale themselves.
//
// Layout: q/dO/dQ (b, sq, h, d), k/v/dK/dV (b, sk, kvh, d), contiguous;
// lse and delta (b, h, sq) f32.
//
// What bounds them on an H100: K2 does 8d flops per kept pair and K3 6d
// (at b 1, s 4096, 32/8 heads, d 128, causal: 275 and 206 GFLOP, 0.278
// and 0.209 ms at the 989 TF/s bf16 tensor-core rate) and each moves
// ~0.1 GB (~30 us at 3.35 TB/s): operations-bound.
//
// K2, bf16 (flash_dkv_kernel_wgmma): one block of three warpgroups per
// (kv tile of BK = 128 keys, kv head, batch), computed transposed as
// FlashAttention-3 does, so that keys are the M dimension of every
// product and dK, dV never leave registers:
// - warpgroup 0 is the producer: one thread loads the K and V tiles once
//   by TMA, then streams the q' and dO tiles (BQ = 64 rows) of the g query
//   heads of the group, from the causal diagonal on, through a two-stage
//   ring guarded by mbarriers; the warp's lanes copy the matching lse and
//   delta slices beside them. The next tile's copies are in flight while
//   the consumers multiply.
// - warpgroups 1 and 2 each own 64 keys: S^T = K q'^T and dP^T = V dO^T by
//   wgmma m64n64k16 from shared memory; P^T = exp2(S^T log2e - lse log2e)
//   with lse broadcast along columns, rounded to bf16; dS^T = P^T (dP^T -
//   delta), rounded to bf16; then dV += P^T dO and dK += dS^T q' by wgmma
//   m64nDk16 with P^T and dS^T as register A operands and dO, q' read
//   MN-major from shared memory. Masks only on tiles the diagonal or a
//   ragged end crosses; a warpgroup whose keys no row of the tile reaches
//   skips it.
// - dK and dV accumulate in f32 registers over the whole group in a fixed
//   order (no atomics: bitwise deterministic) and leave once, as bf16,
//   through the K/V tiles' shared memory and TMA stores clipped at sk.
// - the grid runs the first kv tiles (the heaviest under causal) first.
// Registers: ptxas reports 228 bytes of spill stores at d 128 (16 at
// d 64), in the consumers: their live set, dK and dV (128 f32 registers
// at d 128), dP^T in flight (32), P^T and dS^T (32) and addressing, is
// just above the 240 registers setmaxnreg gives them. The spills are in
// the measured time (PERF.md).
// Numerics: P and dS are rounded to bf16 before their second products, as
// the TPU kernel does (flash_attention.py:246,254); dS is formed from the
// rounded P, as there. exp is taken in f32 (the TPU takes it in bf16, a
// vector-unit speed trick).
//
// K3, bf16 (flash_dq_kernel_wgmma): one block of three warpgroups per
// (q tile of DQ_BQ = 128 rows, query head, batch), rows the M dimension of
// every product, so dQ never leaves registers:
// - warpgroup 0 is the producer: one thread loads the q' and dO tiles once
//   by TMA while the warp's lanes copy the rows' lse and delta, then it
//   streams the K and V tiles (DQ_BK = 64 keys) of kv head h_q / g, from 0
//   up to the causal diagonal, through a three-stage mbarrier ring.
// - warpgroups 1 and 2 each own 64 rows: S = q'K^T and dP = dO V^T by
//   wgmma m64n64k16, both K-major from shared memory; P = exp2(S log2e -
//   lse log2e) in f32 with lse per row in registers, while dP's product
//   runs; dS = P (dP - delta) rounded to bf16 as the A operand (in
//   registers, as K1 feeds P) of dQ' += dS K by wgmma m64nDk16, K read
//   MN-major from the same swizzled tile, as K1 reads V. Masks only on
//   tiles the diagonal or a ragged end crosses; a warpgroup whose rows
//   reach no key of a tile skips it.
// - dQ' (64 x D f32, 64 registers a thread at d 128) stays in registers
//   over the whole kv loop: no atomics, bitwise deterministic. The
//   epilogue multiplies by sm_scale once, rounds to bf16 and stores through
//   the q' tile's shared memory by TMA, clipped at sq.
// - the grid runs the heaviest (last) causal q tiles first.
// Numerics: dS is rounded to bf16 before dS K, as the TPU kernel does
// (flash_attention.py:297); P stays f32 (the TPU keeps it in bf16, exp's
// argument included); dQ is rounded once, after the scale (the TPU path
// rounds dQ' and then dQ' * sm_scale, flash_attention.py:377).
//
// K2 and K3 for f32 (flash_dkv_kernel, flash_dq_kernel): tensor cores take
// f32 only as TF32, which would break f32 parity, so f32 keeps plain FMA
// loops from shared memory, where p, dS and every product stay f32 until
// the single rounding of each output. K2: one block per (kv tile of 64
// keys, kv head, batch) that stages K and V once and loops over the
// group's query heads and q tiles, summing dK and dV in registers. K3: one
// block per (q tile, query head, batch) reading kv head h_q / g, staging
// q', dO, lse and delta once and looping over kv tiles up to the diagonal,
// sm_scale applied to its f32 sum before one rounding. They are bound by
// FMA issue and shared-memory reads.
#include "flash_common.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------------------ bf16 K2

namespace tc {

using namespace hopper;

constexpr int BK = 128;           // keys per block (64 per consumer)
constexpr int BQ = 64;            // query rows per streamed tile
constexpr int STAGES = 2;         // q'/dO ring depth
constexpr int NTHREADS = 384;     // producer + two consumer warpgroups
// registers per thread after the hand-off; together they must fit in what
// the launch allocated (168 per thread at 384 threads), or the consumers'
// setmaxnreg.inc waits forever for registers the producer never frees
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS
                  <= NTHREADS * (65536 / NTHREADS / 8 * 8),
              "register hand-off exceeds the launch's allocation");
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {                   // byte offsets from a 1024-aligned base
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int ROW_BYTES = BQ * D * 2;
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;                // STAGES tiles
  static constexpr int DO = Q + STAGES * ROW_BYTES;     // STAGES tiles
  static constexpr int LSE = DO + STAGES * ROW_BYTES;   // STAGES x BQ f32
  static constexpr int DELTA = LSE + STAGES * BQ * 4;   // STAGES x BQ f32
  static constexpr int BAR = DELTA + STAGES * BQ * 4;
  // kv_full, full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdk,
                       const __grid_constant__ CUtensorMap tdv,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int sq, int sk,
                       int h, int kvh, int offset, int causal, float scale) {
  using L = Layout<D>;
  constexpr int NH = D / 64;                 // 128-byte column halves
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sK = smem + L::K;
  uint8_t* sV = smem + L::V;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + STAGES;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;   // the first kv tiles, the heaviest
  const int g = h / kvh;            // under causal, launch first
  const int nq = (sq + BQ - 1) / BQ;
  // first q tile whose rows reach key k0 (row + offset >= k0)
  const int first = causal ? max(0, k0 - offset) / BQ : 0;
  const int per_head = max(0, nq - first);
  const int items = g * per_head;   // (query head, q tile) pairs, in order

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);                // the producer warp's lanes
      mbar_init(&empty[s], 8);                // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 streams q', dO (TMA) and lse, delta (loads)
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(kv_full, 2 * L::KV_BYTES);
        for (int hh = 0; hh < NH; ++hh)
          for (int rb = 0; rb < BK / 64; ++rb) {
            const int off = hh * BK * 128 + rb * 64 * 128;
            tma_load(sK + off, &tk, kv_full, hh * 64, hk, k0 + rb * 64, b);
            tma_load(sV + off, &tv, kv_full, hh * 64, hk, k0 + rb * 64, b);
          }
      }
      for (int it = 0; it < items; ++it) {
        const int s = it % STAGES;
        const int hq = hk * g + it / per_head;
        const int q0 = (first + it % per_head) * BQ;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::ROW_BYTES);
          for (int hh = 0; hh < NH; ++hh) {
            tma_load(smem + L::Q + s * L::ROW_BYTES + hh * BQ * 128, &tq,
                     &full[s], hh * 64, hq, q0, b);
            tma_load(smem + L::DO + s * L::ROW_BYTES + hh * BQ * 128, &tdo,
                     &full[s], hh * 64, hq, q0, b);
          }
        }
        float* s_lse = reinterpret_cast<float*>(smem + L::LSE) + s * BQ;
        float* s_delta = reinterpret_cast<float*>(smem + L::DELTA) + s * BQ;
        const long at = ((long)b * h + hq) * sq;
        for (int e = lane; e < BQ; e += 32) {
          const bool ok = q0 + e < sq;
          s_lse[e] = ok ? lse[at + q0 + e] : 0.f;
          s_delta[e] = ok ? delta[at + q0 + e] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns keys kw0 .. kw0 + 63
    regs_inc<CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32;
    const int lane = ct % 32;
    const int kw0 = k0 + cw * 64;
    const int key0 = warp * 16 + lane / 4;       // and key0 + 8, in the 64
    const float scale_log2 = scale * LOG2E;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < items; ++it) {
      const int s = it % STAGES;
      const int q0 = (first + it % per_head) * BQ;
      const uint8_t* sQ = smem + L::Q + s * L::ROW_BYTES;
      const uint8_t* sdO = smem + L::DO + s * L::ROW_BYTES;
      const float* s_lse = reinterpret_cast<const float*>(smem + L::LSE) + s * BQ;
      const float* s_delta =
          reinterpret_cast<const float*>(smem + L::DELTA) + s * BQ;
      mbar_wait(&full[s], (it / STAGES) & 1);
      // no kept pair for these 64 keys: past sk, or above the diagonal
      const bool idle = kw0 >= sk || (causal && q0 + BQ - 1 + offset < kw0);
      if (!idle) {
        // Four wgmma groups: S^T = K q'^T; then dP^T = V dO^T and
        // dV += P^T dO, dV's still running while the threads form dS^T;
        // then dK += dS^T q'. (S^T, dP^T: 64 keys x BQ queries from shared
        // memory; P^T, dS^T from registers, dO and q' read MN-major.)
        // Issuing dP^T beside S^T instead keeps 32 more registers live
        // across P^T's exp, spills more and ran slower (PERF.md).
        float st[BQ / 2], dpt[BQ / 2];
        const uint64_t kdesc = desc(sK + cw * 64 * 128, 16, 1024);
        const uint64_t vdesc = desc(sV + cw * 64 * 128, 16, 1024);
        const uint64_t qdesc = desc(sQ, 16, 1024);
        const uint64_t odesc = desc(sdO, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
          const int bq = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
          wgmma_ss_n64(st, kdesc + a, qdesc + bq, kk > 0);
        }
        wgmma_commit();

        // P^T = exp(S^T - lse), lse broadcast along columns, rounded to
        // bf16
        wgmma_wait<0>();
        fence_regs(st);
        const bool masked = kw0 + 64 > sk || q0 + BQ > sq
                            || (causal && q0 + offset < kw0 + 63);
        uint32_t pa[BQ / 16][4];
#pragma unroll
        for (int i = 0; i < BQ / 2; i += 2) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * (i / 4) + 2 * (lane % 4) + e;   // query
            p[e] = exp2f(fmaf(st[i + e], scale_log2, -s_lse[c] * LOG2E));
            if (masked) {
              const int kj = kw0 + key0 + 8 * ((i / 2) % 2);
              const int qi = q0 + c;
              if (kj >= sk || qi >= sq || (causal && qi + offset < kj))
                p[e] = 0.f;
            }
          }
          pa[i / 8][(i % 8) / 2] = pack_bf16(p[0], p[1]);
        }
        const uint64_t o_mn = desc(sdO, BQ * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = ((kk / 4) * BK * 128 + (kk % 4) * 32) >> 4;
          const int bq = ((kk / 4) * BQ * 128 + (kk % 4) * 32) >> 4;
          wgmma_ss_n64(dpt, vdesc + a, odesc + bq, kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t db = o_mn + ((kk * 16 * 128) >> 4);
          if constexpr (D == 128) wgmma_rs_n128(dv, pa[kk], db, 1);
          else wgmma_rs_n64(dv, pa[kk], db, 1);
        }
        wgmma_commit();

        // dS^T = P^T (dP^T - delta) from the rounded P^T, rounded to bf16
        // (while dV's product runs)
        wgmma_wait<1>();
        fence_regs(dpt);
        uint32_t da[BQ / 16][4];
#pragma unroll
        for (int i = 0; i < BQ / 2; i += 2) {
          const int c = 8 * (i / 4) + 2 * (lane % 4);
          const uint32_t pp = pa[i / 8][(i % 8) / 2];
          da[i / 8][(i % 8) / 2] = pack_bf16(
              __uint_as_float(pp << 16) * (dpt[i] - s_delta[c]),
              __uint_as_float(pp & 0xffff0000u) * (dpt[i + 1] - s_delta[c + 1]));
        }
        const uint64_t q_mn = desc(sQ, BQ * 128, 1024);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint64_t db = q_mn + ((kk * 16 * 128) >> 4);
          if constexpr (D == 128) wgmma_rs_n128(dk, da[kk], db, 1);
          else wgmma_rs_n64(dk, da[kk], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: dK (times scale: q' = q * scale) and dV in bf16 into this
    // warpgroup's rows of the K and V tiles, swizzled, then TMA stores
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = cw * 64 + key0 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int off = (col / 64) * BK * 128 + row * 128
                      + ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(sK + off) =
          pack_bf16(dk[i] * scale, dk[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(sV + off) = pack_bf16(dv[i], dv[i + 1]);
    }
    fence_async_smem();
    named_sync(1 + cw, 128);
    if (ct % 128 == 0) {
      for (int hh = 0; hh < NH; ++hh) {
        const int off = hh * BK * 128 + cw * 64 * 128;
        tma_store(&tdk, sK + off, hh * 64, hk, kw0, b);
        tma_store(&tdv, sV + off, hh * 64, hk, kw0, b);
      }
      tma_store_drain();
    }
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int b, int sq, int sk, int h, int kvh, int offset, int causal,
               float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int err = make_map(&tq, q, D, h, sq, b, BQ);
  if (!err) err = make_map(&tdo, dout, D, h, sq, b, BQ);
  if (!err) err = make_map(&tk, k, D, kvh, sk, b, 64);
  if (!err) err = make_map(&tv, v, D, kvh, sk, b, 64);
  if (!err) err = make_map(&tdk, dk, D, kvh, sk, b, 64);
  if (!err) err = make_map(&tdv, dv, D, kvh, sk, b, 64);
  if (err) return err;
  const int smem = Layout<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(kvh, b, (sk + BK - 1) / BK);
  flash_dkv_kernel_wgmma<D><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, tdo, tdk, tdv, lse, delta, sq, sk, h, kvh, offset, causal,
      scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ bf16 K3

constexpr int DQ_BQ = 128;        // query rows per block (64 per consumer)
constexpr int DQ_BK = 64;         // keys per streamed kv tile
constexpr int DQ_STAGES = 3;      // K/V ring depth

template <int D>
struct DqLayout {                 // byte offsets from a 1024-aligned base
  static constexpr int ROW_BYTES = DQ_BQ * D * 2;
  static constexpr int KV_BYTES = DQ_BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + ROW_BYTES;
  static constexpr int K = DO + ROW_BYTES;                // DQ_STAGES tiles
  static constexpr int V = K + DQ_STAGES * KV_BYTES;      // DQ_STAGES tiles
  static constexpr int LSE = V + DQ_STAGES * KV_BYTES;    // DQ_BQ f32
  static constexpr int DELTA = LSE + DQ_BQ * 4;           // DQ_BQ f32
  static constexpr int BAR = DELTA + DQ_BQ * 4;
  // q_full, k_full[DQ_STAGES], v_full[DQ_STAGES], empty[DQ_STAGES]
  static constexpr int SMEM = BAR + 8 * (1 + 3 * DQ_STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tdq,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, int sq, int sk,
                      int h, int kvh, int offset, int causal, float scale) {
  using L = DqLayout<D>;
  constexpr int NH = D / 64;                 // 128-byte column halves
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem + L::Q;
  uint8_t* sdO = smem + L::DO;
  float* s_lse = reinterpret_cast<float*>(smem + L::LSE);
  float* s_delta = reinterpret_cast<float*>(smem + L::DELTA);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + DQ_STAGES;
  uint64_t* empty = bar + 1 + 2 * DQ_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hq = bh % h;
  const int hk = hq / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;   // heaviest first

  // kv tiles this q tile reaches: 0 .. last
  int last = (sk + DQ_BK - 1) / DQ_BK - 1;
  if (causal) {
    const int reach = q0 + DQ_BQ - 1 + offset;   // last key the last row sees
    last = reach < 0 ? -1 : min(last, reach / DQ_BK);
  }
  const int ntiles = last + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 32);                    // the producer warp's lanes
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);                // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: warp 0 loads q', dO (TMA) and lse, delta (loads) once,
    // then streams the K and V tiles of kv head hk
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(q_full, 2 * L::ROW_BYTES);
        for (int hh = 0; hh < NH; ++hh)
          for (int rb = 0; rb < DQ_BQ / 64; ++rb) {
            const int off = hh * DQ_BQ * 128 + rb * 64 * 128;
            tma_load(sQ + off, &tq, q_full, hh * 64, hq, q0 + rb * 64, b);
            tma_load(sdO + off, &tdo, q_full, hh * 64, hq, q0 + rb * 64, b);
          }
      }
      const long at = ((long)b * h + hq) * sq;
      for (int e = lane; e < DQ_BQ; e += 32) {
        const bool ok = q0 + e < sq;
        s_lse[e] = ok ? lse[at + q0 + e] : 0.f;
        s_delta[e] = ok ? delta[at + q0 + e] : 0.f;
      }
      mbar_arrive(q_full);
      if (lane == 0) {
        for (int t = 0; t < ntiles; ++t) {
          const int s = t % DQ_STAGES;
          if (t >= DQ_STAGES) mbar_wait(&empty[s], ((t / DQ_STAGES) & 1) ^ 1);
          uint8_t* sK = smem + L::K + s * L::KV_BYTES;
          uint8_t* sV = smem + L::V + s * L::KV_BYTES;
          mbar_arrive_tx(&k_full[s], L::KV_BYTES);
          for (int hh = 0; hh < NH; ++hh)
            tma_load(sK + hh * DQ_BK * 128, &tk, &k_full[s], hh * 64, hk,
                     t * DQ_BK, b);
          mbar_arrive_tx(&v_full[s], L::KV_BYTES);
          for (int hh = 0; hh < NH; ++hh)
            tma_load(sV + hh * DQ_BK * 128, &tv, &v_full[s], hh * 64, hk,
                     t * DQ_BK, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows 64 cw .. 64 cw + 63
    regs_inc<CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32;
    const int lane = ct % 32;
    const int row0 = warp * 16 + lane / 4;           // and row0 + 8, in the 64
    const int first_row = q0 + cw * 64;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(q_full, 0);
    // this thread's two rows: lse and delta in registers (lse in log2 units)
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = s_lse[cw * 64 + row0 + 8 * r] * LOG2E;
      dl[r] = s_delta[cw * 64 + row0 + 8 * r];
    }

    for (int t = 0; t < ntiles; ++t) {
      const int s = t % DQ_STAGES;
      const int phase = (t / DQ_STAGES) & 1;
      const int k0 = t * DQ_BK;
      const uint8_t* sK = smem + L::K + s * L::KV_BYTES;
      const uint8_t* sV = smem + L::V + s * L::KV_BYTES;
      // no kept pair for this warpgroup's rows: above the diagonal
      const bool idle = causal && k0 > first_row + 63 + offset;
      mbar_wait(&k_full[s], phase);
      mbar_wait(&v_full[s], phase);
      if (!idle) {
        // S = q'K^T and dP = dO V^T (64 rows x 64 keys each), K-major from
        // shared memory, as two wgmma groups
        float sc[DQ_BK / 2], dp[DQ_BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = (kk / 4) * DQ_BQ * 128 + cw * 64 * 128 + (kk % 4) * 32;
          const int bk = (kk / 4) * DQ_BK * 128 + (kk % 4) * 32;
          wgmma_ss_n64(sc, desc(sQ + a, 16, 1024), desc(sK + bk, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = (kk / 4) * DQ_BQ * 128 + cw * 64 * 128 + (kk % 4) * 32;
          const int bk = (kk / 4) * DQ_BK * 128 + (kk % 4) * 32;
          wgmma_ss_n64(dp, desc(sdO + a, 16, 1024), desc(sV + bk, 16, 1024),
                       kk > 0);
        }
        wgmma_commit();

        // P = exp(S - lse) with lse per row (rows are M here), in f32,
        // while dP's product runs; masks only where the diagonal or the
        // ragged end crosses the tile
        wgmma_wait<1>();
        fence_regs(sc);
        const bool masked = k0 + DQ_BK > sk
                            || (causal && k0 + DQ_BK - 1 > first_row + offset);
#pragma unroll
        for (int i = 0; i < DQ_BK / 2; ++i) {
          const int r = (i / 2) % 2;
          sc[i] = exp2f(fmaf(sc[i], LOG2E, -lse2[r]));
          if (masked) {
            const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
            const int qi = first_row + row0 + 8 * r;
            if (kj >= sk || (causal && qi + offset < kj)) sc[i] = 0.f;
          }
        }

        // dS = P (dP - delta), rounded to bf16: the A operand of dQ += dS K
        wgmma_wait<0>();
        fence_regs(dp);
        uint32_t da[DQ_BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 8 * kk + 2 * e;
            const int r = e % 2;                   // = (i / 2) % 2
            da[kk][e] = pack_bf16(sc[i] * (dp[i] - dl[r]),
                                  sc[i + 1] * (dp[i + 1] - dl[r]));
          }
        // K read MN-major (keys are the reduction), as K1 reads V
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; ++kk) {
          const uint64_t db = desc(sK + kk * 16 * 128, DQ_BK * 128, 1024);
          if constexpr (D == 128) wgmma_rs_n128(dq, da[kk], db, 1);
          else wgmma_rs_n64(dq, da[kk], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
      }
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: dQ = sm_scale * dQ', rounded to bf16 once, into this
    // warpgroup's rows of the q' tile (swizzled), then TMA stores clipped
    // at sq
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = cw * 64 + row0 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int off = (col / 64) * DQ_BQ * 128 + row * 128
                      + ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(sQ + off) =
          pack_bf16(dq[i] * scale, dq[i + 1] * scale);
    }
    fence_async_smem();
    named_sync(1 + cw, 128);
    if (ct % 128 == 0) {
      for (int hh = 0; hh < NH; ++hh)
        tma_store(&tdq, sQ + hh * DQ_BQ * 128 + cw * 64 * 128, hh * 64, hq,
                  first_row, b);
      tma_store_drain();
    }
  }
}

// q is q' = q * sm_scale folded by the caller; scale is sm_scale itself,
// applied once to dQ'.
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int b, int sq,
              int sk, int h, int kvh, int offset, int causal, float scale,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  int err = make_map(&tq, q, D, h, sq, b, 64);
  if (!err) err = make_map(&tdo, dout, D, h, sq, b, 64);
  if (!err) err = make_map(&tk, k, D, kvh, sk, b, 64);
  if (!err) err = make_map(&tv, v, D, kvh, sk, b, 64);
  if (!err) err = make_map(&tdq, dq, D, h, sq, b, 64);
  if (err) return err;
  const int smem = DqLayout<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * h, (sq + DQ_BQ - 1) / DQ_BQ);
  flash_dq_kernel_wgmma<D><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, tdo, tdq, lse, delta, sq, sk, h, kvh, offset, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t code (0 = ok).
// bf16 takes q' (q * sm_scale, folded by the caller) and scale 1; f32
// takes q and sm_scale.
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
#undef RAY_DKV
  if (dtype == 1 && d == 128)
    return tc::launch_dkv<128>(q, k, v, dout, l, dl, dk, dv, b, sq, sk, h,
                               kvh, offset, causal, scale, s);
  if (dtype == 1 && d == 64)
    return tc::launch_dkv<64>(q, k, v, dout, l, dl, dk, dv, b, sq, sk, h,
                              kvh, offset, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 takes q' (folded by the caller) and sm_scale, which multiplies dQ'
// once; f32 takes q and sm_scale, and folds q' itself.
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
#undef RAY_DQ
  if (dtype == 1 && d == 128)
    return tc::launch_dq<128>(q, k, v, dout, l, dl, dq, b, sq, sk, h, kvh,
                              offset, causal, scale, s);
  if (dtype == 1 && d == 64)
    return tc::launch_dq<64>(q, k, v, dout, l, dl, dq, b, sq, sk, h, kvh,
                             offset, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
