// Flash-attention forward for Hopper, sm_90a (kernel K1).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// ray_tpu/ops/pallas/flash_attention.py (driven by flash_attention_fwd).
// Computes, per query row i of one (batch, head):
//     o_i = sum_j softmax_j(s_ij) v_j,   s_ij = scale * (q_i . k_j)
// over keys j < sk with, when causal, j <= i + offset. Rows that keep no
// key give 0. With an lse pointer (the training forward) it also writes,
// per row, lse_i = log sum_j exp(s_ij) (f32, layout (b, h, sq)), which the
// backward kernels (flash_attention_bwd.cu) use to rebuild
// p = exp(s - lse); a row that keeps no key gets -1e30, as the TPU kernel
// writes. A null lse (inference, the TPU's with_lse=False) writes nothing
// more. The caller folds sm_scale into q as the TPU wrapper does
// (q' = q * sm_scale rounded to the input type; ops/flash_attention.py)
// and passes scale 1 for bf16; the f32 kernel folds and rounds it itself.
//
// Layout: q/o (b, sq, h, d), k/v (b, sk, kvh, d), all contiguous; query
// head hq reads kv head hq / (h / kvh), so GQA needs no repeated K/V copy.
//
// What bounds it on an H100: 4 d flops per kept (query, key) pair. At
// b 1, s 4096, 32/8 heads, d 128, causal that is 137 GFLOP, 0.139 ms at
// the 989 TF/s bf16 tensor-core rate, against ~42 MB moved (12.5 us at
// 3.35 TB/s): operations-bound, so the design is about feeding the tensor
// cores. At a 512-token prefill it is 8.6 GFLOP and ~10.5 MB: bytes and
// launch latency are of the same order there.
//
// bf16 design (flash_fwd_kernel_wgmma), one block of three warpgroups per
// (q tile of BQ = 128 rows, batch * head):
// - warpgroup 0 is the producer: one thread loads the q tile and then
//   streams K and V tiles of BK = 128 keys by TMA into a two-stage ring
//   guarded by mbarriers (full: the bytes landed; empty: both consumers are
//   done with the stage), so the next tile's copy is in flight while the
//   consumers multiply. It gives up its registers (setmaxnreg 24).
// - warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64
//   query rows: S = Q'K^T by wgmma m64n128k16 from shared memory into f32
//   registers; the online softmax in registers (row max and sum over the 4
//   threads that share a row by shuffles, exp2 with log2(e) folded into
//   the scale, masks only on tiles the causal diagonal or the ragged end
//   crosses, tiles above the diagonal skipped); P rounded to bf16 in
//   registers and fed as the register A operand of O += P V (wgmma
//   m64nDk16, V read MN-major from shared memory).
// - epilogue: O / l in registers, rounded to bf16 into the (now idle) q
//   tile's shared memory in the swizzled layout, then one TMA store per
//   64-row half (rows past sq are clipped by the tensor map); lse from
//   registers.
// - the grid runs the heaviest (last) q tiles first, so the longest
//   causal loops do not start in the last wave.
// Operands stay bf16 in shared memory (160 KB at d 128), one block per SM,
// 12 warps. Numerics: scores, the softmax state and O accumulate in f32;
// P is rounded to bf16 before P.V, as the TPU kernel does
// (flash_attention.py:119,126), and the row sum l is taken from the f32 p.
//
// f32 design (flash_fwd_kernel): tensor cores take f32 only as
// TF32, which would break f32 parity, so f32 keeps plain FMA loops: one
// block per (q tile of 64 rows, batch * head), K/V tiles staged in shared
// memory, scores and the softmax state in f32, bound by FMA issue and
// shared-memory reads.
#include "flash_common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------- bf16

namespace tc {

using namespace hopper;

constexpr int BQ = 128;           // query rows per block (64 per consumer)
constexpr int BK = 128;           // keys per kv tile
constexpr int STAGES = 2;         // K/V ring depth
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
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                 // STAGES tiles
  static constexpr int V = K + STAGES * KV_BYTES;       // STAGES tiles
  static constexpr int BAR = V + STAGES * KV_BYTES;
  // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int sq, int sk, int h,
                       int kvh, int offset, int causal, float scale) {
  using L = Layout<D>;
  constexpr int NH = D / 64;                 // 128-byte column halves
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* sQ = smem + L::Q;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + STAGES;
  uint64_t* empty = bar + 1 + 2 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / h;
  const int hq = bh % h;
  const int hk = hq / (h / kvh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first

  // kv tiles this q tile attends to: 0 .. last
  int last = (sk + BK - 1) / BK - 1;
  if (causal) {
    const int reach = q0 + BQ - 1 + offset;   // last key the last row may see
    last = reach < 0 ? -1 : min(last, reach / BK);
  }
  const int ntiles = last + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 8);                // one arrive per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, L::Q_BYTES);
      for (int hh = 0; hh < NH; ++hh)
        for (int rb = 0; rb < BQ / 64; ++rb)
          tma_load(sQ + hh * BQ * 128 + rb * 64 * 128, &tq, q_full, hh * 64,
                   hq, q0 + rb * 64, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        uint8_t* sK = smem + L::K + s * L::KV_BYTES;
        uint8_t* sV = smem + L::V + s * L::KV_BYTES;
        mbar_arrive_tx(&k_full[s], L::KV_BYTES);
        for (int hh = 0; hh < NH; ++hh)
          for (int rb = 0; rb < BK / 64; ++rb)
            tma_load(sK + hh * BK * 128 + rb * 64 * 128, &tk, &k_full[s],
                     hh * 64, hk, t * BK + rb * 64, b);
        mbar_arrive_tx(&v_full[s], L::KV_BYTES);
        for (int hh = 0; hh < NH; ++hh)
          for (int rb = 0; rb < BK / 64; ++rb)
            tma_load(sV + hh * BK * 128 + rb * 64 * 128, &tv, &v_full[s],
                     hh * 64, hk, t * BK + rb * 64, b);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns tile rows 64 cw .. 64 cw + 63
    regs_inc<CONSUMER_REGS>();
    const int ct = threadIdx.x - 128;
    const int cw = ct / 128;
    const int warp = (ct % 128) / 32;
    const int lane = ct % 32;
    const int row0 = cw * 64 + warp * 16 + lane / 4;   // and row0 + 8
    const int first_row = q0 + cw * 64;
    const float scale_log2 = scale * LOG2E;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};     // running max of raw scores
    float l[2] = {0.f, 0.f};                 // this thread's share of the sum

    mbar_wait(q_full, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % STAGES;
      const int phase = (t / STAGES) & 1;
      const int k0 = t * BK;
      const uint8_t* sK = smem + L::K + s * L::KV_BYTES;
      const uint8_t* sV = smem + L::V + s * L::KV_BYTES;

      // S = Q' K^T (64 x BK per warpgroup)
      float sc[BK / 2];
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = desc(sQ + (kk / 4) * BQ * 128 + cw * 64 * 128
                                 + (kk % 4) * 32, 16, 1024);
        const uint64_t db = desc(sK + (kk / 4) * BK * 128 + (kk % 4) * 32,
                                 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // masks only where the ragged end or the causal diagonal crosses
      const bool masked = k0 + BK > sk
                          || (causal && k0 + BK - 1 > first_row + offset);
      if (masked) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kj = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
          const int qi = q0 + row0 + 8 * ((i / 2) % 2);
          if (kj >= sk || (causal && qi + offset < kj)) sc[i] = -INFINITY;
        }
      }

      // online softmax; a row with no key kept so far keeps m = -inf and
      // takes 0 as its reference so exp2(-inf) gives p = 0, never NaN
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float ref[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        ref[r] = (mx[r] == -INFINITY ? 0.f : mx[r]) * scale_log2;
        alpha[r] = exp2f(m[r] * scale_log2 - ref[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -ref[r]));
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

      // P in bf16, as the A operand of O += P V
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      mbar_wait(&v_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc(sV + kk * 16 * 128, BK * 128, 1024);
        if constexpr (D == 128) wgmma_rs_n128(acc, pa[kk], db, 1);
        else wgmma_rs_n64(acc, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: l over the row's 4 threads, O / l, lse
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + row0 + 8 * r;
        if (qi < sq)
          lse[(long)bh * sq + qi] =
              l[r] == 0.f ? flash::NEG_INF : m[r] * scale + logf(l[r]);
      }
    }
    const float inv[2] = {l[0] == 0.f ? 0.f : 1.f / l[0],
                          l[1] == 0.f ? 0.f : 1.f / l[1]};
    // O in bf16 into this warpgroup's rows of the q tile, swizzled as TMA
    // reads them back
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i / 2) % 2;
      const int row = row0 + 8 * r;                  // tile row, = 8k + row%8
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const int chunk = (col % 64) / 8;
      uint8_t* dst = sQ + (col / 64) * BQ * 128 + row * 128
                     + ((chunk ^ (row % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_bf16(acc[i] * inv[r], acc[i + 1] * inv[r]);
    }
    fence_async_smem();
    named_sync(1 + cw, 128);
    if (ct % 128 == 0) {
      for (int hh = 0; hh < NH; ++hh)
        tma_store(&to, sQ + hh * BQ * 128 + cw * 64 * 128, hh * 64, hq,
                  first_row, b);
      tma_store_drain();
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int sk, int h, int kvh, int offset, int causal,
           float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  int err = make_map(&tq, q, D, h, sq, b, 64);
  if (!err) err = make_map(&tk, k, D, kvh, sk, b, 64);
  if (!err) err = make_map(&tv, v, D, kvh, sk, b, 64);
  if (!err) err = make_map(&to, o, D, h, sq, b, 64);
  if (err) return err;
  const int smem = Layout<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(b * h, (sq + BQ - 1) / BQ);
  flash_fwd_kernel_wgmma<D><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, to, lse, sq, sk, h, kvh, offset, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
    return tc::launch<128>(q, k, v, o, l, b, sq, sk, h, kvh, offset, causal, scale, s);
  if (dtype == 1 && d == 64)
    return tc::launch<64>(q, k, v, o, l, b, sq, sk, h, kvh, offset, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
