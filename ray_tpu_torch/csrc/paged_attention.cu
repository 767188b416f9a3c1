// Paged decode attention for Hopper, sm_90a (kernel K4).
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// ray_tpu/ops/pallas/paged_attention.py (driven by paged_attention).
// One new token per slot attends to the slot's cached keys by walking its
// block table directly; no gathered (slots, max_len) view is built:
//     s_t = (q . k_t) / sqrt(hd) for t < length,  out = sum_t softmax(s)_t v_t
// in f32, with an online softmax that divides once at the end (a row with
// no live position gives 0: l == 0 divides by 1, as the TPU kernel does).
//
// Layout: q (slots, kvh, g, hd) f32 or bf16 (upcast inside, as the TPU
// kernel does); one layer of the pool, k/v (num_blocks, bs, kvh, hd) f32
// or bf16; tables (slots, width) int32 physical block ids; lengths
// (slots,) int32 valid positions including the new token; out
// (slots, kvh, g, hd) f32.
//
// What bounds it on an H100: it streams the live K/V bytes once and does
// 4 hd flops per (query row, live position): ~4 flops a byte at g 4, far
// below the card's ridge, so it is bound by device memory (8 slots at 1024
// tokens of Llama-3-8B: 33.5 MB, 10 us at 3.35 TB/s) and, at a few slots,
// by the latency of the longest slot's walk. Tensor cores buy nothing: the
// math is f32 FMA.
//
// Design (flash-decoding), one kernel, paged_decode_kernel: one block of 4
// warps per (kv head, slot, split), a split being `span` consecutive table
// entries, sized by the host from the table width alone (it never reads
// lengths).
// - A block loads its slot's length, its span of table entries (into
//   shared memory) and its g query rows (upcast to f32) at once, one
//   round trip. A block whose span starts past its slot's last live entry
//   exits there: it has nothing to add, and the combine below reads only
//   the n_live splits that hold a live entry, which every block of the
//   slot computes from the same length.
// - A split holds at most STAGES stages of TOK positions (TOK / bs pool
//   blocks each; the host caps the span). The block issues the cp.async
//   loads of all its live stages at once, 16 bytes a thread, one group
//   and one buffer a stage, and computes each stage as soon as its group
//   lands while the later ones are in flight; a one-stage split keeps
//   42 KB of shared memory and four blocks share an SM. K and V stay in the pool's dtype in shared memory (K rows padded
//   by PARTS chunks: conflict-free 16-byte reads).
// - Per stage: two threads per position take the dot with all g query
//   rows at once (independent f32 FMA chains) and scale it by 1/sqrt(hd)
//   after the dot, as the TPU kernel does; one warp per row runs the
//   online softmax; each warp adds p v over a quarter of the positions
//   into f32 registers. The warps' sums are added in a fixed order.
// - When the slot has one live split (or none: split 0 then writes 0),
//   that block divides and writes the output. Otherwise each live split
//   writes its unnormalised partial (m, l, acc) to f32 scratch and counts
//   itself on its (slot, kv head)'s counter; the last of them to arrive
//   rescales the partials to their common max, adds them in split order
//   (bitwise deterministic whichever block is last), writes the output
//   and resets the counter to 0 for the next launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXG = 8;            // query rows per kv head (group size)
constexpr int TOK = 64;            // positions per pipeline stage
constexpr int STAGES = 3;          // most stages a split holds
constexpr int PARTS = NTHREADS / TOK;   // threads per position's dot product
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// N consecutive elements at p (N * sizeof(T) = 4, 8 or 16 bytes, aligned
// to that size) as floats, in one shared-memory load
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    static_assert(N == 2, "4, 8 or 16 bytes");
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    static_assert(N == 2, "4, 8 or 16 bytes");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Shared memory, in bytes from a 16-byte aligned base: the K stage
// buffers (nbuf x K_STAGE), the V ones (nbuf x V_STAGE), then the fixed
// part: the g query rows in f32, the scores / probabilities of one stage,
// the rows' m, l and alpha, a flag, the span's table entries.
template <typename T, int HD>
struct Layout {
  static constexpr int CE = 16 / sizeof(T);        // elements per chunk
  static constexpr int NCH = HD / CE;              // 16-byte chunks per row
  static constexpr int KROW = NCH + PARTS;         // padded K row, in chunks
  static constexpr int K_STAGE = TOK * KROW * 16;
  static constexpr int V_STAGE = TOK * NCH * 16;
  static constexpr int Q = 0;                      // MAXG x HD f32
  static constexpr int S = Q + MAXG * HD * 4;      // MAXG x TOK f32: s, then p
  static constexpr int ROW = S + MAXG * TOK * 4;   // m, l, alpha: MAXG f32 each
  static constexpr int FLAG = ROW + 3 * MAXG * 4;  // "this block is last"
  static constexpr int TAB = FLAG + 16;            // span int32
  // the warps' final sums, and the last block's (m, l) staging, reuse the
  // stage buffers (one stage of K and V at least)
  static_assert(NWARPS * MAXG * HD * 4 <= K_STAGE + V_STAGE, "reduction");
  static int bytes(int nbuf, int span) {
    return nbuf * (K_STAGE + V_STAGE) + TAB + 4 * span;
  }
};

template <typename T, int HD, int BS>
__global__ void __launch_bounds__(NTHREADS, 4)
paged_decode_kernel(const void* __restrict__ q, int q_bf16,
                    const T* __restrict__ kp, const T* __restrict__ vp,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, float* __restrict__ part,
                    int* __restrict__ counters, float* __restrict__ out,
                    int kvh, int g, int width, int span, int nsplit,
                    int nbuf) {
  using L = Layout<T, HD>;
  constexpr int CE = L::CE;
  constexpr int NCH = L::NCH;
  constexpr int NB = TOK / BS;           // pool blocks per stage
  constexpr int DPL = HD / 32;           // output dims per lane
  constexpr int CPT = NCH / PARTS;       // K chunks per thread and position
  constexpr int TPW = TOK / NWARPS;      // positions per warp in p v
  static_assert(TOK % BS == 0 && NCH % PARTS == 0, "stage layout");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* bufK = smem;
  uint8_t* bufV = smem + nbuf * L::K_STAGE;
  uint8_t* fixed = bufV + nbuf * L::V_STAGE;
  float* Qs = reinterpret_cast<float*>(fixed + L::Q);
  float* S = reinterpret_cast<float*>(fixed + L::S);
  float* row_m = reinterpret_cast<float*>(fixed + L::ROW);
  float* row_l = row_m + MAXG;
  float* row_alpha = row_l + MAXG;
  int* flag = reinterpret_cast<int*>(fixed + L::FLAG);
  int* tab = reinterpret_cast<int*>(fixed + L::TAB);

  const int hk = blockIdx.x;
  const int slot = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int e_begin = split * span;
  const long head = (long)slot * kvh + hk;

  // one round trip: the length, the span's table entries, the queries
  const int length = lengths[slot];
  for (int i = tid; i < span && e_begin + i < width; i += NTHREADS)
    tab[i] = tables[(long)slot * width + e_begin + i];
  const long q_at = head * g * HD;
  for (int i = tid; i < g * HD; i += NTHREADS)
    Qs[i] = q_bf16 ? __bfloat162float(
                         reinterpret_cast<const __nv_bfloat16*>(q)[q_at + i])
                   : reinterpret_cast<const float*>(q)[q_at + i];
  if (tid < g) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }
  __syncthreads();

  const int live = length > 0 ? (length - 1) / BS + 1 : 0;   // live entries
  // the splits that hold a live entry (split 0 stands for a slot with none)
  const int n_live = max(1, (live + span - 1) / span);
  if (split >= n_live) return;             // block-uniform: nothing to add
  const bool direct = n_live == 1;         // the only split writes out
  const int e_end = min(e_begin + span, live);
  const int nst = e_end > e_begin ? (e_end - e_begin + NB - 1) / NB : 0;
  const long tok_stride = (long)kvh * HD;   // between positions of a block

  // K and V of stage st (span entries st NB ..) into stage buffer st
  auto load_stage = [&](int st) {
    uint8_t* sK = bufK + st * L::K_STAGE;
    uint8_t* sV = bufV + st * L::V_STAGE;
    const int j0 = st * NB;
    for (int c = tid; c < TOK * NCH; c += NTHREADS) {
      const int t = c / NCH;
      const int ch = c % NCH;
      const int j = j0 + t / BS;
      if (e_begin + j >= e_end) break;     // t only grows with c
      const long at = ((long)tab[j] * BS + t % BS) * tok_stride + hk * HD
                      + ch * CE;
      cp_async16(sK + (t * L::KROW + ch) * 16, kp + at);
      cp_async16(sV + (t * NCH + ch) * 16, vp + at);
    }
  };

  // every live stage (nst <= nbuf) in flight at once, one group each
  for (int st = 0; st < nst; ++st) {
    load_stage(st);
    cp_async_commit();
  }

  float acc[MAXG][DPL];
#pragma unroll
  for (int r = 0; r < MAXG; ++r)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;

  const float sqrt_hd = sqrtf((float)HD);
  const int t_dot = tid / PARTS;           // this thread's position ...
  const int part_dot = tid % PARTS;        // ... and chunks part + PARTS c
  for (int st = 0; st < nst; ++st) {
    // stage st has landed once at most nst - 1 - st groups are pending
    const int later = nst - 1 - st;
    if (later >= 2) cp_async_wait<2>();
    else if (later == 1) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();                       // stage st landed for every thread

    const uint8_t* sK = bufK + st * L::K_STAGE;
    const uint8_t* sV = bufV + st * L::V_STAGE;
    const int pos0 = (e_begin + st * NB) * BS;
    const int n_valid = min(TOK, min(e_end * BS, length) - pos0);

    // scores: PARTS threads per position, all g rows at once
    {
      const bool ok = t_dot < n_valid;
      float sc[MAXG];
#pragma unroll
      for (int r = 0; r < MAXG; ++r) sc[r] = 0.f;
      if (ok) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int ch = PARTS * c + part_dot;
          float kf[CE];
          load_f32<CE>(reinterpret_cast<const T*>(
                           sK + (t_dot * L::KROW + ch) * 16), kf);
#pragma unroll
          for (int r = 0; r < MAXG; ++r) {
            if (r < g) {
              const float* qr = Qs + r * HD + ch * CE;
#pragma unroll
              for (int e = 0; e < CE; e += 4) {
                const float4 a = *reinterpret_cast<const float4*>(qr + e);
                sc[r] = fmaf(a.x, kf[e], sc[r]);
                sc[r] = fmaf(a.y, kf[e + 1], sc[r]);
                sc[r] = fmaf(a.z, kf[e + 2], sc[r]);
                sc[r] = fmaf(a.w, kf[e + 3], sc[r]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAXG; ++r) {
        if (r >= g) break;                 // block-uniform
#pragma unroll
        for (int o = 1; o < PARTS; o <<= 1)
          sc[r] += __shfl_xor_sync(FULL, sc[r], o);
        if (part_dot == 0) S[r * TOK + t_dot] = ok ? sc[r] / sqrt_hd : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 4; p replaces s in S
    for (int r = warp; r < g; r += NWARPS) {
      const float s0 = S[r * TOK + lane];
      const float s1 = S[r * TOK + lane + 32];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n_valid ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n_valid ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      S[r * TOK + lane] = p0;
      S[r * TOK + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = alpha * row_l[r] + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc += p v over this warp's TPW positions
#pragma unroll
    for (int r = 0; r < MAXG; ++r) {
      if (r >= g) break;
      const float a = row_alpha[r];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= a;
    }
    const int t_end = min(n_valid, (warp + 1) * TPW);
    for (int t = warp * TPW; t < t_end; ++t) {
      float vf[DPL];
      load_f32<DPL>(reinterpret_cast<const T*>(sV + t * NCH * 16) + lane * DPL,
                    vf);
#pragma unroll
      for (int r = 0; r < MAXG; ++r) {
        if (r >= g) break;
        const float p = S[r * TOK + t];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
  }

  // the warps' sums, added in warp order, through the (idle) stage buffers
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (nst > 0) {
#pragma unroll
    for (int r = 0; r < MAXG; ++r) {
      if (r >= g) break;
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        red[(warp * g + r) * HD + lane * DPL + e] = acc[r][e];
    }
  }
  __syncthreads();
  const long pidx = head * nsplit + split;
  float* part_ml = part + pidx * g * 2;
  float* part_acc =
      part + (long)gridDim.y * kvh * nsplit * g * 2 + pidx * g * HD;
  for (int i = tid; i < g * HD; i += NTHREADS) {
    float sum = 0.f;
    if (nst > 0) {
      sum = red[i];
#pragma unroll
      for (int w = 1; w < NWARPS; ++w) sum += red[w * g * HD + i];
    }
    if (direct) {
      const float l = row_l[i / HD];
      out[head * g * HD + i] = sum / (l == 0.f ? 1.f : l);
    } else {
      part_acc[i] = sum;
    }
  }
  if (direct) return;
  if (tid < g) {
    part_ml[2 * tid] = row_m[tid];
    part_ml[2 * tid + 1] = row_l[tid];
  }

  // the last of the slot's n_live split blocks (for this kv head) to
  // arrive combines: out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
  // over its live splits s, in split order, M their max m_s
  __threadfence();                         // this block's partial, visible
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&counters[head], 1) == n_live - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const float* ml = part + head * nsplit * g * 2;
  const float* accs = part + (long)gridDim.y * kvh * nsplit * g * 2
                      + head * nsplit * g * HD;
  const int ns = n_live;
  float* wsm = reinterpret_cast<float*>(smem);   // g x ns m, then weights
  float* lsm = wsm + g * ns;                     // g x ns l
  float* inv_den = lsm + g * ns;                 // g
  for (int i = tid; i < g * ns; i += NTHREADS) {
    const int s = i / g, r = i % g;
    wsm[r * ns + s] = __ldcg(ml + 2 * i);
    lsm[r * ns + s] = __ldcg(ml + 2 * i + 1);
  }
  __syncthreads();
  if (tid < g) {                           // one thread a row
    float* w = wsm + tid * ns;
    const float* l = lsm + tid * ns;
    float m = NEG_INF;
    for (int s = 0; s < ns; ++s) m = fmaxf(m, w[s]);
    float den = 0.f;
    for (int s = 0; s < ns; ++s) {
      w[s] = expf(w[s] - m);
      den = fmaf(w[s], l[s], den);
    }
    inv_den[tid] = 1.f / (den == 0.f ? 1.f : den);
  }
  __syncthreads();
  // this thread's outputs i = tid + NTHREADS o; the partials of CB splits
  // are loaded at once, then added in split order
  constexpr int OPT = MAXG * HD / NTHREADS;
  constexpr int CB = 8;
  float num[OPT];
#pragma unroll
  for (int o = 0; o < OPT; ++o) num[o] = 0.f;
  for (int s0 = 0; s0 < ns; s0 += CB) {
    float a[CB][OPT];
#pragma unroll
    for (int u = 0; u < CB; ++u)
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
        const int i = tid + NTHREADS * o;
        a[u][o] = s0 + u < ns && i < g * HD
                      ? __ldcg(accs + (long)(s0 + u) * g * HD + i) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < CB; ++u)
#pragma unroll
      for (int o = 0; o < OPT; ++o) {
        const int i = tid + NTHREADS * o;
        if (s0 + u < ns && i < g * HD)
          num[o] = fmaf(wsm[(i / HD) * ns + s0 + u], a[u][o], num[o]);
      }
  }
#pragma unroll
  for (int o = 0; o < OPT; ++o) {
    const int i = tid + NTHREADS * o;
    if (i < g * HD) out[head * g * HD + i] = num[o] * inv_den[i / HD];
  }
  if (tid == 0) counters[head] = 0;        // ready for the next launch
}

template <typename T, int HD, int BS>
int launch(const void* q, int q_bf16, const void* kp, const void* vp,
           const void* tables, const void* lengths, float* part,
           int* counters, float* out, int slots, int kvh, int g, int width,
           int span, cudaStream_t stream) {
  using L = Layout<T, HD>;
  const int nsplit = (width + span - 1) / span;
  const int nbuf = (min(span, width) * BS + TOK - 1) / TOK;   // <= STAGES
  const int smem = L::bytes(nbuf, span);
  // the last block stages the splits' (m, l) in the stage buffers
  if (nsplit > 1
      && (2 * g * nsplit + g) * 4 > nbuf * (L::K_STAGE + L::V_STAGE))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, HD, BS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T, HD, BS>
      <<<dim3(kvh, slots, nsplit), NTHREADS, smem, stream>>>(
          q, q_bf16, static_cast<const T*>(kp), static_cast<const T*>(vp),
          static_cast<const int*>(tables), static_cast<const int*>(lengths),
          part, counters, out, kvh, g, width, span, nsplit, nbuf);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, int q_bf16, const void* kp, const void* vp,
             const void* tables, const void* lengths, float* part,
             int* counters, float* out, int slots, int kvh, int g, int hd,
             int bs, int width, int span, cudaStream_t s) {
#define RAY_PAGED_CASE(HD_, BS_)                                              \
  if (hd == HD_ && bs == BS_)                                                 \
    return launch<T, HD_, BS_>(q, q_bf16, kp, vp, tables, lengths, part,      \
                               counters, out, slots, kvh, g, width, span, s);
  RAY_PAGED_CASE(128, 16)
  RAY_PAGED_CASE(128, 8)
  RAY_PAGED_CASE(128, 32)
  RAY_PAGED_CASE(64, 16)
  RAY_PAGED_CASE(64, 8)
  RAY_PAGED_CASE(64, 32)
#undef RAY_PAGED_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype and dtype (of the pool): 0 = float32, 1 = bfloat16. A split of
// span table entries holds at most STAGES x TOK = 192 positions. With
// nsplit = ceil(width / span) > 1, part is f32 scratch of
// slots * kvh * nsplit * g * (hd + 2) floats and counters int32 of
// slots * kvh, zero before the launch and zero again after it; both may be
// null with one split. Returns a cudaError_t code (0 = ok).
extern "C" int ray_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* lengths, void* part,
                                   void* counters, void* out, int slots,
                                   int kvh, int g, int hd, int bs, int width,
                                   int span, int q_dtype, int dtype,
                                   void* stream) {
  if (g < 1 || g > MAXG || span < 1 || width < 1 || q_dtype < 0
      || q_dtype > 1 || bs < 1 || span * bs > STAGES * TOK)
    return (int)cudaErrorInvalidValue;
  if ((width + span - 1) / span > 1
      && (part == nullptr || counters == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return dispatch<float>(q, q_dtype, kp, vp, tables, lengths, p, c, o,
                           slots, kvh, g, hd, bs, width, span, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, q_dtype, kp, vp, tables, lengths, p, c,
                                   o, slots, kvh, g, hd, bs, width, span, s);
  return (int)cudaErrorInvalidValue;
}
