// Paged decode attention for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel `_decode_kernel` in
// ray_tpu/ops/pallas/paged_attention.py (driven by paged_attention).
// One new token per slot attends to the slot's cached keys by walking its
// block table directly; no gathered (slots, max_len) view is built:
//     s_t = (q . k_t) / sqrt(hd) for t < length,  out = sum_t softmax(s)_t v_t
// in f32, with an online softmax that divides once at the end.
//
// Layout: q (slots, kvh, g, hd) f32; one layer of the pool,
// k/v (num_blocks, bs, kvh, hd); tables (slots, width) int32 physical
// block ids; lengths (slots,) int32 valid positions including the new
// token; out (slots, kvh, g, hd) f32.
//
// Design: one thread block (4 warps) per (kv head, slot). It loops over
// the slot's live table entries only, j <= (length - 1) / bs, and reads
// tables[slot, j] itself. Each pool block's (bs, hd) K and V tiles for the
// block's head are read with strides and staged in shared memory as f32;
// the g query rows of the group sit in shared memory, each warp owns
// query rows and keeps their softmax state and output slice in registers.
// The work is a streaming read of the live K/V bytes: the kernel is bound
// by device memory, and latency-bound at this size because one block per
// (slot, head) leaves SMs idle and the tile loads are not overlapped.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXR = 2;            // query rows per warp: g <= NWARPS * MAXR
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <int HD, int BS>
constexpr size_t smem_bytes(int g) {
  return sizeof(float) * ((size_t)BS * (HD + 4) + (size_t)BS * HD + (size_t)g * HD);
}

template <typename T, int HD, int BS>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int kvh, int g, int width) {
  static_assert(BS <= 32 && 32 % BS == 0, "a warp covers whole blocks");
  constexpr int PARTS = 32 / BS;       // lanes sharing one key's dot product
  constexpr int DPART = HD / PARTS;    // dims per lane in that dot product
  constexpr int KP = HD + 4;           // padded K row: conflict-free float4
  constexpr int DV = HD / 32;          // output dims per lane
  static_assert(DPART % 4 == 0 && HD % 32 == 0, "head_dim layout");
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);   // BS x KP
  float* Vs = Ks + BS * KP;                      // BS x HD
  float* Qs = Vs + BS * HD;                      // g x HD

  const int hk = blockIdx.x;
  const int slot = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int length = lengths[slot];
  const int last = length >= 1 ? (length - 1) / BS : -1;
  const long tok_stride = (long)kvh * HD;        // between positions in a block

  const float* qs = q + ((long)slot * kvh + hk) * g * HD;
  for (int i = tid; i < g * HD; i += NTHREADS) Qs[i] = qs[i];

  float m[MAXR], l[MAXR], acc[MAXR][DV];
#pragma unroll
  for (int ri = 0; ri < MAXR; ++ri) {
    m[ri] = NEG_INF;
    l[ri] = 0.f;
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[ri][e] = 0.f;
  }

  const int t = lane % BS;       // this lane's key within the block
  const int part = lane / BS;    // this lane's slice of head_dim
  const float sqrt_hd = sqrtf((float)HD);
  for (int j = 0; j <= last; ++j) {
    __syncthreads();   // previous tile consumed (and q staged)
    const long phys = tables[(long)slot * width + j];
    const T* kb = kp + (phys * BS * kvh + hk) * HD;
    const T* vb = vp + (phys * BS * kvh + hk) * HD;
    for (int c = tid; c < BS * HD / 8; c += NTHREADS) {
      const int r = c / (HD / 8);
      const int col = (c % (HD / 8)) * 8;
      float x[8];
      load8(kb + r * tok_stride + col, x);
      store8(Ks + r * KP + col, x);
      load8(vb + r * tok_stride + col, x);
      store8(Vs + r * HD + col, x);
    }
    __syncthreads();

#pragma unroll
    for (int ri = 0; ri < MAXR; ++ri) {
      const int r = warp + ri * NWARPS;
      if (r >= g) break;   // warp-uniform
      const float* qr = Qs + r * HD + part * DPART;
      const float* kr = Ks + t * KP + part * DPART;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < DPART; d += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr + d);
        const float4 b = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
        s = fmaf(a.z, b.z, s);
        s = fmaf(a.w, b.w, s);
      }
#pragma unroll
      for (int o = BS; o < 32; o <<= 1) s += __shfl_xor_sync(FULL, s, o);
      s = s / sqrt_hd;   // after the dot, as the TPU kernel scales
      const bool keep = j * BS + t < length;
      s = keep ? s : NEG_INF;
      float mx = s;
#pragma unroll
      for (int o = 1; o < BS; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[ri], mx);
      const float p = keep ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 1; o < BS; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
      const float alpha = expf(m[ri] - m_new);
      l[ri] = alpha * l[ri] + sum;
      m[ri] = m_new;
#pragma unroll
      for (int e = 0; e < DV; ++e) acc[ri][e] *= alpha;
#pragma unroll
      for (int tt = 0; tt < BS; ++tt) {
        const float pt = __shfl_sync(FULL, p, tt);
        const float* vr = Vs + tt * HD + lane;
#pragma unroll
        for (int e = 0; e < DV; ++e) acc[ri][e] = fmaf(pt, vr[32 * e], acc[ri][e]);
      }
    }
  }

  float* os = out + ((long)slot * kvh + hk) * g * HD;
#pragma unroll
  for (int ri = 0; ri < MAXR; ++ri) {
    const int r = warp + ri * NWARPS;
    if (r >= g) break;
    const float lv = l[ri] == 0.f ? 1.f : l[ri];
#pragma unroll
    for (int e = 0; e < DV; ++e) os[r * HD + 32 * e + lane] = acc[ri][e] / lv;
  }
}

template <typename T, int HD, int BS>
int launch(const void* q, const void* kp, const void* vp, const void* tables,
           const void* lengths, void* out, int slots, int kvh, int g,
           int width, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD, BS>(g);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, HD, BS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kvh, slots);
  paged_decode_kernel<T, HD, BS><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<float*>(out), kvh, g,
      width);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp,
             const void* tables, const void* lengths, void* out, int slots,
             int kvh, int g, int hd, int bs, int width, cudaStream_t s) {
#define RAY_PAGED_CASE(HD_, BS_)                                             \
  if (hd == HD_ && bs == BS_)                                                \
    return launch<T, HD_, BS_>(q, kp, vp, tables, lengths, out, slots, kvh, \
                               g, width, s);
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

// dtype (of the pool): 0 = float32, 1 = bfloat16. Returns a cudaError_t
// code (0 = ok).
extern "C" int ray_paged_attention(const void* q, const void* kp,
                                   const void* vp, const void* tables,
                                   const void* lengths, void* out, int slots,
                                   int kvh, int g, int hd, int bs, int width,
                                   int dtype, void* stream) {
  if (g < 1 || g > NWARPS * MAXR) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, kp, vp, tables, lengths, out, slots, kvh, g, hd, bs, width, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, kp, vp, tables, lengths, out, slots, kvh, g, hd, bs, width, s);
  return (int)cudaErrorInvalidValue;
}
