// Probabilistic depth regression over the plane axis of a cost volume.
//
// Replaces: enerf_tpu/ops/pallas/reductions.py, depth_regression_pallas
// (kernel _depth_reg_kernel), the forward of depth_regression_fused. The
// backward stays the plain version's autograd (the JAX package recomputes
// its jnp reference there too).
//
// Computes, for every pixel (b, y, x), over its D planes:
//   p_d   = softmax_d(logits[b, d, y, x])                       (f32)
//   v_d   = values[b, d, y, x], or 1 / max(v_d, 1e-6) when depth_inv
//   depth = sum_d p_d v_d
//   std   = sqrt(max(sum_d p_d (v_d - depth)^2, 1e-10))
// logits, values (B, D, H, W) contiguous, both f32 or both bf16; depth, std
// (B, H, W) in the input type. The arithmetic is f32 for either type, as in
// the TPU kernel.
//
// What bounds it on the H100: memory, and at the cascade's sizes (2.7 MB
// at level 0, 5.9 MB at level 1 of the 512x640 frame, ~1-2 us of HBM time)
// the launch and the latency of one round of loads. Design:
// - A warp covers 32 consecutive pixels (lane = pixel, so each plane's
//   read is one coalesced line) and one of G plane groups; a block holds
//   the G groups of `tiles` such pixel tiles. A thread loads its PPT
//   planes (template: 1, 2, 4 or 8) of both tensors into registers in one
//   round, so the whole volume is in flight at once, and
//   reduces them to a central partial: m = max logit, s = sum e,
//   mu = sum e v / s, M2 = sum e (v - mu)^2 with e = exp(logit - m). The
//   host gives a thread 8 planes (the least power of two >= D when D < 8),
//   so G = ceil(D / 8): level 0 (5,120 pixels x 48-64 planes) makes 160
//   blocks of 6-8 warps, level 1 (81,920 pixels x 8 planes) one group, and
//   a block of one group takes 4 pixel tiles (2 for two groups): 2,560
//   one-warp blocks at level 1 ran slower than 640 four-warp ones.
// - Groups merge through shared memory in one barrier, with Chan's parallel
//   update: each partial's s and M2 rescaled by exp(m_g - m), the means
//   combined, M2 = sum_g (M2_g + s_g (mu_g - mu)^2). Central moments
//   throughout: the one-pass sum v^2 - depth^2 cancels badly at level 1,
//   whose planes lie within +-std of each other.
// - More than 32 groups' worth of planes (D > 32 PPT): a thread walks its
//   planes in chunks of PPT, merging each chunk's partial into its own.
// A partial with no planes (or only -inf logits) has s = 0 and takes no
// part in a merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroups = 32;        // 1024 threads a block

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// (m, s, mu, M2) as x, y, z, w
__device__ __forceinline__ float4 empty_partial() {
  return make_float4(-INFINITY, 0.f, 0.f, 0.f);
}

// Chan's pairwise update of two partials.
__device__ __forceinline__ float4 merge(float4 a, float4 b) {
  if (b.y == 0.f) return a;
  if (a.y == 0.f) return b;
  const float m = fmaxf(a.x, b.x);
  const float wa = expf(a.x - m), wb = expf(b.x - m);
  const float sa = a.y * wa, sb = b.y * wb, s = sa + sb;
  const float delta = b.z - a.z, fb = sb / s;
  return make_float4(m, s, a.z + delta * fb,
                     a.w * wa + b.w * wb + delta * delta * sa * fb);
}

// The partial of planes d0 .. d0 + PPT - 1 (those below D) of one pixel.
template <int PPT, typename T>
__device__ __forceinline__ float4 chunk_partial(const T* l, const T* v,
                                                int d0, int D, long long P,
                                                int depth_inv) {
  float lg[PPT], vv[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int d = d0 + k;
    lg[k] = d < D ? load_f32(l + d * P) : -INFINITY;
    vv[k] = d < D ? load_f32(v + d * P) : 1.f;
  }
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < PPT; ++k) m = fmaxf(m, lg[k]);
  if (m == -INFINITY) return empty_partial();
  float e[PPT], s = 0.f, sev = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (depth_inv) vv[k] = 1.f / fmaxf(vv[k], 1e-6f);
    e[k] = expf(lg[k] - m);          // 0 for a masked plane
    s += e[k];
    sev += e[k] * vv[k];
  }
  const float mu = sev / s;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const float diff = vv[k] - mu;
    m2 += e[k] * diff * diff;
  }
  return make_float4(m, s, mu, m2);
}

template <int PPT, typename T>
__global__ void __launch_bounds__(kWarp * kMaxGroups)
depth_regression_kernel(const T* __restrict__ logits,
                        const T* __restrict__ values,
                        T* __restrict__ depth_out, T* __restrict__ std_out,
                        int D, long long P, long long total, int depth_inv) {
  extern __shared__ float4 part_all[];   // [tiles][G][32], only when G > 1
  const int lane = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const long long idx =
      ((long long)blockIdx.x * blockDim.z + threadIdx.z) * kWarp + lane;
  float4* part = part_all + threadIdx.z * G * kWarp;
  float4 acc = empty_partial();
  if (idx < total) {
    const long long b = idx / P;
    const long long off = b * D * P + (idx - b * P);
    for (int d0 = g * PPT; d0 < D; d0 += G * PPT)
      acc = merge(acc, chunk_partial<PPT>(logits + off, values + off, d0, D,
                                          P, depth_inv));
  }
  if (G > 1) {
    part[g * kWarp + lane] = acc;
    __syncthreads();
    if (g != 0 || idx >= total) return;
    // Chan's update over the G partials at once: rescale each to the
    // common max, combine the means, then the central moments.
    float m = -INFINITY;
    for (int j = 0; j < G; ++j) m = fmaxf(m, part[j * kWarp + lane].x);
    float s = 0.f, sm = 0.f;
    for (int j = 0; j < G; ++j) {
      float4 q = part[j * kWarp + lane];
      const float w = q.y > 0.f ? expf(q.x - m) : 0.f;
      q.y *= w;
      q.w *= w;
      part[j * kWarp + lane] = q;
      s += q.y;
      sm += q.y * q.z;
    }
    const float mu = sm / s;
    float m2 = 0.f;
    for (int j = 0; j < G; ++j) {
      const float4 q = part[j * kWarp + lane];
      const float diff = q.z - mu;
      m2 += q.w + q.y * diff * diff;
    }
    acc = make_float4(m, s, mu, m2);
  } else if (idx >= total) {
    return;
  }
  store_f32(depth_out + idx, acc.z);
  store_f32(std_out + idx, sqrtf(fmaxf(acc.w / acc.y, 1e-10f)));
}

template <int PPT, typename T>
cudaError_t launch(const void* logits, const void* values, void* depth,
                   void* std, int D, long long P, long long total,
                   int depth_inv, int groups, int tiles, cudaStream_t stream) {
  const long long blocks = (total + kWarp * tiles - 1) / (kWarp * tiles);
  const dim3 block(kWarp, groups, tiles);
  const size_t smem =
      groups > 1 ? sizeof(float4) * kWarp * groups * tiles : 0;
  depth_regression_kernel<PPT, T><<<(unsigned)blocks, block, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const T*>(values),
      static_cast<T*>(depth), static_cast<T*>(std), D, P, total, depth_inv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int planes_per_thread, const void* logits,
                     const void* values, void* depth, void* std, int D,
                     long long P, long long total, int depth_inv, int groups,
                     int tiles, cudaStream_t stream) {
  switch (planes_per_thread) {
    case 1: return launch<1, T>(logits, values, depth, std, D, P, total,
                                depth_inv, groups, tiles, stream);
    case 2: return launch<2, T>(logits, values, depth, std, D, P, total,
                                depth_inv, groups, tiles, stream);
    case 4: return launch<4, T>(logits, values, depth, std, D, P, total,
                                depth_inv, groups, tiles, stream);
    case 8: return launch<8, T>(logits, values, depth, std, D, P, total,
                                depth_inv, groups, tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// logits, values, depth, std: device pointers of float (bf16 == 0) or
// __nv_bfloat16 (bf16 == 1). planes_per_thread in {1, 2, 4, 8}, groups and
// tiles >= 1 with groups * tiles <= 32: the plan of
// ops/kernels/depth_regression.py:plan.
extern "C" int enerf_depth_regression(const void* logits, const void* values,
                                      void* depth, void* std, int B, int D,
                                      int H, int W, int depth_inv, int bf16,
                                      int planes_per_thread, int groups,
                                      int tiles, void* stream) {
  const long long P = (long long)H * W;
  const long long total = (long long)B * P;
  if (total == 0) return 0;
  if (D <= 0 || groups < 1 || tiles < 1 || groups * tiles > kMaxGroups ||
      (total + kWarp - 1) / kWarp > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? dispatch<__nv_bfloat16>(planes_per_thread, logits,
                                              values, depth, std, D, P, total,
                                              depth_inv, groups, tiles, s)
                    : dispatch<float>(planes_per_thread, logits, values,
                                      depth, std, D, P, total, depth_inv,
                                      groups, tiles, s));
}

// One launch of an empty kernel: the launch floor that chip_smoke.py
// measures beside this kernel's times.
extern "C" int enerf_empty_kernel(void* stream) {
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
