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
// logits, values (B, D, H, W) contiguous; depth, std (B, H, W).
//
// What bounds it on the H100: memory, and at the cascade's sizes (2.7 MB
// at level 0, 5.9 MB at level 1 of the 512x640 frame, ~1-2 us of HBM time)
// the launch itself. Design: one thread per pixel. For a fixed plane d the
// threads of a warp read neighbouring pixels, i.e. neighbouring addresses of
// the (B, D, H, W) layout, so every plane read is coalesced. The thread
// loops over D three times (max; sum e and sum e v; sum e (v - depth)^2)
// and divides by sum e at the end. The second and third passes re-read the
// lines the first one brought into L1/L2. The central-moment form is kept:
// the one-pass sum v^2 - depth^2 cancels badly at level 1, whose planes
// lie within +-std of each other.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float plane_value(float v, int depth_inv) {
  return depth_inv ? 1.f / fmaxf(v, 1e-6f) : v;
}

__global__ void __launch_bounds__(256)
depth_regression_kernel(const float* __restrict__ logits,
                        const float* __restrict__ values,
                        float* __restrict__ depth_out,
                        float* __restrict__ std_out,
                        int B, int D, long long P, int depth_inv) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * P) return;
  const long long b = idx / P;
  const long long p = idx - b * P;
  const float* l = logits + b * D * P + p;
  const float* v = values + b * D * P + p;

  float mx = -INFINITY;
  for (int d = 0; d < D; ++d) mx = fmaxf(mx, __ldg(l + d * P));

  float se = 0.f, sev = 0.f;
  for (int d = 0; d < D; ++d) {
    const float e = expf(__ldg(l + d * P) - mx);
    se += e;
    sev += e * plane_value(__ldg(v + d * P), depth_inv);
  }
  const float inv = 1.f / se;
  const float dep = sev * inv;

  float sv = 0.f;
  for (int d = 0; d < D; ++d) {
    const float e = expf(__ldg(l + d * P) - mx);
    const float diff = plane_value(__ldg(v + d * P), depth_inv) - dep;
    sv += e * diff * diff;
  }
  depth_out[idx] = dep;
  std_out[idx] = sqrtf(fmaxf(sv * inv, 1e-10f));
}

}  // namespace

extern "C" int enerf_depth_regression(const float* logits, const float* values,
                                      float* depth, float* std, int B, int D,
                                      int H, int W, int depth_inv,
                                      void* stream) {
  const long long P = (long long)H * W;
  const long long total = (long long)B * P;
  if (total == 0) return 0;
  if (D <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  depth_regression_kernel<<<(unsigned)blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      logits, values, depth, std, B, D, P, depth_inv);
  return (int)cudaGetLastError();
}
