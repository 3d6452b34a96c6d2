// Variance cost volume for the plane-sweep MVS stage of ENeRF.
//
// Replaces: enerf_tpu/ops/pallas/cost_volume.py, fused_corner_variance
// (kernels _variance_kernel / _variance_kernel_fast) and its wide-table
// twin fused_wide_variance. On the TPU the warp coordinates and the corner
// gathers run in XLA and only the corner blend + variance runs in Pallas;
// here the whole of ops/warp.py:build_cost_volume is one kernel.
//
// Computes, for every voxel (b, d, y, x) of the target frustum:
//   for each source view s with view_mask[b, s] != 0:
//     p = P_s · [x, y, 1, 1/depth]   (z clamped at 1e-6, pixel coordinates)
//     f_s = bilinear sample of feats[b, s] at p, zeros padding per corner
//   out = Σ m f² / cnt − (Σ m f / cnt)²,  cnt = max(Σ m, 1)
// feats (B, S, Hs, Ws, C) NHWC, proj (B, S, 3, 4), depth (B, D, Ht, Wt),
// view_mask (B, S), out (B, D, Ht, Wt, C) channels-last.
//
// What bounds it on the H100: memory. Per voxel it writes C floats and
// does ~10 C flops per view; the feature maps (8 MB at level 0, 16 MB at
// level 1 of the 512x640 frame) fit the 50 MB L2, so the gathers mostly
// hit L2 and the output write (31 MB / 42 MB) is the floor.
// Design: one thread per voxel, Σf and Σf² for all C channels kept in
// registers (C <= 32, a template constant), the 4 corner rows read as
// 16-byte vector loads of contiguous channels, the C outputs written as
// 16-byte vector stores. Neighbouring threads are neighbouring x, so
// their warped coordinates — and gathers — are close in the source map.

#include <cuda_runtime.h>

namespace {

// (P0 x + P1 y) + P2 + P3 / d, rounded after every operation in the order
// of ops/warp.py's warp coordinates: the terms are large and cancel, so a
// fused multiply-add here would move the sampled point by up to ~1e-3 px
// relative to the plain version.
__device__ __forceinline__ float warp_row(const float* P, float x, float y,
                                          float d) {
  const float base = __fadd_rn(__fadd_rn(__fmul_rn(P[0], x), __fmul_rn(P[1], y)), P[2]);
  return __fadd_rn(base, __fdiv_rn(P[3], d));
}

template <int C>
__device__ __forceinline__ void add_corner(const float* __restrict__ row,
                                           float w, float (&v)[C]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 a = __ldg(r4 + q);
    v[4 * q + 0] += w * a.x;
    v[4 * q + 1] += w * a.y;
    v[4 * q + 2] += w * a.z;
    v[4 * q + 3] += w * a.w;
  }
}

template <int C>
__global__ void __launch_bounds__(256)
cost_volume_kernel(const float* __restrict__ feats,
                   const float* __restrict__ proj,
                   const float* __restrict__ depth,
                   const float* __restrict__ vmask,
                   float* __restrict__ out,
                   int B, int S, int Hs, int Ws, int D, int Ht, int Wt) {
  const long long total = (long long)B * D * Ht * Wt;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % Wt);
  const int y = (int)((idx / Wt) % Ht);
  const int b = (int)(idx / ((long long)D * Ht * Wt));
  const float xf = (float)x, yf = (float)y;
  const float dv = depth[idx];  // depth shares the voxel's flat index

  float sum[C], sq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) { sum[c] = 0.f; sq[c] = 0.f; }
  float cnt = 0.f;

  for (int s = 0; s < S; ++s) {
    const float m = vmask[b * S + s];
    cnt += m;
    if (m == 0.f) continue;
    const float* P = proj + ((long long)b * S + s) * 12;
    const float px = warp_row(P, xf, yf, dv);
    const float py = warp_row(P + 4, xf, yf, dv);
    const float pz = fmaxf(warp_row(P + 8, xf, yf, dv), 1e-6f);
    // Clamping to [-2, size+1] changes no sample (every corner beyond it is
    // outside the map) and keeps the float->int conversion in range.
    const float sx = fminf(fmaxf(px / pz, -2.f), (float)Ws + 1.f);
    const float sy = fminf(fmaxf(py / pz, -2.f), (float)Hs + 1.f);
    const float x0f = floorf(sx), y0f = floorf(sy);
    const float tx = sx - x0f, ty = sy - y0f;
    const int x0 = (int)x0f, y0 = (int)y0f;
    const bool vx0 = x0 >= 0 && x0 <= Ws - 1;
    const bool vx1 = x0 + 1 >= 0 && x0 + 1 <= Ws - 1;
    const bool vy0 = y0 >= 0 && y0 <= Hs - 1;
    const bool vy1 = y0 + 1 >= 0 && y0 + 1 <= Hs - 1;

    const float* img = feats + ((long long)b * S + s) * Hs * Ws * C;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.f;
    if (vy0 && vx0) add_corner<C>(img + ((long long)y0 * Ws + x0) * C, (1.f - tx) * (1.f - ty), v);
    if (vy0 && vx1) add_corner<C>(img + ((long long)y0 * Ws + x0 + 1) * C, tx * (1.f - ty), v);
    if (vy1 && vx0) add_corner<C>(img + ((long long)(y0 + 1) * Ws + x0) * C, (1.f - tx) * ty, v);
    if (vy1 && vx1) add_corner<C>(img + ((long long)(y0 + 1) * Ws + x0 + 1) * C, tx * ty, v);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum[c] += m * v[c];
      sq[c] += m * v[c] * v[c];
    }
  }

  const float inv = 1.f / fmaxf(cnt, 1.f);
  float4* o4 = reinterpret_cast<float4*>(out + idx * C);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mean = sum[4 * q + j] * inv;
      r[j] = sq[4 * q + j] * inv - mean * mean;
    }
    o4[q] = make_float4(r[0], r[1], r[2], r[3]);
  }
}

template <int C>
cudaError_t launch(const float* feats, const float* proj, const float* depth,
                   const float* vmask, float* out, int B, int S, int Hs,
                   int Ws, int D, int Ht, int Wt, cudaStream_t stream) {
  const long long total = (long long)B * D * Ht * Wt;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  cost_volume_kernel<C><<<(unsigned)blocks, threads, 0, stream>>>(
      feats, proj, depth, vmask, out, B, S, Hs, Ws, D, Ht, Wt);
  return cudaGetLastError();
}

}  // namespace

extern "C" int enerf_cost_volume(const float* feats, const float* proj,
                                 const float* depth, const float* vmask,
                                 float* out, int B, int S, int Hs, int Ws,
                                 int C, int D, int Ht, int Wt, void* stream) {
  if ((long long)B * D * Ht * Wt == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ENERF_CV_CASE(c) \
  case c: return (int)launch<c>(feats, proj, depth, vmask, out, B, S, Hs, Ws, D, Ht, Wt, st);
  switch (C) {
    ENERF_CV_CASE(4) ENERF_CV_CASE(8) ENERF_CV_CASE(12) ENERF_CV_CASE(16)
    ENERF_CV_CASE(20) ENERF_CV_CASE(24) ENERF_CV_CASE(28) ENERF_CV_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ENERF_CV_CASE
}
