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
// Design: lanes across channels. A group of G neighbouring lanes shares
// one voxel (G = C / 4 rounded up to a power of two: 8 at C = 32, 4 at
// C = 16) and lane i < C / 4 owns float4 i of its channels, so a corner row
// is one contiguous C * 4-byte read by neighbouring lanes (a full 128-byte
// line at C = 32), Σf and Σf² take 8 registers a lane, and at C = 4, 8,
// 16, 32 thread i writes the float4 at out + 4 i: a warp stores 512
// contiguous bytes. The warp coordinates are computed once per voxel and
// view: lane j of the group warps the voxel into view j (G views a round)
// and the group reads the corner and weights by shuffles. Lanes past the
// last voxel redo the last one and store nothing, so every lane takes part
// in the shuffles. Neighbouring voxels are neighbouring x, so their warped
// coordinates, and gathers, are close in the source map. What remains is
// the gathers' traffic from L2: 4 corner rows of C floats per voxel and
// view (377 MB at level 0 and 503 MB at level 1 of the 512x640 frame),
// against the 40 / 60 MB of the bound.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int C>
__host__ __device__ constexpr int group_lanes() {
  return C <= 4 ? 1 : C <= 8 ? 2 : C <= 16 ? 4 : 8;
}

// (P0 x + P1 y) + P2 + P3 / d, rounded after every operation in the order
// of ops/warp.py's warp coordinates: the terms are large and cancel, so a
// fused multiply-add here would move the sampled point by up to ~1e-3 px
// relative to the plain version.
__device__ __forceinline__ float warp_row(const float* P, float x, float y,
                                          float d) {
  const float base = __fadd_rn(__fadd_rn(__fmul_rn(P[0], x), __fmul_rn(P[1], y)), P[2]);
  return __fadd_rn(base, __fdiv_rn(P[3], d));
}

__device__ __forceinline__ void add_corner(const float4* __restrict__ row,
                                           float w, float4& v) {
  const float4 a = __ldg(row);
  v.x += w * a.x;
  v.y += w * a.y;
  v.z += w * a.z;
  v.w += w * a.w;
}

template <int C>
__global__ void __launch_bounds__(THREADS)
cost_volume_kernel(const float* __restrict__ feats,
                   const float* __restrict__ proj,
                   const float* __restrict__ depth,
                   const float* __restrict__ vmask,
                   float* __restrict__ out,
                   int B, int S, int Hs, int Ws, int D, int Ht, int Wt) {
  constexpr int L = C / 4;   // float4s of a voxel's channels
  constexpr int G = group_lanes<C>();
  const long long total = (long long)B * D * Ht * Wt;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int lane = (int)(tid & (G - 1));
  const bool live = tid / G < total && lane < L;
  const long long idx = tid / G < total ? tid / G : total - 1;
  const int q = lane < L ? lane : L - 1;   // this lane's float4
  const int x = (int)(idx % Wt);
  const int y = (int)((idx / Wt) % Ht);
  const int b = (int)(idx / ((long long)D * Ht * Wt));
  const float xf = (float)x, yf = (float)y;
  const float dv = __ldg(depth + idx);  // depth shares the voxel's flat index

  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f), sq = sum;
  float cnt = 0.f;
  for (int s0 = 0; s0 < S; s0 += G) {
    // lane j: the voxel's corner (x0, y0) and weights (tx, ty) in view s0 + j
    float ctx = 0.f, cty = 0.f;
    int cx0 = 0, cy0 = 0;
    if (s0 + lane < S) {
      const float* P = proj + ((long long)b * S + s0 + lane) * 12;
      const float px = warp_row(P, xf, yf, dv);
      const float py = warp_row(P + 4, xf, yf, dv);
      const float pz = fmaxf(warp_row(P + 8, xf, yf, dv), 1e-6f);
      // Clamping to [-2, size+1] changes no sample (every corner beyond it
      // is outside the map) and keeps the float->int conversion in range.
      const float sx = fminf(fmaxf(px / pz, -2.f), (float)Ws + 1.f);
      const float sy = fminf(fmaxf(py / pz, -2.f), (float)Hs + 1.f);
      const float x0f = floorf(sx), y0f = floorf(sy);
      ctx = sx - x0f;
      cty = sy - y0f;
      cx0 = (int)x0f;
      cy0 = (int)y0f;
    }
    const int n = S - s0 < G ? S - s0 : G;
    for (int j = 0; j < n; ++j) {
      const float tx = __shfl_sync(FULL, ctx, j, G);
      const float ty = __shfl_sync(FULL, cty, j, G);
      const int x0 = __shfl_sync(FULL, cx0, j, G);
      const int y0 = __shfl_sync(FULL, cy0, j, G);
      const int s = s0 + j;
      const float m = __ldg(vmask + b * S + s);
      cnt += m;
      if (m == 0.f) continue;
      const bool vx0 = x0 >= 0 && x0 <= Ws - 1;
      const bool vx1 = x0 + 1 >= 0 && x0 + 1 <= Ws - 1;
      const bool vy0 = y0 >= 0 && y0 <= Hs - 1;
      const bool vy1 = y0 + 1 >= 0 && y0 + 1 <= Hs - 1;
      // this lane's float4 of pixel (0, 0); pixel p is L float4s further
      const float4* img = reinterpret_cast<const float4*>(
          feats + ((long long)b * S + s) * Hs * Ws * C) + q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vy0 && vx0) add_corner(img + ((long long)y0 * Ws + x0) * L, (1.f - tx) * (1.f - ty), v);
      if (vy0 && vx1) add_corner(img + ((long long)y0 * Ws + x0 + 1) * L, tx * (1.f - ty), v);
      if (vy1 && vx0) add_corner(img + ((long long)(y0 + 1) * Ws + x0) * L, (1.f - tx) * ty, v);
      if (vy1 && vx1) add_corner(img + ((long long)(y0 + 1) * Ws + x0 + 1) * L, tx * ty, v);
      sum.x += m * v.x; sq.x += m * v.x * v.x;
      sum.y += m * v.y; sq.y += m * v.y * v.y;
      sum.z += m * v.z; sq.z += m * v.z * v.z;
      sum.w += m * v.w; sq.w += m * v.w * v.w;
    }
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(cnt, 1.f);
  const float4 mean = make_float4(sum.x * inv, sum.y * inv, sum.z * inv, sum.w * inv);
  reinterpret_cast<float4*>(out)[idx * L + lane] =
      make_float4(sq.x * inv - mean.x * mean.x, sq.y * inv - mean.y * mean.y,
                  sq.z * inv - mean.z * mean.z, sq.w * inv - mean.w * mean.w);
}

template <int C>
cudaError_t launch(const float* feats, const float* proj, const float* depth,
                   const float* vmask, float* out, int B, int S, int Hs,
                   int Ws, int D, int Ht, int Wt, cudaStream_t stream) {
  const long long threads = (long long)B * D * Ht * Wt * group_lanes<C>();
  const long long blocks = (threads + THREADS - 1) / THREADS;
  cost_volume_kernel<C><<<(unsigned)blocks, THREADS, 0, stream>>>(
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
