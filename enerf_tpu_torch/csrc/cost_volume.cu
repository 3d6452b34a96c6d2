// Variance cost volume for the plane-sweep MVS stage of ENeRF.
//
// Replaces: enerf_tpu/ops/pallas/cost_volume.py, fused_corner_variance
// (kernels _variance_kernel / _variance_kernel_fast) and its wide-table
// twin fused_wide_variance. On the TPU the warp coordinates and the corner
// gathers run in XLA and only the corner blend + variance runs in Pallas;
// here the whole of ops/warp.py:build_cost_volume is one kernel, and so is
// its crop-window twin build_cost_volume_crop (the composite model's fg
// volumes).
//
// Computes, for every voxel (b, d, y, x) of an (h, w) window of the target
// frustum at the origin (x0, y0) of batch b (the whole frame: origin 0,
// (h, w) = (Ht, Wt)):
//   for each source view s with view_mask[b, s] != 0:
//     p = P_s · [x + x0, y + y0, 1, 1/depth]   (z clamped at 1e-6, pixels)
//     f_s = bilinear sample of feats[b, s] at p, zeros padding per corner
//   out = Σ m f² / cnt − (Σ m f / cnt)²,  cnt = max(Σ m, 1)
// where depth = depth[b, d, y + cy0, x + cx0] and (cx0, cy0) is the origin
// moved into the frame by lax.dynamic_slice's rule (a negative coordinate
// counts from the end, then clamped so that the window fits): the depth comes from the
// clamped window, the warp from the unclamped origin, as
// enerf_tpu/ops/warp.py:build_cost_volume_crop (lax.dynamic_slice) has it.
// feats (B, S, Hs, Ws, C) NHWC, proj (B, S, 3, 4), depth (B, D, Ht, Wt),
// view_mask (B, S), origin (B, 2) int [x0, y0] or null (0), out
// (B, D, h, w, C) channels-last. feats and out are both float or both
// bf16 (the bf16 compute mode); the arithmetic is float either way, and a
// bf16 volume is rounded once, at the store, as the TPU kernel accumulates
// in f32 and writes feats.dtype.
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
// and the group reads the corner and weights by shuffles. A grid row holds
// one depth plane of one batch, so a thread divides only for its voxel's
// y and x, in 32 bits (voxel-flat 64-bit divides, with the window's
// depth address waiting on them, were slower at the frame's shapes). Lanes
// past the plane's last
// voxel redo it and store nothing, so every lane takes part in the
// shuffles. Neighbouring voxels are neighbouring x, so their warped
// coordinates, and gathers, are close in the source map. What remains is
// the gathers' traffic from L2: 4 corner rows of C floats per voxel and
// view (377 MB at level 0 and 503 MB at level 1 of the 512x640 frame),
// against the 40 / 60 MB of the bound.
// The bf16 variant is the same kernel templated on the element type: a
// lane's 4 channels are one 8-byte load (a 64-byte row at C = 32) and one
// 8-byte store, so the feature reads and the output write halve; the
// lanes, shuffles and float accumulators are the float variant's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Four consecutive channels as floats: one 16-byte load of float, one
// 8-byte load of bf16 (a bf16 is the upper half of its float's bits).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// rounded to nearest even, once
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__device__ __forceinline__ void add_corner(const T* __restrict__ row, float w,
                                           float4& v) {
  const float4 a = load4(row);
  v.x += w * a.x;
  v.y += w * a.y;
  v.z += w * a.z;
  v.w += w * a.w;
}

template <int C, typename T>
__global__ void __launch_bounds__(THREADS)
cost_volume_kernel(const T* __restrict__ feats,
                   const float* __restrict__ proj,
                   const float* __restrict__ depth,
                   const float* __restrict__ vmask,
                   const int* __restrict__ origin,
                   T* __restrict__ out,
                   int B, int S, int Hs, int Ws, int D, int Ht, int Wt,
                   int h, int w) {
  constexpr int L = C / 4;   // 4-channel vectors of a voxel's channels
  constexpr int G = group_lanes<C>();
  // one plane (b, d) a grid row: the plane and batch are uniform over the
  // block, and only a voxel's y and x take a (32-bit) divide. The entry
  // point refuses grids past 32-bit voxel indices or 65,535 planes.
  const unsigned plane = (unsigned)h * w;
  const unsigned bd = blockIdx.y;           // b * D + d
  const int b = (int)(bd / D);
  const unsigned tid = blockIdx.x * THREADS + threadIdx.x;
  const int lane = (int)(tid & (G - 1));
  const bool live = tid / G < plane && lane < L;
  const unsigned p = tid / G < plane ? tid / G : plane - 1;
  const unsigned idx = bd * plane + p;      // the voxel's flat index
  const int q = lane < L ? lane : L - 1;   // this lane's 4 channels
  const int y = (int)(p / w);
  const int x = (int)(p - y * w);
  int x0 = 0, y0 = 0;
  if (origin != nullptr) {
    x0 = __ldg(origin + 2 * b);
    y0 = __ldg(origin + 2 * b + 1);
  }
  // lax.dynamic_slice's start: a negative one counts from the end, then
  // the window is clamped into the frame
  const int cx0 = min(max(x0 < 0 ? x0 + Wt : x0, 0), Wt - w);
  const int cy0 = min(max(y0 < 0 ? y0 + Ht : y0, 0), Ht - h);
  // the pixel's coordinates are small integers, exact in float
  const float xf = (float)(x + x0), yf = (float)(y + y0);
  const float dv = __ldg(depth + ((long long)bd * Ht + y + cy0) * Wt + x + cx0);

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
      // this lane's 4 channels of pixel (0, 0); pixel p is C elements further
      const T* img = feats + ((long long)b * S + s) * Hs * Ws * C + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vy0 && vx0) add_corner(img + ((long long)y0 * Ws + x0) * C, (1.f - tx) * (1.f - ty), v);
      if (vy0 && vx1) add_corner(img + ((long long)y0 * Ws + x0 + 1) * C, tx * (1.f - ty), v);
      if (vy1 && vx0) add_corner(img + ((long long)(y0 + 1) * Ws + x0) * C, (1.f - tx) * ty, v);
      if (vy1 && vx1) add_corner(img + ((long long)(y0 + 1) * Ws + x0 + 1) * C, tx * ty, v);
      sum.x += m * v.x; sq.x += m * v.x * v.x;
      sum.y += m * v.y; sq.y += m * v.y * v.y;
      sum.z += m * v.z; sq.z += m * v.z * v.z;
      sum.w += m * v.w; sq.w += m * v.w * v.w;
    }
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(cnt, 1.f);
  const float4 mean = make_float4(sum.x * inv, sum.y * inv, sum.z * inv, sum.w * inv);
  store4(out + ((long long)idx * L + lane) * 4,
         make_float4(sq.x * inv - mean.x * mean.x, sq.y * inv - mean.y * mean.y,
                     sq.z * inv - mean.z * mean.z, sq.w * inv - mean.w * mean.w));
}

template <int C, typename T>
cudaError_t launch(const void* feats, const float* proj, const float* depth,
                   const float* vmask, const int* origin, void* out, int B,
                   int S, int Hs, int Ws, int D, int Ht, int Wt, int h, int w,
                   cudaStream_t stream) {
  const long long threads = (long long)h * w * group_lanes<C>();
  const dim3 grid((unsigned)((threads + THREADS - 1) / THREADS), B * D);
  cost_volume_kernel<C, T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(feats), proj, depth, vmask, origin,
      static_cast<T*>(out), B, S, Hs, Ws, D, Ht, Wt, h, w);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_typed(int bf16, const void* feats, const float* proj,
                         const float* depth, const float* vmask,
                         const int* origin, void* out, int B, int S, int Hs,
                         int Ws, int D, int Ht, int Wt, int h, int w,
                         cudaStream_t stream) {
  return bf16 ? launch<C, __nv_bfloat16>(feats, proj, depth, vmask, origin,
                                         out, B, S, Hs, Ws, D, Ht, Wt, h, w,
                                         stream)
              : launch<C, float>(feats, proj, depth, vmask, origin, out, B, S,
                                 Hs, Ws, D, Ht, Wt, h, w, stream);
}

}  // namespace

// origin may be null (the whole frame: pass h = Ht, w = Wt); 0 < h <= Ht
// and 0 < w <= Wt. feats and out are float (bf16 == 0) or __nv_bfloat16
// (bf16 == 1), 16- or 8-byte aligned.
extern "C" int enerf_cost_volume(const void* feats, const float* proj,
                                 const float* depth, const float* vmask,
                                 const int* origin, void* out, int B, int S,
                                 int Hs, int Ws, int C, int D, int Ht, int Wt,
                                 int h, int w, int bf16, void* stream) {
  if (h > Ht || w > Wt) return (int)cudaErrorInvalidValue;
  if ((long long)B * D * h * w == 0) return 0;
  if ((long long)B * D * h * w * 8 >= (1LL << 31) || B * D > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ENERF_CV_CASE(c) \
  case c: return (int)launch_typed<c>(bf16, feats, proj, depth, vmask, origin, out, B, S, Hs, Ws, D, Ht, Wt, h, w, st);
  switch (C) {
    ENERF_CV_CASE(4) ENERF_CV_CASE(8) ENERF_CV_CASE(12) ENERF_CV_CASE(16)
    ENERF_CV_CASE(20) ENERF_CV_CASE(24) ENERF_CV_CASE(28) ENERF_CV_CASE(32)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ENERF_CV_CASE
}
