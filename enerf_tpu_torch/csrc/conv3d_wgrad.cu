// Weight gradient of a 3D convolution with a 3x3x3 kernel, float32, on
// channels-last tensors.
//
// Replaces: no TPU kernel. XLA computes the 3D CNNs' weight gradients in
// the JAX package's train step (enerf_tpu/train/step.py); in the port
// cuDNN did, and with TF32 off its f32 weight gradient of these convs runs
// a grouped-direct kernel (wgrad2d_grouped_direct_kernel, channels-last
// and NCDHW alike) at about 1 % of the card's f32 rate: 49.7 ms of the
// 120.5 ms that the 512x640 DTU train step keeps the card busy. The
// forward and the input gradient stay cuDNN's.
//
// Computes, for a conv of stride s and padding p:
//   dw[co][ci][kd][kh][kw] = sum over n, od, oh, ow of
//       gy[n][od][oh][ow][co] * x[n][s od - p + kd][s oh - p + kh][s ow - p + kw][ci]
// (x is 0 outside its bounds), with x (N, D, H, W, Ci) and gy (N, Do, Ho,
// Wo, Co) contiguous: the channels-last storage of the NCDHW tensors. A
// transposed conv's weight gradient is the same sum with the roles of its
// input and its output gradient swapped (the wrapper swaps them).
//
// What bounds it on the H100: f32 FMAs on the CUDA cores (TF32 would not
// keep f32 accuracy). The largest call of the train step, level 1's first
// conv (16 -> 8 channels over 8 x 256 x 320 voxels), is 4.5 GFLOP against
// 63 MB of x and gy: 68 us at 67 TFLOP/s, 19 us at 3.35 TB/s.
//
// Design: an implicit GEMM C[Co][27 Ci] = A[Co][K] B[K][27 Ci] whose
// reduction K (the output voxels, up to 655,360) is long and whose output
// (216 to 110,592 entries) is small, so the work is split over K:
// - Pass 1. A thread tile is TM output channels x 4 input channels of one
//   tap: TM x 4 register accumulators. A block of 256 threads holds
//   `tiles_per_block` thread tiles, `replicas` times over; the replicas of
//   a tile take every replicas-th voxel of a row. Block (z, y) takes the
//   output rows (n, od, oh) [z rows_per_block, (z + 1) rows_per_block) and
//   the y-th group of thread tiles. Per voxel a thread reads its 4 channels
//   of x (one float4; the taps of a row are neighbouring voxels, so a
//   warp's reads fall on three runs of the row) and TM channels of gy (the
//   same address for every tile of its channel group: a broadcast), for
//   TM x 4 FMAs. The row's coordinates and its two outer bounds are
//   computed once a row; the inner loop checks one bound.
// - The replicas of a tile sum in shared memory in a fixed order, and the
//   block writes its partial to ws[z][co][tap][ci].
// - Pass 2. One thread per weight entry sums the partials over z in order
//   and writes dw (Co, Ci, 3, 3, 3). No atomics: the result is the same
//   from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTaps = 27;
constexpr int kSumThreads = 256;

template <int TM>
__device__ __forceinline__ void load_gy(const float* __restrict__ p,
                                        float (&g)[TM]) {
  if constexpr (TM == 1) {
    g[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      g[i] = v.x;
      g[i + 1] = v.y;
      g[i + 2] = v.z;
      g[i + 3] = v.w;
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const float* __restrict__ x,
                     const float* __restrict__ gy, float* __restrict__ ws,
                     int D, int H, int W, int Ci, int Do, int Ho, int Wo,
                     int Co, int stride, int pad, int rows,
                     int rows_per_block, int tiles, int tiles_per_block,
                     int replicas) {
  extern __shared__ float red[];   // [TM * 4][kThreads]
  const int tid = threadIdx.x;
  const int tl = tid % tiles_per_block;
  const int r = tid / tiles_per_block;
  const int tile = blockIdx.y * tiles_per_block + tl;
  const bool active = r < replicas && tile < tiles;
  const int quads = Ci / 4;
  // tile = (channel group * 27 + tap) * quads + quad
  const int quad = tile % quads;
  const int tap = (tile / quads) % kTaps;
  const int co0 = tile / (quads * kTaps) * TM;
  const int ci0 = quad * 4;
  const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  if (active) {
    const int row0 = blockIdx.x * rows_per_block;
    const int row1 = min(row0 + rows_per_block, rows);
    for (int row = row0; row < row1; ++row) {
      const int oh = row % Ho;
      const int od = (row / Ho) % Do;
      const int n = row / (Ho * Do);
      const int id = od * stride - pad + kd;
      const int ih = oh * stride - pad + kh;
      if (id < 0 || id >= D || ih < 0 || ih >= H) continue;
      const float* xrow = x + ((static_cast<size_t>(n) * D + id) * H + ih) *
                                  static_cast<size_t>(W) * Ci + ci0;
      const float* grow = gy + static_cast<size_t>(row) * Wo * Co + co0;
      for (int ow = r; ow < Wo; ow += replicas) {
        const int iw = ow * stride - pad + kw;
        if (iw < 0 || iw >= W) continue;
        const float4 xv = __ldg(reinterpret_cast<const float4*>(
            xrow + static_cast<size_t>(iw) * Ci));
        float g[TM];
        load_gy<TM>(grow + static_cast<size_t>(ow) * Co, g);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(g[i], xv.x, acc[i][0]);
          acc[i][1] = fmaf(g[i], xv.y, acc[i][1]);
          acc[i][2] = fmaf(g[i], xv.z, acc[i][2]);
          acc[i][3] = fmaf(g[i], xv.w, acc[i][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[(i * 4 + j) * kThreads + tid] = acc[i][j];
  }
  __syncthreads();
  if (!active || r != 0) return;
  float* out = ws + (static_cast<size_t>(blockIdx.x) * Co + co0) * kTaps * Ci;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
      for (int q = 0; q < replicas; ++q)
        s += red[(i * 4 + j) * kThreads + q * tiles_per_block + tl];
      out[(static_cast<size_t>(i) * kTaps + tap) * Ci + ci0 + j] = s;
    }
  }
}

// dw[co][ci][tap] = sum over z, in order, of ws[z][co][tap][ci]
__global__ void __launch_bounds__(kSumThreads)
wgrad_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                 int splits, int Co, int Ci) {
  const int n = Co * kTaps * Ci;
  const int e = blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z)
    s += __ldg(ws + static_cast<size_t>(z) * n + e);
  const int ci = e % Ci;
  const int tap = (e / Ci) % kTaps;
  const int co = e / (Ci * kTaps);
  dw[(static_cast<size_t>(co) * Ci + ci) * kTaps + tap] = s;
}

template <int TM>
cudaError_t launch(const float* x, const float* gy, float* ws, float* dw,
                   int N, int Ci, int D, int H, int W, int Co, int Do, int Ho,
                   int Wo, int stride, int pad, int rows_per_block, int splits,
                   int tiles_per_block, int groups, cudaStream_t stream) {
  const int tiles = Co / TM * kTaps * (Ci / 4);
  const int replicas = kThreads / tiles_per_block;
  const size_t smem = sizeof(float) * TM * 4 * kThreads;
  wgrad_partial_kernel<TM><<<dim3(splits, groups), kThreads, smem, stream>>>(
      x, gy, ws, D, H, W, Ci, Do, Ho, Wo, Co, stride, pad, N * Do * Ho,
      rows_per_block, tiles, tiles_per_block, replicas);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = Co * kTaps * Ci;
  wgrad_sum_kernel<<<(n + kSumThreads - 1) / kSumThreads, kSumThreads, 0,
                     stream>>>(ws, dw, splits, Co, Ci);
  return cudaGetLastError();
}

}  // namespace

// x (N, D, H, W, Ci) and gy (N, Do, Ho, Wo, Co) float32 contiguous, 16-byte
// aligned, Ci a multiple of 4, `tm` 8 (Co a multiple of 8) or 1; ws holds
// splits * Co * 27 * Ci floats; dw (Co, Ci, 3, 3, 3). The plan (tm,
// rows_per_block, splits, tiles_per_block, groups) is the wrapper's
// (ops/kernels/conv3d_wgrad.py:plan). Returns the launches' cudaError_t.
extern "C" int enerf_conv3d_wgrad(const float* x, const float* gy, float* ws,
                                  float* dw, int N, int Ci, int D, int H,
                                  int W, int Co, int Do, int Ho, int Wo,
                                  int stride, int pad, int tm,
                                  int rows_per_block, int splits,
                                  int tiles_per_block, int groups,
                                  cudaStream_t stream) {
  switch (tm) {
    case 8:
      return launch<8>(x, gy, ws, dw, N, Ci, D, H, W, Co, Do, Ho, Wo, stride,
                       pad, rows_per_block, splits, tiles_per_block, groups,
                       stream);
    case 1:
      return launch<1>(x, gy, ws, dw, N, Ci, D, H, W, Co, Do, Ho, Wo, stride,
                       pad, rows_per_block, splits, tiles_per_block, groups,
                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}
