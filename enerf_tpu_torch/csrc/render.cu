// Fused render stage of one ENeRF cascade level: IBR shading + compositing.
//
// Replaces: enerf_tpu/ops/pallas/render.py, fused_render_rays (kernels
// _render_kernel -> _render_math, and _render_kernel_v5). The TPU kernel
// reads a lane-packed operand of pre-gathered, pre-blended features and
// the spatially resized feature volume; this kernel samples the source
// feature maps and the un-resized volume itself, so neither the gathered
// features nor the resized volume ever reach device memory.
//
// Per ray (one thread), for each of its NS = 2 samples:
//   1. per source view s: project the sample (R, t, then K at render
//      scale; z clamped at 1e-6), bilinear sample of the (feat ‖ rgb) map
//      with border padding, and the ray-difference feature
//      [normalize(tar_dir - src_dir), dot(tar_dir, src_dir)];
//   2. Agg: a_s = f_s + relu(view_fc(dir_s)); masked mean and unbiased var
//      over views; g_s = relu(global_fc([a_s, var, mean]));
//      agg = relu(fc(Σ softmax_s(relu(agg_w_fc(g_s))) g_s)), padded views
//      at logit -1e9;
//   3. vox = trilinear sample (zeros padding, align_corners) of the level's
//      (B, Dv, Hv, Wv, 8) feature volume at uvd; on grid rays this equals
//      the JAX package's spatial resize + tent over the depth planes;
//   4. h = relu(lr0([vox, agg])), sigma = softplus(sigma(h));
//   5. color: per view relu(color_2(relu(color_0([h, vox, agg, f_s, dir_s]))))
//      → masked softmax over views → blend of the source rgb;
// then alpha = 1 - exp(-sigma) (no dists), T = exclusive cumprod of
// (1 - alpha + 1e-10), weights = alpha T, rgb = Σ weights rgb (+ 1 - Σ
// weights with a white background), depth = Σ softmax(weights) z.
//
// What bounds it on the H100: operations. ~25.5k multiply-adds per sample
// of f32 MLP (655,360 samples at 512x640: ~33 GFLOP) against ~85 MB in and
// out. Design: the NeRFHead weights (10,090 floats) are staged once per
// block in shared memory, where every thread of a warp reads the same
// address (a broadcast); all per-ray state lives in registers; the color
// MLP's view-independent part (h, vox, agg) is computed once per sample
// and only the 15 per-view inputs are redone per view; the Agg softmax
// pooling is an online softmax, so the per-view global features are not
// all kept. Plain f32 CUDA-core FMAs: tensor cores are a later step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CF = 11;                 // image feature channels + rgb
constexpr int CV = 8;                  // feature-volume channels
constexpr int HID = 64;                // NeRFHead hidden width
constexpr int GL = 32;                 // Agg global feature width
constexpr int AG = 16;                 // aggregated image feature width
constexpr int NS = 2;                  // samples per ray
constexpr int FD = CF + 4;             // per-view input: feat ‖ rgb ‖ dir ‖ dot
constexpr int VIF = CV + AG;           // [vox, agg]
constexpr int C0_IN = HID + VIF + FD;  // color_0 input width
constexpr int THREADS = 128;
constexpr float NEG = -1e9f;

// Flat head-weight buffer: each torch Linear's (out, in) weight, then its
// bias (ops/kernels/render.py:head_params builds it in this order).
struct HeadLayout {
  static constexpr int VF_W = 0;
  static constexpr int VF_B = VF_W + CF * 4;
  static constexpr int GF_W = VF_B + CF;
  static constexpr int GF_B = GF_W + GL * 3 * CF;
  static constexpr int AW_W = GF_B + GL;
  static constexpr int AW_B = AW_W + GL;
  static constexpr int FC_W = AW_B + 1;
  static constexpr int FC_B = FC_W + AG * GL;
  static constexpr int L0_W = FC_B + AG;
  static constexpr int L0_B = L0_W + HID * VIF;
  static constexpr int SG_W = L0_B + HID;
  static constexpr int SG_B = SG_W + HID;
  static constexpr int C0_W = SG_B + 1;
  static constexpr int C0_B = C0_W + HID * C0_IN;
  static constexpr int C1_W = C0_B + HID;
  static constexpr int C1_B = C1_W + HID;
  static constexpr int SIZE = C1_B + 1;
};
static_assert(HeadLayout::SIZE * 4 <= 48 * 1024, "head weights exceed static shared memory");

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Bilinear sample with border padding in pixel coordinates.
__device__ __forceinline__ void sample_border(const float* __restrict__ img,
                                              int H, int W, float u, float v,
                                              float* out) {
  u = fminf(fmaxf(u, 0.f), (float)(W - 1));
  v = fminf(fmaxf(v, 0.f), (float)(H - 1));
  const float x0f = floorf(u), y0f = floorf(v);
  const float tx = u - x0f, ty = v - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;
  const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
  const float* r00 = img + ((long long)y0 * W + x0) * CF;
  const float* r01 = img + ((long long)y0 * W + x1) * CF;
  const float* r10 = img + ((long long)y1 * W + x0) * CF;
  const float* r11 = img + ((long long)y1 * W + x1) * CF;
#pragma unroll
  for (int c = 0; c < CF; ++c) {
    const float top = (1.f - tx) * __ldg(r00 + c) + tx * __ldg(r01 + c);
    const float bot = (1.f - tx) * __ldg(r10 + c) + tx * __ldg(r11 + c);
    out[c] = (1.f - ty) * top + ty * bot;
  }
}

// Trilinear sample with zeros padding of a (Dv, Hv, Wv, CV) volume at voxel
// coordinates (x, y, z).
__device__ __forceinline__ void sample_volume(const float* __restrict__ vol,
                                              int Dv, int Hv, int Wv,
                                              float x, float y, float z,
                                              float* out) {
  // clamping to [-2, size+1] changes no sample and keeps float->int in range
  x = fminf(fmaxf(x, -2.f), (float)Wv + 1.f);
  y = fminf(fmaxf(y, -2.f), (float)Hv + 1.f);
  z = fminf(fmaxf(z, -2.f), (float)Dv + 1.f);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float t[3] = {x - x0f, y - y0f, z - z0f};
  const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
#pragma unroll
  for (int c = 0; c < CV; ++c) out[c] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int zi = z0 + dz;
    if (zi < 0 || zi > Dv - 1) continue;
    const float wz = dz ? t[2] : 1.f - t[2];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = y0 + dy;
      if (yi < 0 || yi > Hv - 1) continue;
      const float wy = dy ? t[1] : 1.f - t[1];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = x0 + dx;
        if (xi < 0 || xi > Wv - 1) continue;
        const float wgt = wz * wy * (dx ? t[0] : 1.f - t[0]);
        const float4* row = reinterpret_cast<const float4*>(
            vol + (((long long)zi * Hv + yi) * Wv + xi) * CV);
#pragma unroll
        for (int q = 0; q < CV / 4; ++q) {
          const float4 a = __ldg(row + q);
          out[4 * q + 0] += wgt * a.x;
          out[4 * q + 1] += wgt * a.y;
          out[4 * q + 2] += wgt * a.z;
          out[4 * q + 3] += wgt * a.w;
        }
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS)
render_kernel(const float* __restrict__ xyz, const float* __restrict__ uvd,
              const float* __restrict__ zvals, const float* __restrict__ imgs,
              const float* __restrict__ vol, const float* __restrict__ cams,
              const float* __restrict__ tar_cam,
              const float* __restrict__ vmask,
              const float* __restrict__ params, float* __restrict__ rgb_out,
              float* __restrict__ depth_out, float* __restrict__ w_out,
              int B, int N, int H, int W, int Dv, int Hv, int Wv,
              int white_bkgd) {
  using L = HeadLayout;
  __shared__ float w[L::SIZE];
  for (int i = threadIdx.x; i < L::SIZE; i += blockDim.x) w[i] = params[i];
  __syncthreads();

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)B * N) return;
  const int b = (int)(r / N);

  float m[S];
  float cnt = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    m[s] = vmask[b * S + s] != 0.f ? 1.f : 0.f;
    cnt += m[s];
  }
  cnt = fmaxf(cnt, 1.f);
  const float tcx = tar_cam[b * 3 + 0];
  const float tcy = tar_cam[b * 3 + 1];
  const float tcz = tar_cam[b * 3 + 2];
  const float* vol_b = vol + (long long)b * Dv * Hv * Wv * CV;

  float sig[NS], col[NS][3], zs[NS];
#pragma unroll 1
  for (int k = 0; k < NS; ++k) {
    const float* p = xyz + (r * NS + k) * 3;
    const float X = p[0], Y = p[1], Z = p[2];
    zs[k] = zvals[r * NS + k];

    // 1. per-view samples and ray-difference features
    float fd[S][FD];
    float tdx = X - tcx, tdy = Y - tcy, tdz = Z - tcz;
    const float tn = sqrtf(tdx * tdx + tdy * tdy + tdz * tdz) + 1e-6f;
    tdx /= tn; tdy /= tn; tdz /= tn;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* cam = cams + ((long long)b * S + s) * 24;
      const float c0 = X * cam[0] + Y * cam[1] + Z * cam[2] + cam[9];
      const float c1 = X * cam[3] + Y * cam[4] + Z * cam[5] + cam[10];
      const float c2 = X * cam[6] + Y * cam[7] + Z * cam[8] + cam[11];
      const float i0 = c0 * cam[12] + c1 * cam[13] + c2 * cam[14];
      const float i1 = c0 * cam[15] + c1 * cam[16] + c2 * cam[17];
      const float zc = fmaxf(c0 * cam[18] + c1 * cam[19] + c2 * cam[20], 1e-6f);
      sample_border(imgs + ((long long)b * S + s) * H * W * CF, H, W,
                    i0 / zc, i1 / zc, fd[s]);
      float sdx = X - cam[21], sdy = Y - cam[22], sdz = Z - cam[23];
      const float sn = sqrtf(sdx * sdx + sdy * sdy + sdz * sdz) + 1e-6f;
      sdx /= sn; sdy /= sn; sdz /= sn;
      const float rx = tdx - sdx, ry = tdy - sdy, rz = tdz - sdz;
      const float rn = fmaxf(sqrtf(rx * rx + ry * ry + rz * rz), 1e-6f);
      fd[s][CF + 0] = rx / rn;
      fd[s][CF + 1] = ry / rn;
      fd[s][CF + 2] = rz / rn;
      fd[s][CF + 3] = tdx * sdx + tdy * sdy + tdz * sdz;
    }

    // 2. Agg
    float a[S][CF];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int c = 0; c < CF; ++c) {
        float t = w[L::VF_B + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) t += w[L::VF_W + c * 4 + j] * fd[s][CF + j];
        a[s][c] = fd[s][c] + relu(t);
      }
    }
    float mean[CF], var[CF];
#pragma unroll
    for (int c = 0; c < CF; ++c) {
      float sm = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) sm += a[s][c] * m[s];
      mean[c] = sm / cnt;
      float vv = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float d = a[s][c] - mean[c];
        vv += d * d * m[s];
      }
      var[c] = vv / fmaxf(cnt - 1.f, 1.f);
    }
    float acc[GL];
#pragma unroll
    for (int o = 0; o < GL; ++o) acc[o] = 0.f;
    float den = 0.f, mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float g[GL];
      float l = w[L::AW_B];
#pragma unroll
      for (int o = 0; o < GL; ++o) {
        const float* wr = w + L::GF_W + o * 3 * CF;
        float t = w[L::GF_B + o];
#pragma unroll
        for (int i = 0; i < CF; ++i) t += wr[i] * a[s][i];
#pragma unroll
        for (int i = 0; i < CF; ++i) t += wr[CF + i] * var[i];
#pragma unroll
        for (int i = 0; i < CF; ++i) t += wr[2 * CF + i] * mean[i];
        g[o] = relu(t);
        l += w[L::AW_W + o] * g[o];
      }
      l = m[s] != 0.f ? relu(l) : NEG;
      const float mxn = fmaxf(mx, l);
      const float sc = expf(mx - mxn), e = expf(l - mxn);
#pragma unroll
      for (int o = 0; o < GL; ++o) acc[o] = acc[o] * sc + e * g[o];
      den = den * sc + e;
      mx = mxn;
    }

    // 3. vox feature, then the aggregated feature: vif = [vox, agg]
    float vif[VIF];
    const float* q = uvd + (r * NS + k) * 3;
    sample_volume(vol_b, Dv, Hv, Wv, q[0] * (Wv - 1), q[1] * (Hv - 1),
                  q[2] * (Dv - 1), vif);
    const float inv_den = 1.f / den;
#pragma unroll
    for (int o = 0; o < GL; ++o) acc[o] *= inv_den;
#pragma unroll
    for (int o = 0; o < AG; ++o) {
      float t = w[L::FC_B + o];
#pragma unroll
      for (int i = 0; i < GL; ++i) t += w[L::FC_W + o * GL + i] * acc[i];
      vif[CV + o] = relu(t);
    }

    // 4. h = lr0(vif) feeds sigma and the view-independent part of color_0
    float base[HID];
#pragma unroll
    for (int j = 0; j < HID; ++j) base[j] = w[L::C0_B + j];
    float sacc = w[L::SG_B];
#pragma unroll 1
    for (int i = 0; i < HID; ++i) {
      float t = w[L::L0_B + i];
#pragma unroll
      for (int c = 0; c < VIF; ++c) t += w[L::L0_W + i * VIF + c] * vif[c];
      const float h = relu(t);
      sacc += w[L::SG_W + i] * h;
#pragma unroll
      for (int j = 0; j < HID; ++j) base[j] += w[L::C0_W + j * C0_IN + i] * h;
    }
#pragma unroll
    for (int c = 0; c < VIF; ++c) {
#pragma unroll
      for (int j = 0; j < HID; ++j) base[j] += w[L::C0_W + j * C0_IN + HID + c] * vif[c];
    }
    sig[k] = softplus(sacc);

    // 5. color: per-view logits, masked softmax, blend of the source rgb
    float lg[S];
    float lmax = -INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float l = w[L::C1_B];
#pragma unroll
      for (int j = 0; j < HID; ++j) {
        const float* wr = w + L::C0_W + j * C0_IN + HID + VIF;
        float t = base[j];
#pragma unroll
        for (int i = 0; i < FD; ++i) t += wr[i] * fd[s][i];
        l += w[L::C1_W + j] * relu(t);
      }
      lg[s] = m[s] != 0.f ? relu(l) : NEG;
      lmax = fmaxf(lmax, lg[s]);
    }
    float esum = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float e = expf(lg[s] - lmax);
      esum += e;
      cr += e * fd[s][CF - 3];
      cg += e * fd[s][CF - 2];
      cb += e * fd[s][CF - 1];
    }
    col[k][0] = cr / esum;
    col[k][1] = cg / esum;
    col[k][2] = cb / esum;
  }

  // alpha compositing
  float T = 1.f, wsum = 0.f, wmax = -INFINITY;
  float out_r = 0.f, out_g = 0.f, out_b = 0.f;
  float wk[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const float alpha = 1.f - expf(-sig[k]);
    wk[k] = alpha * T;
    T *= 1.f - alpha + 1e-10f;
    out_r += wk[k] * col[k][0];
    out_g += wk[k] * col[k][1];
    out_b += wk[k] * col[k][2];
    wsum += wk[k];
    wmax = fmaxf(wmax, wk[k]);
  }
  float ez = 0.f, es = 0.f;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const float e = expf(wk[k] - wmax);
    es += e;
    ez += e * zs[k];
    w_out[r * NS + k] = wk[k];
  }
  if (white_bkgd) {
    out_r += 1.f - wsum;
    out_g += 1.f - wsum;
    out_b += 1.f - wsum;
  }
  rgb_out[r * 3 + 0] = out_r;
  rgb_out[r * 3 + 1] = out_g;
  rgb_out[r * 3 + 2] = out_b;
  depth_out[r] = ez / es;
}

template <int S>
cudaError_t launch(const float* xyz, const float* uvd, const float* zvals,
                   const float* imgs, const float* vol, const float* cams,
                   const float* tar_cam, const float* vmask,
                   const float* params, float* rgb, float* depth,
                   float* weights, int B, int N, int H, int W, int Dv,
                   int Hv, int Wv, int white_bkgd, cudaStream_t stream) {
  const long long total = (long long)B * N;
  const long long blocks = (total + THREADS - 1) / THREADS;
  render_kernel<S><<<(unsigned)blocks, THREADS, 0, stream>>>(
      xyz, uvd, zvals, imgs, vol, cams, tar_cam, vmask, params, rgb, depth,
      weights, B, N, H, W, Dv, Hv, Wv, white_bkgd);
  return cudaGetLastError();
}

}  // namespace

extern "C" int enerf_render_rays(const float* xyz, const float* uvd,
                                 const float* zvals, const float* imgs,
                                 const float* vol, const float* cams,
                                 const float* tar_cam, const float* vmask,
                                 const float* params, float* rgb,
                                 float* depth, float* weights, int B, int N,
                                 int S, int H, int W, int Dv, int Hv, int Wv,
                                 int n_params, int white_bkgd, void* stream) {
  if (n_params != HeadLayout::SIZE) return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2: return (int)launch<2>(xyz, uvd, zvals, imgs, vol, cams, tar_cam, vmask, params, rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, st);
    case 3: return (int)launch<3>(xyz, uvd, zvals, imgs, vol, cams, tar_cam, vmask, params, rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, st);
    case 4: return (int)launch<4>(xyz, uvd, zvals, imgs, vol, cams, tar_cam, vmask, params, rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
