// Fused render stage of level 0 of the ENeRF cascade: IBR shading +
// compositing at the level-0 head shape.
//
// Replaces: enerf_tpu/ops/pallas/render.py, fused_render_rays (kernels
// _render_kernel -> _render_math, and _render_kernel_v5), at the shape of
// level 0 of configs/enerf/dtu_pretrain.yaml and of every config that
// inherits it: n = 8 samples a ray, Cf = 35 image channels (32 FPN
// channels + rgb), an 8-channel feature volume, S = 2, 3 or 4 source
// views, view-direction aggregation and vox features on. render.cu is the
// level-1 shape (Cf = 11, n = 2); its tensor-core tile is tied to it.
//
// Per ray, for each of its 8 samples (the math of render.cu):
//   1. per source view s: project the sample (R, t, then K at render
//      scale; z clamped at 1e-6), bilinear sample of the (feat ‖ rgb) map
//      with border padding, and the ray-difference feature
//      [normalize(tar_dir - src_dir), dot(tar_dir, src_dir)];
//   2. Agg: a_s = f_s + relu(view_fc(dir_s)); masked mean and unbiased var
//      over views; g_s = relu(global_fc([a_s, var, mean]));
//      agg = relu(fc(Σ softmax_s(relu(agg_w_fc(g_s))) g_s)), padded views
//      at logit -1e9;
//   3. vox = trilinear sample (zeros padding, align_corners) of the level's
//      un-resized (B, Dv, Hv, Wv, 8) feature volume at uvd; on grid rays
//      this equals the JAX package's spatial resize + tent over the Dv
//      planes (the tent is the two-plane lerp, 0 outside the volume);
//   4. h = relu(lr0([vox, agg])), sigma = softplus(sigma(h));
//   5. color: per view relu(color_2(relu(color_0([h, vox, agg, f_s, dir_s]))))
//      → masked softmax over views → blend of the source rgb;
// then alpha = 1 - exp(-sigma) (no dists), T = exclusive cumprod of
// (1 - alpha + 1e-10), weights = alpha T, rgb = Σ weights rgb (+ 1 - Σ
// weights with a white background), depth = Σ softmax(weights) z.
//
// What bounds it on the H100: operations. 26,020 multiply-adds a sample at
// S = 3 (per view: view_fc 140, global_fc 3,360, agg_w_fc 32, color_0's 39
// per-view inputs 2,496, color_2 64; once: fc 512, lr0 1,536, sigma 64 and
// color_0's 88 view-independent inputs 5,632), so 8.53 GFLOP for the
// 163,840 samples of a 512x640 frame's level 0 (128x160 rays), against
// ~25 MB in and out: 0.127 ms at the f32 CUDA-core rate.
//
// Design: f32 on the CUDA cores, simple first (the tensor cores are the
// later redesign).
//   - One warp a ray, under two lane maps. For the per-view work lane
//     k S + s holds sample k seen from view s (8 S <= 32 lanes; the lanes
//     past 8 S repeat sample 7 and are never read). For the per-sample
//     layers lane 4 k + c holds quarter c of sample k's outputs, so every
//     lane works whatever S is. Values cross between the maps by shuffles.
//   - A lane gathers its view's 35 channels and its direction once, into
//     its slots of the warp's shared scratch (read again by the color MLP).
//     Agg then runs channel by channel: a lane forms a_s of the channel,
//     reads the S values of its sample's lanes by shuffles, makes the
//     masked mean and var there, and adds the three columns of global_fc
//     to its 32 accumulators, so a, var and mean are never held whole.
//   - The pooling softmax is over the S lanes of a sample; each of the
//     sample's four lanes of the second map sums the pooled vector from
//     them and makes 4 of fc's 16 outputs, 16 of lr0's 64 and 16 of
//     color_0's view-independent 64; agg and h are shared by shuffles,
//     sigma's dot is a sum over the four lanes.
//   - Back in the first map, each lane adds its view's 39 inputs to that
//     view-independent part, 16 outputs at a time, then color_2, the
//     masked softmax over the sample's lanes and the rgb blend.
//   - Compositing: every lane reads the 8 samples' sigma and rgb by
//     shuffles; lane 0 writes rgb and depth, lane k weight k.
//   - The 14,050 head weights are loaded into shared memory once per
//     block, the matrices transposed to (in, out), and read as float4 (4
//     outputs a read): in the first map every lane reads the same address
//     (a broadcast), in the second the four lanes of a sample read four
//     neighbouring float4s (no bank conflict). The grid is persistent (2
//     blocks of 8 warps an SM), so a block loads the weights once for all
//     the rays its warps walk.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CF = 35;                  // image feature channels + rgb
constexpr int CV = 8;                   // feature-volume channels
constexpr int HID = 64;                 // NeRFHead hidden width
constexpr int GL = 32;                  // Agg global feature width
constexpr int AG = 16;                  // aggregated image feature width
constexpr int NS = 8;                   // samples per ray
constexpr int FD = CF + 4;              // per-view input: feat ‖ rgb ‖ dir ‖ dot
constexpr int VIF = CV + AG;            // [vox, agg]
constexpr int C0_SHARED = HID + VIF;    // color_0's view-independent inputs
constexpr int C0_IN = C0_SHARED + FD;   // color_0 input width
constexpr int RGB0 = CF - 3;            // the source rgb among the per-view inputs
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG = -1e9f;
constexpr unsigned FULL = 0xffffffffu;

// Flat head-weight buffer of a NeRFHead whose Agg takes C image channels:
// each torch Linear's (out, in) weight, then its bias
// (ops/kernels/render.py:head_params builds it in this order).
template <int C>
struct HeadLayout {
  static constexpr int VF_W = 0;
  static constexpr int VF_B = VF_W + C * 4;
  static constexpr int GF_W = VF_B + C;
  static constexpr int GF_B = GF_W + GL * 3 * C;
  static constexpr int AW_W = GF_B + GL;
  static constexpr int AW_B = AW_W + GL;
  static constexpr int FC_W = AW_B + 1;
  static constexpr int FC_B = FC_W + AG * GL;
  static constexpr int L0_W = FC_B + AG;
  static constexpr int L0_B = L0_W + HID * VIF;
  static constexpr int SG_W = L0_B + HID;
  static constexpr int SG_B = SG_W + HID;
  static constexpr int C0_W = SG_B + 1;
  static constexpr int C0_B = C0_W + HID * (C0_SHARED + C + 4);
  static constexpr int C1_W = C0_B + HID;
  static constexpr int C1_B = C1_W + HID;
  static constexpr int SIZE = C1_B + 1;
};
using Src = HeadLayout<CF>;
static_assert(HeadLayout<11>::SIZE == 10090, "render.cu's head at Cf = 11");
static_assert(Src::SIZE == 14050, "the head at Cf = 35");

constexpr int up4(int x) { return (x + 3) & ~3; }

// The block's shared copy of the head: matrices transposed to (in, out),
// vectors as they are; every float4 read starts at a multiple of 4.
struct Smem {
  static constexpr int VF_W = 0;                    // view_fc (CF, 4)
  static constexpr int VF_B = VF_W + CF * 4;
  static constexpr int GF_T = up4(VF_B + CF);       // global_fc (3 CF, GL)
  static constexpr int GF_B = GF_T + 3 * CF * GL;   // then agg_w_fc w, b
  static constexpr int AW_W = GF_B + GL;
  static constexpr int AW_B = AW_W + GL;
  static constexpr int FC_T = up4(AW_B + 1);        // fc (GL, AG)
  static constexpr int FC_B = FC_T + GL * AG;
  static constexpr int L0_T = up4(FC_B + AG);       // lr0 (VIF, HID)
  static constexpr int L0_B = L0_T + VIF * HID;     // then sigma w, b
  static constexpr int SG_W = L0_B + HID;
  static constexpr int SG_B = SG_W + HID;
  static constexpr int C0_T = up4(SG_B + 1);        // color_0 (C0_IN, HID)
  static constexpr int C0_B = C0_T + C0_IN * HID;   // then color_2 w, b
  static constexpr int C2_W = C0_B + HID;
  static constexpr int C2_B = C2_W + HID;
  static constexpr int SIZE = up4(C2_B + 1);
};
// ... then each warp's scratch: FD floats a lane, slot i of lane L at
// 32 i + L (conflict-free)
constexpr size_t SMEM_BYTES = (Smem::SIZE + WARPS * FD * 32) * sizeof(float);

__device__ void load_head(const float* __restrict__ p, float* w) {
  struct Mat { int src, dst, out, in; };
  const Mat mats[4] = {{Src::GF_W, Smem::GF_T, GL, 3 * CF},
                       {Src::FC_W, Smem::FC_T, AG, GL},
                       {Src::L0_W, Smem::L0_T, HID, VIF},
                       {Src::C0_W, Smem::C0_T, HID, C0_IN}};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const Mat mt = mats[m];
    for (int j = threadIdx.x; j < mt.out * mt.in; j += blockDim.x) {
      const int i = j / mt.out, o = j - i * mt.out;
      w[mt.dst + j] = p[mt.src + o * mt.in + i];
    }
  }
  struct Vec { int src, dst, len; };
  const Vec vecs[5] = {{Src::VF_W, Smem::VF_W, CF * 4 + CF},
                       {Src::GF_B, Smem::GF_B, GL + GL + 1},
                       {Src::FC_B, Smem::FC_B, AG},
                       {Src::L0_B, Smem::L0_B, HID + HID + 1},
                       {Src::C0_B, Smem::C0_B, HID + HID + 1}};
#pragma unroll
  for (int v = 0; v < 5; ++v)
    for (int i = threadIdx.x; i < vecs[v].len; i += blockDim.x)
      w[vecs[v].dst + i] = p[vecs[v].src + i];
}

__device__ __forceinline__ float4 ld4(const float* w, int off) {
  return *reinterpret_cast<const float4*>(w + off);
}

// acc[0..3] += x · (w.x, w.y, w.z, w.w)
__device__ __forceinline__ void fma4(float* acc, float4 w, float x) {
  acc[0] += w.x * x;
  acc[1] += w.y * x;
  acc[2] += w.z * x;
  acc[3] += w.w * x;
}

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// Input i of [vox, agg] (lr0's input, and color_0's after h).
__device__ __forceinline__ float vin(const float (&vox)[CV],
                                     const float (&agg)[AG], int i) {
  return i < CV ? vox[i] : agg[i >= CV ? i - CV : 0];
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Camera center -R^T t of a world-to-camera (4, 4) extrinsic.
__device__ __forceinline__ void cam_center(const float* __restrict__ E,
                                           float (&c)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = -(E[i] * E[3] + E[4 + i] * E[7] + E[8 + i] * E[11]);
}

// Trilinear sample with zeros padding of a (Dv, Hv, Wv, CV) volume at voxel
// coordinates (x, y, z): all CV channels.
__device__ __forceinline__ void sample_volume(const float* __restrict__ vol,
                                              int Dv, int Hv, int Wv, float x,
                                              float y, float z,
                                              float (&out)[CV]) {
  // clamping to [-2, size+1] changes no sample and keeps float->int in range
  x = fminf(fmaxf(x, -2.f), (float)Wv + 1.f);
  y = fminf(fmaxf(y, -2.f), (float)Hv + 1.f);
  z = fminf(fmaxf(z, -2.f), (float)Dv + 1.f);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float tw[3] = {x - x0f, y - y0f, z - z0f};
  const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
#pragma unroll
  for (int i = 0; i < CV; ++i) out[i] = 0.f;
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const int zi = z0 + dz;
    if (zi < 0 || zi > Dv - 1) continue;
    const float wz = dz ? tw[2] : 1.f - tw[2];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int yi = y0 + dy;
      if (yi < 0 || yi > Hv - 1) continue;
      const float wy = dy ? tw[1] : 1.f - tw[1];
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int xi = x0 + dx;
        if (xi < 0 || xi > Wv - 1) continue;
        const float wgt = wz * wy * (dx ? tw[0] : 1.f - tw[0]);
        const float4* a = reinterpret_cast<const float4*>(
            vol + (((long long)zi * Hv + yi) * Wv + xi) * CV);
        fma4(out, __ldg(a), wgt);
        fma4(out + 4, __ldg(a + 1), wgt);
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 2)
render_l0_kernel(const float* __restrict__ xyz, const float* __restrict__ uvd,
                 const float* __restrict__ zvals, const float* __restrict__ imgs,
                 const float* __restrict__ vol,
                 const float* __restrict__ src_exts,
                 const float* __restrict__ src_ixts,
                 const float* __restrict__ tar_ext,
                 const float* __restrict__ vmask,
                 const float* __restrict__ params, float* __restrict__ rgb_out,
                 float* __restrict__ depth_out, float* __restrict__ w_out,
                 int B, int N, int H, int W, int Dv, int Hv, int Wv,
                 int white_bkgd, float render_scale) {
  static_assert(NS * S <= 32, "a warp holds every (sample, view) of a ray");
  extern __shared__ float4 smem[];
  float* w = reinterpret_cast<float*>(smem);
  load_head(params, w);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  float* fs = w + Smem::SIZE + (threadIdx.x >> 5) * (FD * 32) + lane;
  const int kA = min(lane / S, NS - 1), sA = lane % S, gA = kA * S;  // map 1
  const int kB = lane >> 2, cB = lane & 3;                           // map 2
  const long long total = (long long)B * N;

#pragma unroll 1
  for (long long r = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       r < total; r += (long long)gridDim.x * WARPS) {
    const int b = (int)(r / N);
    float m[S];
    float cnt = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      m[s] = vmask[b * S + s] != 0.f ? 1.f : 0.f;
      cnt += m[s];
    }
    cnt = fmaxf(cnt, 1.f);
    const bool view_on = vmask[b * S + sA] != 0.f;

    // 1. map 1: sample kA seen from view sA; its 35 channels and the
    // direction go to the lane's scratch slots 0..38
    float dir[4];
    {
      const float* p = xyz + (r * NS + kA) * 3;
      const float X = p[0], Y = p[1], Z = p[2];
      const float* E = src_exts + ((long long)b * S + sA) * 16;
      const float* K = src_ixts + ((long long)b * S + sA) * 9;
      const float c0 = X * E[0] + Y * E[1] + Z * E[2] + E[3];
      const float c1 = X * E[4] + Y * E[5] + Z * E[6] + E[7];
      const float c2 = X * E[8] + Y * E[9] + Z * E[10] + E[11];
      const float i0 = c0 * (K[0] * render_scale) + c1 * (K[1] * render_scale) +
                       c2 * (K[2] * render_scale);
      const float i1 = c0 * (K[3] * render_scale) + c1 * (K[4] * render_scale) +
                       c2 * (K[5] * render_scale);
      const float zc = fmaxf(c0 * K[6] + c1 * K[7] + c2 * K[8], 1e-6f);
      // bilinear sample, border padding in pixel coordinates
      const float u = fminf(fmaxf(i0 / zc, 0.f), (float)(W - 1));
      const float v = fminf(fmaxf(i1 / zc, 0.f), (float)(H - 1));
      const float x0f = floorf(u), y0f = floorf(v);
      const float tx = u - x0f, ty = v - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
      const float* img = imgs + ((long long)b * S + sA) * H * W * CF;
      const float* r00 = img + ((long long)y0 * W + x0) * CF;
      const float* r01 = img + ((long long)y0 * W + x1) * CF;
      const float* r10 = img + ((long long)y1 * W + x0) * CF;
      const float* r11 = img + ((long long)y1 * W + x1) * CF;
#pragma unroll 5
      for (int c = 0; c < CF; ++c) {
        const float top = (1.f - tx) * __ldg(r00 + c) + tx * __ldg(r01 + c);
        const float bot = (1.f - tx) * __ldg(r10 + c) + tx * __ldg(r11 + c);
        fs[32 * c] = (1.f - ty) * top + ty * bot;
      }
      float tc[3], sc[3], td[3], sd[3];
      cam_center(tar_ext + b * 16, tc);
      cam_center(E, sc);
      const float P[3] = {X, Y, Z};
      float tn = 0.f, sn = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        td[i] = P[i] - tc[i];
        sd[i] = P[i] - sc[i];
        tn += td[i] * td[i];
        sn += sd[i] * sd[i];
      }
      tn = sqrtf(tn) + 1e-6f;
      sn = sqrtf(sn) + 1e-6f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        td[i] /= tn;
        sd[i] /= sn;
      }
      const float rx = td[0] - sd[0], ry = td[1] - sd[1], rz = td[2] - sd[2];
      const float rn = fmaxf(sqrtf(rx * rx + ry * ry + rz * rz), 1e-6f);
      dir[0] = rx / rn;
      dir[1] = ry / rn;
      dir[2] = rz / rn;
      dir[3] = td[0] * sd[0] + td[1] * sd[1] + td[2] * sd[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) fs[32 * (CF + i)] = dir[i];
    }

    // 2. Agg, channel by channel: a_s, its masked mean and unbiased var
    // over the sample's S lanes, and global_fc's three columns of it
    float g[GL];
#pragma unroll
    for (int j = 0; j < GL; ++j) g[j] = w[Smem::GF_B + j];
#pragma unroll 1
    for (int c = 0; c < CF; ++c) {
      const float4 wv = ld4(w, Smem::VF_W + 4 * c);
      const float a = fs[32 * c] + relu(w[Smem::VF_B + c] + wv.x * dir[0] +
                                        wv.y * dir[1] + wv.z * dir[2] +
                                        wv.w * dir[3]);
      float av[S], sum = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        av[s] = __shfl_sync(FULL, a, gA + s);
        sum += av[s] * m[s];
      }
      const float mean = sum / cnt;
      float ss = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float d = av[s] - mean;
        ss += d * d * m[s];
      }
      const float var = ss / fmaxf(cnt - 1.f, 1.f);
#pragma unroll
      for (int j = 0; j < GL / 4; ++j) {
        fma4(g + 4 * j, ld4(w, Smem::GF_T + c * GL + 4 * j), a);
        fma4(g + 4 * j, ld4(w, Smem::GF_T + (CF + c) * GL + 4 * j), var);
        fma4(g + 4 * j, ld4(w, Smem::GF_T + (2 * CF + c) * GL + 4 * j), mean);
      }
    }
    // pooling weights: masked softmax over the sample's S lanes
    float lg = w[Smem::AW_B];
#pragma unroll
    for (int j = 0; j < GL; ++j) {
      g[j] = relu(g[j]);
      lg += w[Smem::AW_W + j] * g[j];
    }
    lg = view_on ? relu(lg) : NEG;
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) mx = fmaxf(mx, __shfl_sync(FULL, lg, gA + s));
    const float e = expf(lg - mx);
    float den = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) den += __shfl_sync(FULL, e, gA + s);
    const float pw = e / den;
#pragma unroll
    for (int j = 0; j < GL; ++j) g[j] *= pw;

    // 3. map 2: the pooled vector of sample kB from its S lanes, fc's
    // outputs 4 cB.., then all 16 by shuffles
    float aq[4];
    {
      const float4 bq = ld4(w, Smem::FC_B + 4 * cB);
      aq[0] = bq.x; aq[1] = bq.y; aq[2] = bq.z; aq[3] = bq.w;
#pragma unroll
      for (int i = 0; i < GL; ++i) {
        float pooled = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) pooled += __shfl_sync(FULL, g[i], kB * S + s);
        fma4(aq, ld4(w, Smem::FC_T + i * AG + 4 * cB), pooled);
      }
    }
    float agg[AG];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4)
        agg[4 * c + e4] = relu(__shfl_sync(FULL, aq[e4], 4 * kB + c));
    float vox[CV];
    {
      const float* q = uvd + (r * NS + kB) * 3;
      sample_volume(vol + (long long)b * Dv * Hv * Wv * CV, Dv, Hv, Wv,
                    q[0] * (Wv - 1), q[1] * (Hv - 1), q[2] * (Dv - 1), vox);
    }
    // lr0: h's outputs 16 q + 4 cB + e (e < 4) of sample kB; sigma
    float h[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 bq = ld4(w, Smem::L0_B + 16 * q + 4 * cB);
      h[4 * q] = bq.x; h[4 * q + 1] = bq.y; h[4 * q + 2] = bq.z; h[4 * q + 3] = bq.w;
    }
#pragma unroll
    for (int i = 0; i < VIF; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fma4(h + 4 * q, ld4(w, Smem::L0_T + i * HID + 16 * q + 4 * cB), vin(vox, agg, i));
    float sp = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        h[4 * q + e4] = relu(h[4 * q + e4]);
        sp += w[Smem::SG_W + 16 * q + 4 * cB + e4] * h[4 * q + e4];
      }
    sp += __shfl_xor_sync(FULL, sp, 1);
    sp += __shfl_xor_sync(FULL, sp, 2);
    const float sigma = softplus(sp + w[Smem::SG_B]);
    // color_0's view-independent part [h, vox, agg], the same 16 outputs;
    // h's 64 values come from the sample's four lanes
    float base[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 bq = ld4(w, Smem::C0_B + 16 * q + 4 * cB);
      base[4 * q] = bq.x; base[4 * q + 1] = bq.y;
      base[4 * q + 2] = bq.z; base[4 * q + 3] = bq.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          const float hv = __shfl_sync(FULL, h[4 * q + e4], 4 * kB + c);
          const int i = 16 * q + 4 * c + e4;
#pragma unroll
          for (int q2 = 0; q2 < 4; ++q2)
            fma4(base + 4 * q2, ld4(w, Smem::C0_T + i * HID + 16 * q2 + 4 * cB), hv);
        }
#pragma unroll
    for (int i = 0; i < VIF; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        fma4(base + 4 * q, ld4(w, Smem::C0_T + (HID + i) * HID + 16 * q + 4 * cB),
             vin(vox, agg, i));

    // 4. map 1: color_0's per-view part on top of the base, 16 outputs at a
    // time, color_2, the masked softmax over views and the rgb blend
    float x[FD];
#pragma unroll
    for (int i = 0; i < FD; ++i) x[i] = fs[32 * i];
    float lc = w[Smem::C2_B];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float acc[16];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4)
          acc[4 * c + e4] = __shfl_sync(FULL, base[4 * q + e4], 4 * kA + c);
#pragma unroll
      for (int i = 0; i < FD; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          fma4(acc + 4 * c, ld4(w, Smem::C0_T + (C0_SHARED + i) * HID + 16 * q + 4 * c), x[i]);
#pragma unroll
      for (int j = 0; j < 16; ++j) lc += w[Smem::C2_W + 16 * q + j] * relu(acc[j]);
    }
    lc = view_on ? relu(lc) : NEG;
    float cmx = -INFINITY;
#pragma unroll
    for (int s = 0; s < S; ++s) cmx = fmaxf(cmx, __shfl_sync(FULL, lc, gA + s));
    const float ce = expf(lc - cmx);
    float cden = 0.f, crgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      cden += __shfl_sync(FULL, ce, gA + s);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        crgb[ch] += __shfl_sync(FULL, ce * x[RGB0 + ch], gA + s);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) crgb[ch] /= cden;

    // 5. alpha compositing over the ray's 8 samples
    float T = 1.f, wsum = 0.f, wmax = -INFINITY, out[3] = {0.f, 0.f, 0.f};
    float wk[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float alpha = 1.f - expf(-__shfl_sync(FULL, sigma, 4 * k));
      wk[k] = alpha * T;
      T *= 1.f - alpha + 1e-10f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        out[ch] += wk[k] * __shfl_sync(FULL, crgb[ch], k * S);
      wsum += wk[k];
      wmax = fmaxf(wmax, wk[k]);
      if (lane == k) w_out[r * NS + k] = wk[k];
    }
    if (lane == 0) {
      float ez = 0.f, es = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float ek = expf(wk[k] - wmax);
        es += ek;
        ez += ek * zvals[r * NS + k];
      }
      depth_out[r] = ez / es;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        rgb_out[r * 3 + ch] = white_bkgd ? out[ch] + (1.f - wsum) : out[ch];
    }
  }
}

template <int S>
cudaError_t launch(const float* xyz, const float* uvd, const float* zvals,
                   const float* imgs, const float* vol, const float* src_exts,
                   const float* src_ixts, const float* tar_ext, const float* vmask,
                   const float* params, float* rgb, float* depth,
                   float* weights, int B, int N, int H, int W, int Dv,
                   int Hv, int Wv, int white_bkgd, float render_scale,
                   cudaStream_t stream) {
  static int blocks_per_sm = 0;   // per S: set once, then read
  cudaError_t err;
  if (blocks_per_sm == 0) {
    err = cudaFuncSetAttribute(render_l0_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return err;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, render_l0_kernel<S>,
                                                        THREADS, SMEM_BYTES);
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorInvalidConfiguration;
    blocks_per_sm = nb;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long want = ((long long)B * N + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * blocks_per_sm;
  const long long blocks = want < cap ? want : cap;
  render_l0_kernel<S><<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(
      xyz, uvd, zvals, imgs, vol, src_exts, src_ixts, tar_ext, vmask, params,
      rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, render_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int enerf_render_rays_l0(const float* xyz, const float* uvd,
                                    const float* zvals, const float* imgs,
                                    const float* vol, const float* src_exts,
                                    const float* src_ixts, const float* tar_ext,
                                    const float* vmask, const float* params,
                                    float* rgb, float* depth, float* weights,
                                    int B, int N, int S, int H, int W, int Dv,
                                    int Hv, int Wv, int n_params, int white_bkgd,
                                    float render_scale, void* stream) {
  if (n_params != Src::SIZE) return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 2: return (int)launch<2>(xyz, uvd, zvals, imgs, vol, src_exts, src_ixts, tar_ext, vmask, params, rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, render_scale, st);
    case 3: return (int)launch<3>(xyz, uvd, zvals, imgs, vol, src_exts, src_ixts, tar_ext, vmask, params, rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, render_scale, st);
    case 4: return (int)launch<4>(xyz, uvd, zvals, imgs, vol, src_exts, src_ixts, tar_ext, vmask, params, rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, render_scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
