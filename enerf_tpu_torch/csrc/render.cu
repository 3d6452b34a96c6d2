// Fused render stage of one ENeRF cascade level: IBR shading + compositing.
//
// Replaces: enerf_tpu/ops/pallas/render.py, fused_render_rays (kernels
// _render_kernel -> _render_math, and _render_kernel_v5). The TPU kernel
// reads a lane-packed operand of pre-gathered, pre-blended features and
// the spatially resized feature volume; this kernel samples the source
// feature maps and the un-resized volume itself, so neither the gathered
// features nor the resized volume ever reach device memory.
//
// Per ray, for each of its NS = 2 samples:
//   1. per source view s: project the sample (R, t, then K at render
//      scale; z clamped at 1e-6; the cameras are read as the caller's
//      (4, 4) extrinsics and (3, 3) intrinsics, camera centers -R^T t made
//      here), bilinear sample of the (feat ‖ rgb) map
//      with border padding, and the ray-difference feature
//      [normalize(tar_dir - src_dir), dot(tar_dir, src_dir)];
//   2. Agg: a_s = f_s + relu(view_fc(dir_s)); masked mean and unbiased var
//      over views; g_s = relu(global_fc([a_s, var, mean]));
//      agg = relu(fc(Σ softmax_s(relu(agg_w_fc(g_s))) g_s)), padded views
//      at logit -1e9;
//   3. vox = trilinear sample (zeros padding, align_corners) of the level's
//      (B, Dv, Hv, Wv, 8) feature volume at uvd; on grid rays this equals
//      the JAX package's spatial resize + tent over the depth planes. The
//      volume is float or, in the bf16 compute mode, bf16 (a template
//      parameter): a lane's two channels are then one 4-byte load, turned
//      into floats as they are read, as the TPU kernel converts its bf16
//      volume in VMEM; every other input and all arithmetic stay float;
//   4. h = relu(lr0([vox, agg])), sigma = softplus(sigma(h));
//   5. color: per view relu(color_2(relu(color_0([h, vox, agg, f_s, dir_s]))))
//      → masked softmax over views → blend of the source rgb;
// then alpha = 1 - exp(-sigma) (no dists), T = exclusive cumprod of
// (1 - alpha + 1e-10), weights = alpha T, rgb = Σ weights rgb (+ 1 - Σ
// weights with a white background), depth = Σ softmax(weights) z.
//
// What bounds it on the H100: operations. 14,212 multiply-adds a sample at
// S = 3 (per view: view_fc 44, global_fc 1,056, agg_w_fc 32, color_0's 15
// per-view inputs 960, color_2 64; once: fc 512, lr0 1,536, sigma 64 and
// color_0's 88 view-independent inputs 5,632), so 18.6 GFLOP for the
// 655,360 samples of a 512x640 frame, against ~85 MB in and out: 0.28 ms
// at the f32 CUDA-core rate, 0.11 ms for three TF32 passes at the tensor
// cores' rate.
//
// Design. The head's five products run on the tensor cores as
// mma.sync.m16n8k8 TF32 tiles (wgmma wants 64-row tiles from shared
// memory and widths of 16-88 padded to its shapes; mma.sync keeps each
// warp's 16-sample tile in registers from layer to layer). To stay at f32
// accuracy every operand x is split as hi = tf32(x), lo = tf32(x - hi) and
// each product is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, accumulated in f32
// (the counterpart of the TPU kernel's HIGHEST-precision split matmuls).
//   - One warp owns a tile of 8 rays × 2 samples: row g of the m16 tile is
//     sample 0 of ray g and row g + 8 its sample 1, so the four lanes of a
//     quad (lanes 4g..4g+3) hold both samples of ray g, and every view of
//     a sample lies in the same lane: the cross-view mean / var and both
//     softmaxes are lane-local; a dot over channels is a sum over the quad.
//   - Layers chain in registers: an accumulator fragment (lane t holds
//     columns 2t, 2t+1 of each 8-column block) is the next product's A
//     fragment once the weights' K order within each 8-block is permuted
//     to (0, 2, 4, 6, 1, 3, 5, 7); each block builds its weight fragments,
//     split and permuted, from the flat f32 head buffer in its prologue.
//   - The grid is persistent (one block of 12 warps per SM: the split
//     weight fragments take 80 KB of shared memory and a lane up to 168
//     registers), so the 10,090 weights are loaded and split once per
//     block, not once per tile; each warp walks tiles on its own, with no
//     block barrier.
//   - Quad lane t gathers image channels t, t+4, t+8 and direction
//     component t of its samples, and volume channels 2t, 2t+1, which are
//     exactly the values its A fragments take. What it gathers per view
//     and reads again later waits in the warp's shared scratch, not in
//     registers (no spills at 168 registers for S = 2, 3, 4).
//   - global_fc's var / mean inputs are the same for every view: their
//     product is done once per sample and starts each view's accumulator.
//     color_0's view-independent part is made once per sample, and h one
//     8-column block at a time, each block at once a K tile of color_0.
//   - view_fc, agg_w_fc, sigma and color_2 (widths 4 → 11 and → 1), the
//     softmaxes and the compositing stay on the CUDA cores in f32.
// The tile is 612 mma.sync for S = 3 (204 products of three passes), and
// the tensor cores' mma.sync rate for TF32, not the gathers, sets its pace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int WARPS = 12;
constexpr int THREADS = WARPS * 32;
constexpr int RAYS = 8;                // rays of one warp tile (16 samples)
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

// The tensor-core products, as (K tiles of 8) x (N tiles of 8) fragments:
// fragment (kt, n) of a product is frag0 + kt * nt + n. The K order of each
// product is what the lanes hold (see in_index).
enum Product { GFA, GFM, FC, L0, C0S, C0V, N_PRODUCTS };
struct ProductShape { int nt, frag0, w, in; };
__constant__ ProductShape PRODUCTS[N_PRODUCTS] = {
    {4, 0, HeadLayout::GF_W, 3 * CF},      // global_fc, the a_s inputs: K 16
    {4, 8, HeadLayout::GF_W, 3 * CF},      // global_fc, var and mean: K 24
    {2, 20, HeadLayout::FC_W, GL},         // fc: K 32
    {8, 28, HeadLayout::L0_W, VIF},        // lr0: K 24
    {8, 52, HeadLayout::C0_W, C0_IN},      // color_0, h ‖ vox ‖ agg: K 88
    {8, 140, HeadLayout::C0_W, C0_IN},     // color_0, the per-view inputs: K 16
};
constexpr int F_GFA = 0, F_GFM = 8, F_FC = 20, F_L0 = 28, F_C0S = 52,
              F_C0V = 140, N_FRAG = 156;

// Shared copies of the vectors the CUDA cores read, at even offsets.
constexpr int V_VF = 0;                 // view_fc weight (44), then bias (11)
constexpr int V_GF = 56;                // global_fc bias (32), agg_w_fc w, b
constexpr int V_FC = 124;               // fc bias (16)
constexpr int V_L0 = 140;               // lr0 bias (64), sigma w (64), b
constexpr int V_C0 = 272;               // color_0 bias (64), color_2 w, b
constexpr int N_VEC = 404;
struct VecCopy { int dst, src, len; };
__constant__ VecCopy VEC_COPIES[5] = {
    {V_VF, HeadLayout::VF_W, CF * 4 + CF},
    {V_GF, HeadLayout::GF_B, GL + GL + 1},
    {V_FC, HeadLayout::FC_B, AG},
    {V_L0, HeadLayout::L0_B, HID + HID + 1},
    {V_C0, HeadLayout::C0_B, HID + HID + 1},
};
// Dynamic shared memory of a block: the fragments, the vectors, and each
// warp's scratch for what a lane gathers per view and sample and reads
// again later (the 4 per-view input slots, the 3 view_fc outputs a_s),
// which would not fit in the registers beside the rest.
constexpr int SCRATCH = 7;   // floats a lane keeps per view and sample
template <int S>
constexpr size_t smem_bytes() {
  return N_FRAG * 32 * sizeof(float4) + (N_VEC + WARPS * S * NS * SCRATCH * 32) * sizeof(float);
}

// Column c (0..7) of K tile kt of product p: the index of its input in the
// torch weight row, or -1 for zero padding.
//   - inputs a lane gathers itself sit in "slots": slot q of quad lane t is
//     K tile q / 2, column t + 4 (q % 2);
//   - inputs that come from an accumulator fragment sit at 8 kt + perm(c),
//     perm = (0, 2, 4, 6, 1, 3, 5, 7).
__device__ int in_index(int p, int kt, int c) {
  const int t = c & 3, q = 2 * kt + (c >> 2);
  const int perm = c < 4 ? 2 * c : 2 * (c - 4) + 1;
  switch (p) {
    case GFA:  // slots 0..2: a channel t + 4q
      return q < 3 && t + 4 * q < CF ? t + 4 * q : -1;
    case GFM: {  // slots 0..2: var channel t + 4q, 3..5: mean channel
      const int ch = t + 4 * (q % 3);
      return ch < CF ? (q < 3 ? CF : 2 * CF) + ch : -1;
    }
    case C0V:  // slots 0..2: feat ‖ rgb channel t + 4q, slot 3: dir t
      if (q == 3) return HID + VIF + CF + t;
      return t + 4 * q < CF ? HID + VIF + t + 4 * q : -1;
    default:   // FC, L0, C0S
      return 8 * kt + perm;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The block's prologue: every weight fragment, split into hi / lo TF32.
// Fragment f, lane L = 4g + t holds {b0.hi, b1.hi, b0.lo, b1.lo} with
// b0 = B[k = t][n = g], b1 = B[k = t + 4][n = g] of its K x N tile.
__device__ void build_fragments(const float* __restrict__ params,
                                float4* frag, float* vec) {
  for (int i = threadIdx.x; i < N_FRAG * 32; i += blockDim.x) {
    const int f = i >> 5, lane = i & 31;
    int p = 0;
    while (p + 1 < N_PRODUCTS && f >= PRODUCTS[p + 1].frag0) ++p;
    const ProductShape ps = PRODUCTS[p];
    const int kt = (f - ps.frag0) / ps.nt, nt = (f - ps.frag0) % ps.nt;
    const float* wrow = params + ps.w + (8 * nt + (lane >> 2)) * ps.in;
    float w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int in = in_index(p, kt, (lane & 3) + 4 * e);
      w[e] = in >= 0 ? wrow[in] : 0.f;
    }
    const uint32_t h0 = to_tf32(w[0]), h1 = to_tf32(w[1]);
    frag[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                          __uint_as_float(to_tf32(w[0] - __uint_as_float(h0))),
                          __uint_as_float(to_tf32(w[1] - __uint_as_float(h1))));
  }
  for (int j = 0; j < 5; ++j) {
    const VecCopy vc = VEC_COPIES[j];
    for (int i = threadIdx.x; i < vc.len; i += blockDim.x)
      vec[vc.dst + i] = params[vc.src + i];
  }
}

// An A fragment split into hi / lo TF32.
struct AFrag { uint32_t hi[4], lo[4]; };

__device__ __forceinline__ AFrag split(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  AFrag r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r.hi[i] = to_tf32(a[i]);
    r.lo[i] = to_tf32(a[i] - __uint_as_float(r.hi[i]));
  }
  return r;
}

// The A fragment of an accumulator fragment (rows g, g + 8; columns 2t,
// 2t + 1), in the permuted K order.
__device__ __forceinline__ AFrag split_acc(const float (&c)[4]) {
  return split(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b in three TF32 passes: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma(d, a.lo, bh0, bh1);
  mma(d, a.hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma(d, a.hi, bh0, bh1);
}

// Accumulator fragments of an N-wide product, started at the bias.
template <int NT>
__device__ __forceinline__ void init_bias(float (&d)[NT][4], const float* bias,
                                          int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    d[j][0] = d[j][2] = b.x;
    d[j][1] = d[j][3] = b.y;
  }
}

template <int NT>
__device__ __forceinline__ void relu_all(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = fmaxf(d[j][e], 0.f);
}

// Per row (sample 0, sample 1) of the quad: Σ_n w[n] d[n] over the lane's
// columns; quad_sum completes it.
template <int NT>
__device__ __forceinline__ void dot_rows(const float (&d)[NT][4],
                                         const float* w, int t, float (&out)[2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 ww = *reinterpret_cast<const float2*>(w + 8 * j + 2 * t);
    out[0] += ww.x * d[j][0] + ww.y * d[j][1];
    out[1] += ww.x * d[j][2] + ww.y * d[j][3];
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.f); }

// Camera center -R^T t of a world-to-camera (4, 4) extrinsic.
__device__ __forceinline__ void cam_center(const float* __restrict__ E,
                                           float (&c)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = -(E[i] * E[3] + E[4 + i] * E[7] + E[8 + i] * E[11]);
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Two consecutive volume channels as floats: one 8-byte load of float, one
// 4-byte load of bf16 (a bf16 is the upper half of its float's bits).
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Trilinear sample with zeros padding of a (Dv, Hv, Wv, CV) volume at voxel
// coordinates (x, y, z): channels 2t and 2t + 1.
template <typename TV>
__device__ __forceinline__ float2 sample_volume(const TV* __restrict__ vol,
                                                int Dv, int Hv, int Wv,
                                                float x, float y, float z,
                                                int t) {
  // clamping to [-2, size+1] changes no sample and keeps float->int in range
  x = fminf(fmaxf(x, -2.f), (float)Wv + 1.f);
  y = fminf(fmaxf(y, -2.f), (float)Hv + 1.f);
  z = fminf(fmaxf(z, -2.f), (float)Dv + 1.f);
  const float x0f = floorf(x), y0f = floorf(y), z0f = floorf(z);
  const float tw[3] = {x - x0f, y - y0f, z - z0f};
  const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
  float2 out = make_float2(0.f, 0.f);
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
        const float2 a = load2(vol + (((long long)zi * Hv + yi) * Wv + xi) * CV + 2 * t);
        out.x += wgt * a.x;
        out.y += wgt * a.y;
      }
    }
  }
  return out;
}

template <int S, typename TV>
__global__ void __launch_bounds__(THREADS, 1)
render_kernel(const float* __restrict__ xyz, const float* __restrict__ uvd,
              const float* __restrict__ zvals, const float* __restrict__ imgs,
              const TV* __restrict__ vol,
              const float* __restrict__ src_exts,
              const float* __restrict__ src_ixts,
              const float* __restrict__ tar_ext,
              const float* __restrict__ vmask,
              const float* __restrict__ params, float* __restrict__ rgb_out,
              float* __restrict__ depth_out, float* __restrict__ w_out,
              int B, int N, int H, int W, int Dv, int Hv, int Wv,
              int white_bkgd, float render_scale) {
  extern __shared__ float4 smem[];
  float4* frag = smem;
  float* vec = reinterpret_cast<float*>(smem + N_FRAG * 32);
  build_fragments(params, frag, vec);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // lane-private scratch of (view s, sample k): the per-view input slot q
  // at fd[32 ((s NS + k) 4 + q)], the view_fc output slot q at
  // av[32 ((s NS + k) 3 + q)]
  float* fd = vec + N_VEC + (threadIdx.x >> 5) * (S * NS * SCRATCH * 32) + lane;
  float* av = fd + S * NS * 4 * 32;
  const float4* fl = frag + lane;   // fragment f of this lane: fl[32 f]
  const long long total = (long long)B * N;
  const long long n_tiles = (total + RAYS - 1) / RAYS;

#pragma unroll 1
  for (long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       tile < n_tiles; tile += (long long)gridDim.x * WARPS) {
    // Lanes past the last ray redo the last ray and store nothing: every
    // lane takes part in the quad sums.
    const long long r = tile * RAYS + g;
    const bool valid = r < total;
    const long long rc = valid ? r : total - 1;
    const int b = (int)(rc / N);

    float m[S];
    float cnt = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      m[s] = vmask[b * S + s] != 0.f ? 1.f : 0.f;
      cnt += m[s];
    }
    cnt = fmaxf(cnt, 1.f);

    // 1. target directions, then per view: samples, directions, view_fc
    float P[NS][3], td[NS][3], tc[3];
    cam_center(tar_ext + b * 16, tc);
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float* p = xyz + (rc * NS + k) * 3;
      float tn = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        P[k][i] = p[i];
        td[k][i] = P[k][i] - tc[i];
        tn += td[k][i] * td[k][i];
      }
      tn = sqrtf(tn) + 1e-6f;
#pragma unroll
      for (int i = 0; i < 3; ++i) td[k][i] /= tn;
    }
    // fd: slots 0..2 image channel t + 4q (0 past channel 10), slot 3
    // direction component t; av: the slots 0..2 after view_fc
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // cam: R (9, row-major), t (3), K at render scale (9), center (3)
      float cam[24];
      {
        const float* E = src_exts + ((long long)b * S + s) * 16;
        const float* K = src_ixts + ((long long)b * S + s) * 9;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            cam[3 * i + j] = E[4 * i + j];
            cam[12 + 3 * i + j] = i < 2 ? K[3 * i + j] * render_scale : K[3 * i + j];
          }
          cam[9 + i] = E[4 * i + 3];
        }
        float c[3];
        cam_center(E, c);
        cam[21] = c[0]; cam[22] = c[1]; cam[23] = c[2];
      }
      const float* img = imgs + ((long long)b * S + s) * H * W * CF;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float X = P[k][0], Y = P[k][1], Z = P[k][2];
        const float c0 = X * cam[0] + Y * cam[1] + Z * cam[2] + cam[9];
        const float c1 = X * cam[3] + Y * cam[4] + Z * cam[5] + cam[10];
        const float c2 = X * cam[6] + Y * cam[7] + Z * cam[8] + cam[11];
        const float i0 = c0 * cam[12] + c1 * cam[13] + c2 * cam[14];
        const float i1 = c0 * cam[15] + c1 * cam[16] + c2 * cam[17];
        const float zc = fmaxf(c0 * cam[18] + c1 * cam[19] + c2 * cam[20], 1e-6f);
        // bilinear sample, border padding in pixel coordinates
        const float u = fminf(fmaxf(i0 / zc, 0.f), (float)(W - 1));
        const float v = fminf(fmaxf(i1 / zc, 0.f), (float)(H - 1));
        const float x0f = floorf(u), y0f = floorf(v);
        const float tx = u - x0f, ty = v - y0f;
        const int x0 = (int)x0f, y0 = (int)y0f;
        const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
        const float* r00 = img + ((long long)y0 * W + x0) * CF;
        const float* r01 = img + ((long long)y0 * W + x1) * CF;
        const float* r10 = img + ((long long)y1 * W + x0) * CF;
        const float* r11 = img + ((long long)y1 * W + x1) * CF;
        float fq[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          // lane 3's slot 2 would be channel 11: it reads channel 10, is 0
          const int ch = min(t + 4 * q, CF - 1);
          const float top = (1.f - tx) * __ldg(r00 + ch) + tx * __ldg(r01 + ch);
          const float bot = (1.f - tx) * __ldg(r10 + ch) + tx * __ldg(r11 + ch);
          fq[q] = q < 2 || t < 3 ? (1.f - ty) * top + ty * bot : 0.f;
          fd[32 * ((s * NS + k) * 4 + q)] = fq[q];
        }
        float sd[3], sn = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          sd[i] = P[k][i] - cam[21 + i];
          sn += sd[i] * sd[i];
        }
        sn = sqrtf(sn) + 1e-6f;
#pragma unroll
        for (int i = 0; i < 3; ++i) sd[i] /= sn;
        const float rx = td[k][0] - sd[0], ry = td[k][1] - sd[1], rz = td[k][2] - sd[2];
        const float rn = fmaxf(sqrtf(rx * rx + ry * ry + rz * rz), 1e-6f);
        const float dir[4] = {rx / rn, ry / rn, rz / rn,
                              td[k][0] * sd[0] + td[k][1] * sd[1] + td[k][2] * sd[2]};
        fd[32 * ((s * NS + k) * 4 + 3)] = t == 0 ? dir[0] : t == 1 ? dir[1] : t == 2 ? dir[2] : dir[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int ch = min(t + 4 * q, CF - 1);
          float a = vec[V_VF + CF * 4 + ch];
#pragma unroll
          for (int j = 0; j < 4; ++j) a += vec[V_VF + ch * 4 + j] * dir[j];
          av[32 * ((s * NS + k) * 3 + q)] = (q < 2 || t < 3) ? fq[q] + relu(a) : 0.f;
        }
      }
    }

    // 2. Agg: masked mean / unbiased var (lane-local), global_fc on the
    // tensor cores, online masked softmax pooling, fc
    float mv[6][NS];   // slots 0..2 var, 3..5 mean
#pragma unroll
    for (int k = 0; k < NS; ++k) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        float sm = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) sm += av[32 * ((s * NS + k) * 3 + q)] * m[s];
        const float mean = sm / cnt;
        float vv = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float d = av[32 * ((s * NS + k) * 3 + q)] - mean;
          vv += d * d * m[s];
        }
        mv[q][k] = vv / fmaxf(cnt - 1.f, 1.f);
        mv[3 + q][k] = mean;
      }
    }
    float gsh[4][4];
    init_bias<4>(gsh, vec + V_GF, t);
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
      const AFrag a = split(mv[2 * kt][0], mv[2 * kt][1], mv[2 * kt + 1][0],
                            mv[2 * kt + 1][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma3(gsh[j], a, fl[32 * (F_GFM + kt * 4 + j)]);
    }
    float pool[4][4], pmx[NS], pden[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) { pmx[k] = -INFINITY; pden[k] = 0.f; }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pool[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float gv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[j][e] = gsh[j][e];
      const float* a_s = av + 32 * (s * NS * 3);   // sample k, slot q: 32 (3k + q)
      const AFrag a0 = split(a_s[0], a_s[32 * 3], a_s[32], a_s[32 * 4]);
      const AFrag a1 = split(a_s[32 * 2], a_s[32 * 5], 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma3(gv[j], a0, fl[32 * (F_GFA + j)]);
        mma3(gv[j], a1, fl[32 * (F_GFA + 4 + j)]);
      }
      relu_all<4>(gv);
      float lp[NS] = {0.f, 0.f};
      dot_rows<4>(gv, vec + V_GF + GL, t, lp);
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float qs = quad_sum(lp[k]);   // every lane, then the mask
        const float l = m[s] != 0.f ? relu(qs + vec[V_GF + 2 * GL]) : NEG;
        const float mxn = fmaxf(pmx[k], l);
        const float sc = expf(pmx[k] - mxn), e = expf(l - mxn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pool[j][2 * k] = pool[j][2 * k] * sc + e * gv[j][2 * k];
          pool[j][2 * k + 1] = pool[j][2 * k + 1] * sc + e * gv[j][2 * k + 1];
        }
        pden[k] = pden[k] * sc + e;
        pmx[k] = mxn;
      }
    }
    float agg[2][4];
    init_bias<2>(agg, vec + V_FC, t);
    {
      const float inv[NS] = {1.f / pden[0], 1.f / pden[1]};
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pool[kt][e] *= inv[e >> 1];
        const AFrag a = split_acc(pool[kt]);
#pragma unroll
        for (int j = 0; j < 2; ++j) mma3(agg[j], a, fl[32 * (F_FC + kt * 2 + j)]);
      }
    }
    relu_all<2>(agg);

    // 3. vox feature: channels 2t, 2t + 1 of both samples
    const TV* vol_b = vol + (long long)b * Dv * Hv * Wv * CV;
    float2 vx[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float* q = uvd + (rc * NS + k) * 3;
      vx[k] = sample_volume(vol_b, Dv, Hv, Wv, q[0] * (Wv - 1), q[1] * (Hv - 1),
                            q[2] * (Dv - 1), t);
    }
    const AFrag avox = split(vx[0].x, vx[1].x, vx[0].y, vx[1].y);
    const AFrag aagg0 = split_acc(agg[0]), aagg1 = split_acc(agg[1]);

    // 4. h = relu(lr0([vox, agg])), sigma = softplus(sigma(h)), and
    // color_0's view-independent part [h, vox, agg] once per sample; h is
    // made one 8-column block at a time, each block at once the next K
    // tile of color_0, so h is never whole in the registers
    float base[8][4];
    init_bias<8>(base, vec + V_C0, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mma3(base[j], avox, fl[32 * (F_C0S + 8 * 8 + j)]);
      mma3(base[j], aagg0, fl[32 * (F_C0S + 9 * 8 + j)]);
      mma3(base[j], aagg1, fl[32 * (F_C0S + 10 * 8 + j)]);
    }
    float sp[NS] = {0.f, 0.f};
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      float hh[1][4];
      init_bias<1>(hh, vec + V_L0 + 8 * kt, t);
      mma3(hh[0], avox, fl[32 * (F_L0 + kt)]);
      mma3(hh[0], aagg0, fl[32 * (F_L0 + 8 + kt)]);
      mma3(hh[0], aagg1, fl[32 * (F_L0 + 16 + kt)]);
      relu_all<1>(hh);
      dot_rows<1>(hh, vec + V_L0 + HID + 8 * kt, t, sp);
      const AFrag a = split_acc(hh[0]);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma3(base[j], a, fl[32 * (F_C0S + kt * 8 + j)]);
    }
    float sig[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) sig[k] = softplus(quad_sum(sp[k]) + vec[V_L0 + 2 * HID]);

    // per view: + the 15 per-view inputs, color_2, online masked softmax
    // blend of the source rgb (lane t < 3 holds rgb channel t in slot 2)
    float cmx[NS], cden[NS], crgb[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) { cmx[k] = -INFINITY; cden[k] = 0.f; crgb[k] = 0.f; }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float* f_s = fd + 32 * (s * NS * 4);   // sample k, slot q: 32 (4k + q)
      const AFrag a0 = split(f_s[0], f_s[32 * 4], f_s[32], f_s[32 * 5]);
      const AFrag a1 = split(f_s[32 * 2], f_s[32 * 6], f_s[32 * 3], f_s[32 * 7]);
      float lp[NS] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float tv[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) tv[j][e] = base[4 * half + j][e];
          mma3(tv[j], a0, fl[32 * (F_C0V + 4 * half + j)]);
          mma3(tv[j], a1, fl[32 * (F_C0V + 8 + 4 * half + j)]);
        }
        relu_all<4>(tv);
        dot_rows<4>(tv, vec + V_C0 + HID + 32 * half, t, lp);
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float qs = quad_sum(lp[k]);
        const float l = m[s] != 0.f ? relu(qs + vec[V_C0 + 2 * HID]) : NEG;
        const float mxn = fmaxf(cmx[k], l);
        const float sc = expf(cmx[k] - mxn), e = expf(l - mxn);
        cden[k] = cden[k] * sc + e;
        crgb[k] = crgb[k] * sc + e * f_s[32 * (4 * k + 2)];
        cmx[k] = mxn;
      }
    }

    // alpha compositing
    float T = 1.f, wsum = 0.f, wmax = -INFINITY, out = 0.f;
    float wk[NS], zs[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float alpha = 1.f - expf(-sig[k]);
      wk[k] = alpha * T;
      T *= 1.f - alpha + 1e-10f;
      out += wk[k] * (crgb[k] / cden[k]);
      wsum += wk[k];
      wmax = fmaxf(wmax, wk[k]);
      zs[k] = zvals[rc * NS + k];
    }
    if (valid) {
      if (t < 3) {
        rgb_out[r * 3 + t] = white_bkgd ? out + (1.f - wsum) : out;
      } else {
        float ez = 0.f, es = 0.f;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const float e = expf(wk[k] - wmax);
          es += e;
          ez += e * zs[k];
          w_out[r * NS + k] = wk[k];
        }
        depth_out[r] = ez / es;
      }
    }
  }
}

template <int S, typename TV>
cudaError_t launch(const float* xyz, const float* uvd, const float* zvals,
                   const float* imgs, const void* vol, const float* src_exts,
                   const float* src_ixts, const float* tar_ext, const float* vmask,
                   const float* params, float* rgb, float* depth,
                   float* weights, int B, int N, int H, int W, int Dv,
                   int Hv, int Wv, int white_bkgd, float render_scale,
                   cudaStream_t stream) {
  static int blocks_per_sm = 0;   // per S and TV: set once, then read
  cudaError_t err;
  if (blocks_per_sm == 0) {
    err = cudaFuncSetAttribute(render_kernel<S, TV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<S>());
    if (err != cudaSuccess) return err;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, render_kernel<S, TV>,
                                                        THREADS, smem_bytes<S>());
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorInvalidConfiguration;
    blocks_per_sm = nb;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long n_tiles = ((long long)B * N + RAYS - 1) / RAYS;
  const long long want = (n_tiles + WARPS - 1) / WARPS;
  const long long blocks = want < (long long)sms * blocks_per_sm ? want : (long long)sms * blocks_per_sm;
  render_kernel<S, TV><<<(unsigned)blocks, THREADS, smem_bytes<S>(), stream>>>(
      xyz, uvd, zvals, imgs, static_cast<const TV*>(vol), src_exts, src_ixts, tar_ext, vmask, params,
      rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, render_scale);
  return cudaGetLastError();
}

}  // namespace

// vol: float (vol_bf16 == 0) or __nv_bfloat16 (vol_bf16 == 1); every other
// tensor float.
extern "C" int enerf_render_rays(const float* xyz, const float* uvd,
                                 const float* zvals, const float* imgs,
                                 const void* vol, const float* src_exts,
                                 const float* src_ixts, const float* tar_ext,
                                 const float* vmask, const float* params,
                                 float* rgb, float* depth, float* weights,
                                 int B, int N, int S, int H, int W, int Dv,
                                 int Hv, int Wv, int n_params, int white_bkgd,
                                 int vol_bf16, float render_scale, void* stream) {
  if (n_params != HeadLayout::SIZE) return (int)cudaErrorInvalidValue;
  if ((long long)B * N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ENERF_RENDER_CASE(s, T) \
  return (int)launch<s, T>(xyz, uvd, zvals, imgs, vol, src_exts, src_ixts, tar_ext, vmask, params, rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, render_scale, st);
#define ENERF_RENDER_S(s) \
  case s: if (vol_bf16) { ENERF_RENDER_CASE(s, __nv_bfloat16) } else { ENERF_RENDER_CASE(s, float) }
  switch (S) {
    ENERF_RENDER_S(2) ENERF_RENDER_S(3) ENERF_RENDER_S(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ENERF_RENDER_S
#undef ENERF_RENDER_CASE
}
