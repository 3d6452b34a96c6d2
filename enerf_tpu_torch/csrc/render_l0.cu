// Fused render stage of level 0 of the ENeRF cascade: IBR shading +
// compositing at the level-0 head shape.
//
// Replaces: enerf_tpu/ops/pallas/render.py, fused_render_rays (kernels
// _render_kernel -> _render_math, and _render_kernel_v5), at the shape of
// level 0 of configs/enerf/dtu_pretrain.yaml and of every config that
// inherits it: n = 8 samples a ray, Cf = 35 image channels (32 FPN
// channels + rgb), an 8-channel feature volume, S = 2, 3 or 4 source
// views, view-direction aggregation and vox features on. render.cu is the
// level-1 shape (Cf = 11, n = 2); its tile puts a ray's 2 samples in one
// lane, which 8 samples do not fit.
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
//      planes (the tent is the two-plane lerp, 0 outside the volume). The
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
// What bounds it on the H100: operations. 26,020 multiply-adds a sample at
// S = 3 (per view: view_fc 140, global_fc 3,360, agg_w_fc 32, color_0's 39
// per-view inputs 2,496, color_2 64; once: fc 512, lr0 1,536, sigma 64 and
// color_0's 88 view-independent inputs 5,632), so 8.53 GFLOP for the
// 163,840 samples of a 512x640 frame's level 0 (128x160 rays), against
// ~25 MB in and out: 0.052 ms for three TF32 passes at the tensor cores'
// rate, 0.127 ms at the f32 CUDA-core rate.
//
// Design: the head's products on the tensor cores, as render.cu does them.
//   - mma.sync.m16n8k8 TF32 in three passes: every operand x is split as
//     hi = tf32(x), lo = tf32(x - hi), and each product is a_lo·b_hi +
//     a_hi·b_lo + a_hi·b_hi with f32 accumulation (one pass leaves the
//     kernel's tolerance; tests/test_torch_render.py emulates both). These
//     products: global_fc split in two (the a_s part, K 35 padded to 40,
//     per view; the var ‖ mean part, K 72, once per sample, which starts
//     each view's accumulator), fc (K 32), lr0 (K 24), color_0's
//     view-independent part (K 88, once per sample) and its per-view part
//     (K 39 padded to 40). view_fc, agg_w_fc, sigma, color_2 (widths
//     4 → 35 and → 1), the softmaxes and the compositing stay on the CUDA
//     cores in f32. wgmma would take 64-row tiles (8 rays) a warpgroup of
//     4 warps, B from shared memory; mma.sync keeps each warp's 16-row
//     tile in registers from layer to layer on its own. render.cu, built
//     the same way, runs at about a fifth of the tensor cores' TF32 rate,
//     so mma.sync's issue rate is not the first limit.
//   - A warp's tile is 2 rays × 8 samples: row g of the m16 tile is sample
//     g of the tile's first ray, row g + 8 sample g of its second. The four
//     lanes of a quad (lanes 4g..4g+3) hold sample g of both rays, and
//     every view of a sample lies in one lane: the masked mean and var and
//     both softmaxes over views are lane-local, and a dot over channels is
//     a sum over the quad. Compositing walks a ray's 8 samples in z order by
//     shuffles across the 8 quads. Tiles never straddle two frames of the
//     batch (a frame of N rays has ceil(N / 2) tiles), so both rows of a
//     lane share the frame's cameras and view mask; when N is odd the
//     second ray of a frame's last tile redoes its first and stores
//     nothing.
//   - Layers chain in registers: an accumulator fragment (lane t holds
//     columns 2t, 2t+1 of each 8-column block) is the next product's A
//     fragment once the weights' K order within each 8-block is permuted
//     to (0, 2, 4, 6, 1, 3, 5, 7); each block builds its weight fragments,
//     split and permuted, from the flat f32 head buffer in its prologue
//     (216 fragments, 108 KB). h is made one 8-column block at a time,
//     each block at once a K tile of color_0, so h is never whole.
//   - Quad lane t gathers image channels t + 4q (q < 9) and the direction
//     of its samples, and volume channels 2t, 2t+1: exactly the values its
//     A fragments take. Channel 35 (lane 3, q = 8) and the K padding read
//     zero weights. What the lane gathers per view (9 channels and the 4
//     direction components a row) waits in the warp's shared scratch; the
//     var ‖ mean product (one K tile a channel slot), the a_s product and
//     the color MLP read it from there, and make a_s again where they need
//     it (view_fc is 4 multiply-adds a channel). That keeps the scratch at
//     13 floats a row and view, 13 KB a warp at S = 4, and keeps the
//     registers to what one view's product holds: the loops over views
//     and over the var ‖ mean K tiles are not unrolled (the view mask is
//     then read as bits), which is what keeps ptxas from spilling.
//   - The grid is persistent: one block of 8 warps per SM (fragments and
//     scratch take 214 KB of shared memory at S = 4, and a lane may use up
//     to 255 registers), and each warp walks tiles on its own, with no
//     block barrier after the prologue. The next tile's inputs are not
//     prefetched (cp.async): a tile's gathers are a few kB against some
//     thousand tensor-core instructions, and the SM's other warps overlap
//     them.

#include <cuda_bf16.h>
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
constexpr int FQ = 9;                   // image-channel slots of a lane: t + 4q
constexpr int ROWS = 2;                 // rays of one warp tile (16 samples)
constexpr int SLOT = FQ + 4;            // scratch floats of a (view, row)
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

// The tensor-core products, as (K tiles of 8) x (N tiles of 8) fragments:
// fragment (kt, n) of a product is frag0 + kt * nt + n. The K order of each
// product is what the lanes hold (see in_index).
enum Product { GFA, GFM, FC, L0, C0S, C0V, N_PRODUCTS };
struct ProductShape { int nt, frag0, w, in; };
__constant__ ProductShape PRODUCTS[N_PRODUCTS] = {
    {4, 0, Src::GF_W, 3 * CF},      // global_fc, the a_s inputs: K 40
    {4, 20, Src::GF_W, 3 * CF},     // global_fc, var and mean: K 72
    {2, 56, Src::FC_W, GL},         // fc: K 32
    {8, 64, Src::L0_W, VIF},        // lr0: K 24
    {8, 88, Src::C0_W, C0_IN},      // color_0, h ‖ vox ‖ agg: K 88
    {8, 176, Src::C0_W, C0_IN},     // color_0, the per-view inputs: K 40
};
constexpr int F_GFA = 0, F_GFM = 20, F_FC = 56, F_L0 = 64, F_C0S = 88,
              F_C0V = 176, N_FRAG = 216;

// Shared copies of the vectors the CUDA cores read, at even offsets.
constexpr int V_VF = 0;                 // view_fc weight (140), then bias (35)
constexpr int V_GF = 176;               // global_fc bias (32), agg_w_fc w, b
constexpr int V_FC = 242;               // fc bias (16)
constexpr int V_L0 = 258;               // lr0 bias (64), sigma w (64), b
constexpr int V_C0 = 388;               // color_0 bias (64), color_2 w, b
constexpr int N_VEC = 520;
struct VecCopy { int dst, src, len; };
__constant__ VecCopy VEC_COPIES[5] = {
    {V_VF, Src::VF_W, CF * 4 + CF},
    {V_GF, Src::GF_B, GL + GL + 1},
    {V_FC, Src::FC_B, AG},
    {V_L0, Src::L0_B, HID + HID + 1},
    {V_C0, Src::C0_B, HID + HID + 1},
};
// Dynamic shared memory of a block: the fragments, the vectors, and each
// warp's scratch: per (view, row) a lane's 9 image-channel slots and the
// 4 direction components, slot i of lane L at 32 i + L (conflict-free).
template <int S>
constexpr size_t smem_bytes() {
  return N_FRAG * 32 * sizeof(float4) + (N_VEC + WARPS * S * ROWS * SLOT * 32) * sizeof(float);
}
static_assert(smem_bytes<4>() <= 232448, "a block's shared memory at S = 4");

// Column c (0..7) of K tile kt of product p: the index of its input in the
// torch weight row, or -1 for zero padding.
//   - inputs a lane gathers itself sit in "slots": slot q of quad lane t is
//     K tile q / 2, column t + 4 (q % 2) (global_fc's var ‖ mean part: K
//     tile kt holds the var of channel t + 4kt at column t, its mean at
//     t + 4);
//   - inputs that come from an accumulator fragment sit at 8 kt + perm(c),
//     perm = (0, 2, 4, 6, 1, 3, 5, 7).
__device__ int in_index(int p, int kt, int c) {
  const int t = c & 3, q = 2 * kt + (c >> 2);
  const int perm = c < 4 ? 2 * c : 2 * (c - 4) + 1;
  switch (p) {
    case GFA:  // slots 0..8: a channel t + 4q
      return t + 4 * q < CF ? t + 4 * q : -1;
    case GFM: {  // K tile kt: var of channel t + 4kt, then its mean
      const int ch = t + 4 * kt;
      return ch < CF ? (c < 4 ? CF : 2 * CF) + ch : -1;
    }
    case C0V:  // slots 0..8: feat ‖ rgb channel t + 4q, slot 9: dir t
      if (q == FQ) return C0_SHARED + CF + t;
      return t + 4 * q < CF ? C0_SHARED + t + 4 * q : -1;
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

// Per row (first ray, second ray) of the quad: Σ_n w[n] d[n] over the
// lane's columns; quad_sum completes it.
template <int NT>
__device__ __forceinline__ void dot_rows(const float (&d)[NT][4],
                                         const float* w, int t, float (&out)[ROWS]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 ww = *reinterpret_cast<const float2*>(w + 8 * j + 2 * t);
    out[0] += ww.x * d[j][0] + ww.y * d[j][1];
    out[1] += ww.x * d[j][2] + ww.y * d[j][3];
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  x += __shfl_xor_sync(FULL, x, 2);
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

// view_fc's weight row and bias for channel slot q of quad lane t, channel
// t + 4q; slot 8 of lane 3 lies past the last channel (real false).
struct ViewFc { float4 w; float b; bool real; };
__device__ __forceinline__ ViewFc view_fc_slot(const float* vec, int t, int q) {
  const int ch = min(t + 4 * q, CF - 1);
  return {*reinterpret_cast<const float4*>(vec + V_VF + 4 * ch),
          vec[V_VF + CF * 4 + ch], t + 4 * q < CF};
}

// a_s of channel slot q of a (view, row) from its scratch: the gathered
// value + relu(view_fc of the direction), 0 past the last channel.
__device__ __forceinline__ float agg_input(const float* slot, int q, const ViewFc& v) {
  const float r = v.b + v.w.x * slot[32 * FQ] + v.w.y * slot[32 * (FQ + 1)] +
                  v.w.z * slot[32 * (FQ + 2)] + v.w.w * slot[32 * (FQ + 3)];
  return v.real ? slot[32 * q] + relu(r) : 0.f;
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
render_l0_kernel(const float* __restrict__ xyz, const float* __restrict__ uvd,
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
  // lane-private scratch: slot i of (view s, row k) at sc[32 ((s ROWS + k)
  // SLOT + i)]
  float* sc = vec + N_VEC + (threadIdx.x >> 5) * (S * ROWS * SLOT * 32) + lane;
  const float4* fl = frag + lane;   // fragment f of this lane: fl[32 f]
  const int tiles_per_frame = (N + 1) / 2;
  const long long n_tiles = (long long)B * tiles_per_frame;

#pragma unroll 1
  for (long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       tile < n_tiles; tile += (long long)gridDim.x * WARPS) {
    const int b = (int)(tile / tiles_per_frame);
    const int n0 = 2 * (int)(tile - (long long)b * tiles_per_frame);
    // row k's ray; a second ray past the frame's end redoes the first and
    // stores nothing (every lane takes part in the shuffles)
    long long ray[ROWS];
    bool valid[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      valid[k] = n0 + k < N;
      ray[k] = (long long)b * N + min(n0 + k, N - 1);
    }

    // the view mask, as floats (views unrolled) and as bits (view loops
    // that are not unrolled, so that nothing is indexed by a loop variable)
    float m[S];
    unsigned mbits = 0;
    float cnt = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      m[s] = vmask[b * S + s] != 0.f ? 1.f : 0.f;
      mbits |= (m[s] != 0.f ? 1u : 0u) << s;
      cnt += m[s];
    }
    const float den_mean = fmaxf(cnt, 1.f), den_var = fmaxf(cnt - 1.f, 1.f);

    // 1. sample g of both rays: target directions, then per view the image
    // channels and the direction into the scratch
    float P[ROWS][3], td[ROWS][3];
    {
      float tc[3];
      cam_center(tar_ext + b * 16, tc);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const float* p = xyz + (ray[k] * NS + g) * 3;
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
    }
#pragma unroll 1
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
      for (int k = 0; k < ROWS; ++k) {
        float* slot = sc + 32 * ((s * ROWS + k) * SLOT);
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
#pragma unroll
        for (int q = 0; q < FQ; ++q) {
          // lane 3's slot 8 would be channel 35: it reads channel 34, is 0
          const int ch = min(t + 4 * q, CF - 1);
          const float top = (1.f - tx) * __ldg(r00 + ch) + tx * __ldg(r01 + ch);
          const float bot = (1.f - tx) * __ldg(r10 + ch) + tx * __ldg(r11 + ch);
          slot[32 * q] = q < FQ - 1 || t < 3 ? (1.f - ty) * top + ty * bot : 0.f;
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
        slot[32 * FQ] = rx / rn;
        slot[32 * (FQ + 1)] = ry / rn;
        slot[32 * (FQ + 2)] = rz / rn;
        slot[32 * (FQ + 3)] = td[k][0] * sd[0] + td[k][1] * sd[1] + td[k][2] * sd[2];
      }
    }

    // 2. Agg: global_fc's var ‖ mean part once per sample (K tile kt holds
    // the var of channel t + 4kt in its columns 0..3, the mean in 4..7),
    // then per view its a_s part, relu, the online masked softmax pooling;
    // fc
    float gsh[4][4];
    init_bias<4>(gsh, vec + V_GF, t);
#pragma unroll 1
    for (int kt = 0; kt < FQ; ++kt) {
      const ViewFc vf = view_fc_slot(vec, t, kt);
      float mv[2][ROWS];   // var, mean
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        float a[S], sum = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          a[s] = agg_input(sc + 32 * ((s * ROWS + k) * SLOT), kt, vf);
          sum += a[s] * m[s];
        }
        const float mean = sum / den_mean;
        float ss = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float d = a[s] - mean;
          ss += d * d * m[s];
        }
        mv[0][k] = ss / den_var;
        mv[1][k] = mean;
      }
      const AFrag a = split(mv[0][0], mv[0][1], mv[1][0], mv[1][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma3(gsh[j], a, fl[32 * (F_GFM + kt * 4 + j)]);
    }
    float pool[4][4], pmx[ROWS], pden[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) { pmx[k] = -INFINITY; pden[k] = 0.f; }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pool[j][e] = 0.f;
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const float* s0 = sc + 32 * (s * ROWS * SLOT);   // row 1 at + 32 SLOT
      float gv[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gv[j][e] = gsh[j][e];
#pragma unroll
      for (int kt = 0; kt < (FQ + 1) / 2; ++kt) {
        // slots 2kt, 2kt + 1 of both rows; slot 9 is K padding
        float x[2][ROWS];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = 2 * kt + h;
          if (q < FQ) {
            const ViewFc vf = view_fc_slot(vec, t, q);
#pragma unroll
            for (int k = 0; k < ROWS; ++k) x[h][k] = agg_input(s0 + 32 * (k * SLOT), q, vf);
          } else {
            x[h][0] = x[h][1] = 0.f;
          }
        }
        const AFrag a = split(x[0][0], x[0][1], x[1][0], x[1][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma3(gv[j], a, fl[32 * (F_GFA + kt * 4 + j)]);
      }
      relu_all<4>(gv);
      float lp[ROWS] = {0.f, 0.f};
      dot_rows<4>(gv, vec + V_GF + GL, t, lp);
      const bool on = (mbits >> s) & 1u;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const float qs = quad_sum(lp[k]);   // every lane, then the mask
        const float l = on ? relu(qs + vec[V_GF + 2 * GL]) : NEG;
        const float mxn = fmaxf(pmx[k], l);
        const float scl = expf(pmx[k] - mxn), e = expf(l - mxn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pool[j][2 * k] = pool[j][2 * k] * scl + e * gv[j][2 * k];
          pool[j][2 * k + 1] = pool[j][2 * k + 1] * scl + e * gv[j][2 * k + 1];
        }
        pden[k] = pden[k] * scl + e;
        pmx[k] = mxn;
      }
    }
    float agg[2][4];
    init_bias<2>(agg, vec + V_FC, t);
    {
      const float inv[ROWS] = {1.f / pden[0], 1.f / pden[1]};
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

    // 3. vox feature: channels 2t, 2t + 1 of sample g of both rays
    const TV* vol_b = vol + (long long)b * Dv * Hv * Wv * CV;
    float2 vx[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const float* q = uvd + (ray[k] * NS + g) * 3;
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
    float sp[ROWS] = {0.f, 0.f};
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
    float sig[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) sig[k] = softplus(quad_sum(sp[k]) + vec[V_L0 + 2 * HID]);

    // per view: + the 39 per-view inputs (slot 9 is direction component
    // t), color_2, online masked softmax blend of the source rgb (lane
    // t < 3 holds rgb channel t in slot 8)
    float cmx[ROWS], cden[ROWS], crgb[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) { cmx[k] = -INFINITY; cden[k] = 0.f; crgb[k] = 0.f; }
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      const float* f0 = sc + 32 * (s * ROWS * SLOT);   // row 1 at + 32 SLOT
      const float* f1 = f0 + 32 * SLOT;
      float tv[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) tv[j][e] = base[j][e];
#pragma unroll
      for (int kt = 0; kt < (FQ + 1) / 2; ++kt) {
        const int q1 = 2 * kt + 1 < FQ ? 2 * kt + 1 : FQ + t;
        const AFrag a = split(f0[32 * 2 * kt], f1[32 * 2 * kt], f0[32 * q1], f1[32 * q1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma3(tv[j], a, fl[32 * (F_C0V + kt * 8 + j)]);
      }
      relu_all<8>(tv);
      float lp[ROWS] = {0.f, 0.f};
      dot_rows<8>(tv, vec + V_C0 + HID, t, lp);
      const float rgb_s[ROWS] = {f0[32 * (FQ - 1)], f1[32 * (FQ - 1)]};
      const bool on = (mbits >> s) & 1u;
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const float qs = quad_sum(lp[k]);
        const float l = on ? relu(qs + vec[V_C0 + 2 * HID]) : NEG;
        const float mxn = fmaxf(cmx[k], l);
        const float scl = expf(cmx[k] - mxn), e = expf(l - mxn);
        cden[k] = cden[k] * scl + e;
        crgb[k] = crgb[k] * scl + e * rgb_s[k];
        cmx[k] = mxn;
      }
    }

    // 5. alpha compositing of each ray over its 8 samples, in z order:
    // sample j of row k is in quad j (sigma in all its lanes, rgb channel t
    // in lane 4j + t); quad k writes ray k's rgb (lanes t < 3) and depth
    // (lane 3), lane 4j + 3 the weight of sample j
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const float col = crgb[k] / cden[k];
      const float z = zvals[ray[k] * NS + g];
      float T = 1.f, wsum = 0.f, wmax = -INFINITY, out = 0.f, mine = 0.f;
      float wk[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float alpha = 1.f - expf(-__shfl_sync(FULL, sig[k], 4 * j));
        wk[j] = alpha * T;
        T *= 1.f - alpha + 1e-10f;
        out += wk[j] * __shfl_sync(FULL, col, 4 * j + t);
        wsum += wk[j];
        wmax = fmaxf(wmax, wk[j]);
        if (j == g) mine = wk[j];
      }
      float ez = 0.f, es = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float e = expf(wk[j] - wmax);
        es += e;
        ez += e * __shfl_sync(FULL, z, 4 * j);
      }
      if (valid[k]) {
        if (t == 3) w_out[ray[k] * NS + g] = mine;
        if (g == k) {
          if (t < 3) rgb_out[ray[k] * 3 + t] = white_bkgd ? out + (1.f - wsum) : out;
          else depth_out[ray[k]] = ez / es;
        }
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
    // the dynamic shared-memory size first: the occupancy query reads it
    err = cudaFuncSetAttribute(render_l0_kernel<S, TV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<S>());
    if (err != cudaSuccess) return err;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, render_l0_kernel<S, TV>,
                                                        THREADS, smem_bytes<S>());
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorInvalidConfiguration;
    blocks_per_sm = nb;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long n_tiles = (long long)B * ((N + 1) / 2);
  const long long want = (n_tiles + WARPS - 1) / WARPS;
  const long long cap = (long long)sms * blocks_per_sm;
  const long long blocks = want < cap ? want : cap;
  render_l0_kernel<S, TV><<<(unsigned)blocks, THREADS, smem_bytes<S>(), stream>>>(
      xyz, uvd, zvals, imgs, static_cast<const TV*>(vol), src_exts, src_ixts, tar_ext, vmask, params,
      rgb, depth, weights, B, N, H, W, Dv, Hv, Wv, white_bkgd, render_scale);
  return cudaGetLastError();
}

}  // namespace

// vol: float (vol_bf16 == 0) or __nv_bfloat16 (vol_bf16 == 1); every other
// tensor float.
extern "C" int enerf_render_rays_l0(const float* xyz, const float* uvd,
                                    const float* zvals, const float* imgs,
                                    const void* vol, const float* src_exts,
                                    const float* src_ixts, const float* tar_ext,
                                    const float* vmask, const float* params,
                                    float* rgb, float* depth, float* weights,
                                    int B, int N, int S, int H, int W, int Dv,
                                    int Hv, int Wv, int n_params, int white_bkgd,
                                    int vol_bf16, float render_scale, void* stream) {
  if (n_params != Src::SIZE) return (int)cudaErrorInvalidValue;
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

// The kernel's dynamic shared memory at S views, in bytes (0 for an S it
// is not built for).
extern "C" int enerf_render_rays_l0_smem_bytes(int S) {
  switch (S) {
    case 2: return (int)smem_bytes<2>();
    case 3: return (int)smem_bytes<3>();
    case 4: return (int)smem_bytes<4>();
    default: return 0;
  }
}
