// Layered render of the composite model (ENeRF-Outdoor) at its last
// rendered level: every ray's foreground and background samples shaded by
// their own raw heads and alpha-composited, in one kernel.
//
// Replaces, in the port's eval forward: each layer's image table
// (features ‖ rgb, concatenated at full resolution), the projected and
// sampled per-view features (get_img_feat), both NeRFHead calls, the fg
// layer's paste into zeros of the frame, the layers' concatenation and
// the layered compositing (composite_layers). The JAX package runs these
// on XLA (render_rays_packed_xla's raw mode and raw2outputs_composite), not
// in Pallas, so this kernel has no TPU counterpart.
//
// Per ray of the Hr x Wr frame, with one sample a layer:
//   - the bg sample is shaded by the bg head from the bg tables; where the
//     ray lies in the fg window (hr x wr at the clamped origin xy0) the fg
//     sample is shaded by the fg head from the fg tables; outside the
//     window the fg slot is sigma = 0, z = 0, rgb = 0, as the paste leaves
//     it;
//   - shading, per source view s: project the sample (R, t, then K at
//     render scale; z clamped at 1e-6), sample the view's features (8
//     channels, float or bf16) and rgb (3, float) bilinearly with border
//     padding, in grid_sample's arithmetic (the pixel coordinate through
//     the align-corners normalized one and back, the four corner weights),
//     and the ray-difference feature [normalize(tar_dir - src_dir),
//     dot(tar_dir, src_dir)]; Agg: a_s = f_s + relu(view_fc(dir_s)) (the
//     view_fc weights are zero for a head without view-direction
//     aggregation, so a_s = f_s), masked mean and unbiased var over views,
//     g_s = relu(global_fc([a_s, var, mean])), agg = relu(fc(Σ softmax_s(
//     relu(agg_w_fc(g_s))) g_s)); h = relu(lr0(agg)), sigma =
//     softplus(sigma(h)); colour: per view relu(color_2(relu(color_0([h,
//     agg, f_s, dir_s])))) → masked softmax over views → blend of the
//     source rgb;
//   - compositing, fg then bg: alpha = 1 - exp(-sigma), w_fg = alpha_fg,
//     w_bg = alpha_bg (1 - alpha_fg + 1e-10), rgb = w_fg c_fg + w_bg c_bg
//     (+ 1 - Σ w with a white background), depth = w_fg z_fg + w_bg z_bg,
//     weights = [w_fg, w_bg], rounded as the plain version rounds them.
//
// What bounds it on the H100: operations. 13,056 multiply-adds a sample at
// S = 3 without view_fc (per view: global_fc 1,056, agg_w_fc 32, color_0's
// 15 per-view inputs 960, color_2 64; once: fc 512, lr0 1,024, sigma 64,
// color_0's 80 view-independent inputs 5,120), 24 GFLOP for a 768x1024
// frame's 786,432 bg and 131,072 fg samples.
//
// Design: render.cu's (level 1's render kernel), without its volume
// feature and with two heads. The head's products run on the tensor cores
// as mma.sync.m16n8k8 TF32 tiles in three passes (a_lo·b_hi + a_hi·b_lo +
// a_hi·b_hi, f32-accurate), chained in registers from layer to layer.
//   - A warp tile is 16 rays of one frame in raster order: row g of the
//     m16 tile is ray g, row g + 8 ray g + 8, so the quad of lanes
//     4g..4g+3 holds rays g and g + 8 and every view of a ray lies in one
//     lane: the cross-view statistics and both softmaxes are lane-local.
//     An mma's weights are the same for its 16 rows, so a tile is shaded
//     once per layer: the bg head on all 16 rays, then, when any of them
//     lies in the window, the fg head on all 16 (rows outside the window
//     are shaded from a clamped index and masked out).
//   - The grid is persistent, one block of 12 warps an SM (11 at S = 4):
//     both heads' weight fragments, split into hi / lo TF32 in the block's
//     prologue, take 140 KB of shared memory, each warp's per-view scratch
//     the rest. Every warp walks tiles on its own, with no block barrier.
//   - Quad lane t gathers image channels t and t + 4 and rgb channel t (0
//     for lane 3), and direction component t, exactly the values its A
//     fragments take; what it reads again later waits in the warp's
//     shared scratch.
//   - view_fc, agg_w_fc, sigma and color_2, the softmaxes and the
//     compositing stay on the CUDA cores in f32.
// The frame, the window, S and the table's type are read at run time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int FCH = 8;                 // image feature channels
constexpr int CF = FCH + 3;            // features ‖ rgb
constexpr int HID = 64;                // NeRFHead hidden width
constexpr int GL = 32;                 // Agg global feature width
constexpr int AG = 16;                 // aggregated image feature width
constexpr int FD = CF + 4;             // per-view input: feat ‖ rgb ‖ dir ‖ dot
constexpr int C0_IN = HID + AG + FD;   // color_0 input width
constexpr int ROWS = 2;                // rays a lane holds: g and g + 8
constexpr int RAYS = 16;               // rays of a warp tile
constexpr int LAYERS = 2;              // fg, then bg
constexpr float NEG = -1e9f;

// Warps a block: 12, or 11 at S = 4, where 12 warps' scratch would not fit
// beside the two heads' fragments.
template <int S>
__host__ __device__ constexpr int warps_for() { return S == 4 ? 11 : 12; }

// Flat head-weight buffer of one head: each torch Linear's (out, in)
// weight, then its bias (ops/kernels/render.py:head_params builds it
// in this order; a head without view_fc gives zeros there). The kernel
// takes the fg head's buffer, then the bg head's.
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
  static constexpr int L0_B = L0_W + HID * AG;
  static constexpr int SG_W = L0_B + HID;
  static constexpr int SG_B = SG_W + HID;
  static constexpr int C0_W = SG_B + 1;
  static constexpr int C0_B = C0_W + HID * C0_IN;
  static constexpr int C1_W = C0_B + HID;
  static constexpr int C1_B = C1_W + HID;
  static constexpr int SIZE = C1_B + 1;
};

// The tensor-core products, as (K tiles of 8) x (N tiles of 8) fragments:
// fragment (kt, n) of a product is frag0 + kt * nt + n.
enum Product { GFA, GFM, FC, L0, C0S, C0V, N_PRODUCTS };
struct ProductShape { int nt, frag0, w, in; };
__constant__ ProductShape PRODUCTS[N_PRODUCTS] = {
    {4, 0, HeadLayout::GF_W, 3 * CF},      // global_fc, the a_s inputs: K 16
    {4, 8, HeadLayout::GF_W, 3 * CF},      // global_fc, var and mean: K 24
    {2, 20, HeadLayout::FC_W, GL},         // fc: K 32
    {8, 28, HeadLayout::L0_W, AG},         // lr0: K 16
    {8, 44, HeadLayout::C0_W, C0_IN},      // color_0, h ‖ agg: K 80
    {8, 124, HeadLayout::C0_W, C0_IN},     // color_0, the per-view inputs: K 16
};
constexpr int F_GFA = 0, F_GFM = 8, F_FC = 20, F_L0 = 28, F_C0S = 44,
              F_C0V = 124, N_FRAG = 140;

// Shared copies of the vectors the CUDA cores read, at even offsets.
constexpr int V_VF = 0;                 // view_fc weight (44), then bias (11)
constexpr int V_GF = 56;                // global_fc bias (32), agg_w_fc w, b
constexpr int V_FC = 122;               // fc bias (16)
constexpr int V_L0 = 138;               // lr0 bias (64), sigma w (64), b
constexpr int V_C0 = 268;               // color_0 bias (64), color_2 w, b
constexpr int N_VEC = 398;
struct VecCopy { int dst, src, len; };
__constant__ VecCopy VEC_COPIES[5] = {
    {V_VF, HeadLayout::VF_W, CF * 4 + CF},
    {V_GF, HeadLayout::GF_B, GL + GL + 1},
    {V_FC, HeadLayout::FC_B, AG},
    {V_L0, HeadLayout::L0_B, HID + HID + 1},
    {V_C0, HeadLayout::C0_B, HID + HID + 1},
};
// Dynamic shared memory of a block: both heads' fragments and vectors,
// then each warp's scratch of what a lane gathers per view and row and
// reads again later (the 4 per-view input slots, the 3 view_fc outputs).
constexpr int SCRATCH = 7;
template <int S>
constexpr size_t smem_bytes() {
  return LAYERS * N_FRAG * 32 * sizeof(float4) +
         (LAYERS * N_VEC + warps_for<S>() * S * ROWS * SCRATCH * 32) * sizeof(float);
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
      if (q == 3) return HID + AG + CF + t;
      return t + 4 * q < CF ? HID + AG + t + 4 * q : -1;
    default:   // FC, L0, C0S
      return 8 * kt + perm;
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// One head's part of the block's prologue: every weight fragment, split
// into hi / lo TF32. Fragment f, lane L = 4g + t holds {b0.hi, b1.hi,
// b0.lo, b1.lo} with b0 = B[k = t][n = g], b1 = B[k = t + 4][n = g] of its
// K x N tile.
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

// Per row (ray g, ray g + 8) of the quad: Σ_n w[n] d[n] over the lane's
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

// torch.nn.Softplus (beta 1, threshold 20).
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// grid_sample's source index (align_corners, border padding) of a pixel
// coordinate x of a size-n axis: through the normalized coordinate
// x · 2 / (n - 1) - 1 and back, then clipped into [0, n - 1].
__device__ __forceinline__ float grid_index(float x, float norm, int n) {
  const float g = __fsub_rn(__fmul_rn(x, norm), 1.f);
  const float ix = __fmul_rn(__fadd_rn(g, 1.f) * 0.5f, (float)(n - 1));
  return fminf((float)(n - 1), fmaxf(ix, 0.f));
}

// The four corners of a bilinear sample at (ix, iy) inside a (H, W) map:
// pixel offsets (nw, ne, sw, se) and grid_sample's weights; a corner past
// the map's last row or column has weight 0 and reads the nw pixel.
struct Corners { long long off[4]; float w[4]; };

__device__ __forceinline__ Corners corners(float ix, float iy, int H, int W) {
  const int x0 = (int)floorf(ix), y0 = (int)floorf(iy);
  const float xe = (float)(x0 + 1) - ix, xw = ix - (float)x0;
  const float ys = (float)(y0 + 1) - iy, yn = iy - (float)y0;
  const bool in_x = x0 + 1 < W, in_y = y0 + 1 < H;
  const long long nw = (long long)y0 * W + x0;
  Corners c;
  c.off[0] = nw;
  c.off[1] = in_x ? nw + 1 : nw;
  c.off[2] = in_y ? nw + W : nw;
  c.off[3] = in_x && in_y ? nw + W + 1 : nw;
  c.w[0] = xe * ys;
  c.w[1] = in_x ? xw * ys : 0.f;
  c.w[2] = in_y ? xe * yn : 0.f;
  c.w[3] = in_x && in_y ? xw * yn : 0.f;
  return c;
}

// Channel ch of a (H, W, C) map at the corners, summed in grid_sample's
// order.
template <typename T>
__device__ __forceinline__ float bilerp(const T* __restrict__ map, int C, int ch,
                                        const Corners& c) {
  float acc = load(map + c.off[0] * C + ch) * c.w[0];
#pragma unroll
  for (int i = 1; i < 4; ++i) acc = fmaf(load(map + c.off[i] * C + ch), c.w[i], acc);
  return acc;
}

// One layer's tables and samples, each batch item's from its start.
template <typename TF>
struct LayerIn {
  const float* xyz;   // (B, n_rays, 3) sample positions
  const float* z;     // (B, n_rays) z as composited
  const TF* feat;     // (B, S, H, W, 8) image features at render scale
  const float* rgb;   // (B, S, H, W, 3) source rgb at render scale
};

template <int S, typename TF>
__global__ void __launch_bounds__(warps_for<S>() * 32, 1)
layer_render_kernel(const LayerIn<TF> fg, const LayerIn<TF> bg,
                    const long long* __restrict__ xy0,
                    const float* __restrict__ src_exts,
                    const float* __restrict__ src_ixts,
                    const float* __restrict__ tar_ext,
                    const float* __restrict__ vmask,
                    const float* __restrict__ params,
                    float* __restrict__ rgb_out, float* __restrict__ depth_out,
                    float* __restrict__ w_out, int B, int H, int W, int Hr,
                    int Wr, int hr, int wr, int white_bkgd, float render_scale) {
  constexpr int WARPS = warps_for<S>();
  extern __shared__ float4 smem[];
  float4* frag = smem;
  float* vec = reinterpret_cast<float*>(smem + LAYERS * N_FRAG * 32);
#pragma unroll 1
  for (int l = 0; l < LAYERS; ++l)
    build_fragments(params + l * HeadLayout::SIZE, frag + l * N_FRAG * 32,
                    vec + l * N_VEC);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // lane-private scratch of (view s, row k): the per-view input slot q at
  // fd[32 ((s ROWS + k) 4 + q)], the view_fc output slot q at
  // av[32 ((s ROWS + k) 3 + q)]
  float* fd = vec + LAYERS * N_VEC + (threadIdx.x >> 5) * (S * ROWS * SCRATCH * 32) + lane;
  float* av = fd + S * ROWS * 4 * 32;
  const int N = Hr * Wr, Nf = hr * wr;
  const float norm_x = (float)(2.0 / (double)max(W - 1, 1));
  const float norm_y = (float)(2.0 / (double)max(H - 1, 1));
  const long long tiles_b = (N + RAYS - 1) / RAYS;
  const long long n_tiles = tiles_b * B;

#pragma unroll 1
  for (long long tile = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       tile < n_tiles; tile += (long long)gridDim.x * WARPS) {
    const int b = (int)(tile / tiles_b);
    const int p0 = (int)(tile - (long long)b * tiles_b) * RAYS;
    const int x0 = (int)xy0[2 * b], y0 = (int)xy0[2 * b + 1];
    // Rows past the frame's last ray redo that ray and store nothing:
    // every lane takes part in the quad sums. A row outside the window is
    // shaded by the fg head at the window's nearest ray, then masked.
    int pix[ROWS], fpix[ROWS];
    bool valid[ROWS], inw[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const int pr = p0 + g + 8 * k;
      valid[k] = pr < N;
      pix[k] = min(pr, N - 1);
      const int y = pix[k] / Wr, x = pix[k] - (pix[k] / Wr) * Wr;
      const int fx = x - x0, fy = y - y0;
      inw[k] = valid[k] && fx >= 0 && fx < wr && fy >= 0 && fy < hr;
      fpix[k] = min(max(fy, 0), hr - 1) * wr + min(max(fx, 0), wr - 1);
    }
    float m[S];
    float cnt = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      m[s] = vmask[b * S + s] != 0.f ? 1.f : 0.f;
      cnt += m[s];
    }
    cnt = fmaxf(cnt, 1.f);
    float tc[3];
    cam_center(tar_ext + b * 16, tc);

    float sig_f[ROWS] = {0.f, 0.f}, col_f[ROWS] = {0.f, 0.f};
    float sig_b[ROWS] = {0.f, 0.f}, col_b[ROWS] = {0.f, 0.f};
    const bool any_fg = __any_sync(0xffffffffu, inw[0] || inw[1]);
#pragma unroll 1
    for (int l = any_fg ? 0 : 1; l < LAYERS; ++l) {
      const bool is_fg = l == 0;
      const float* xyz = is_fg ? fg.xyz + (long long)b * Nf * 3
                               : bg.xyz + (long long)b * N * 3;
      const long long plane = (long long)H * W;
      const TF* feat = (is_fg ? fg.feat : bg.feat) + (long long)b * S * plane * FCH;
      const float* rgb = (is_fg ? fg.rgb : bg.rgb) + (long long)b * S * plane * 3;
      const float4* fl = frag + l * N_FRAG * 32 + lane;   // fragment f: fl[32 f]
      const float* hv = vec + l * N_VEC;

      // 1. target directions, then per view: samples, directions, view_fc
      float P[ROWS][3], td[ROWS][3];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const float* p = xyz + (long long)(is_fg ? fpix[k] : pix[k]) * 3;
        float tn = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          P[k][i] = __ldg(p + i);
          td[k][i] = P[k][i] - tc[i];
          tn += td[k][i] * td[k][i];
        }
        tn = sqrtf(tn) + 1e-6f;
#pragma unroll
        for (int i = 0; i < 3; ++i) td[k][i] /= tn;
      }
      // fd: slot 0 feature channel t, slot 1 feature channel t + 4, slot 2
      // rgb channel t (0 on lane 3), slot 3 direction component t; av: the
      // slots 0..2 after view_fc
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
        const TF* fv = feat + s * plane * FCH;
        const float* rv = rgb + s * plane * 3;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const float X = P[k][0], Y = P[k][1], Z = P[k][2];
          float cc[3], ii[3];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            cc[i] = fmaf(Z, cam[3 * i + 2], fmaf(Y, cam[3 * i + 1], X * cam[3 * i])) + cam[9 + i];
#pragma unroll
          for (int i = 0; i < 3; ++i)
            ii[i] = fmaf(cc[2], cam[12 + 3 * i + 2],
                         fmaf(cc[1], cam[12 + 3 * i + 1], cc[0] * cam[12 + 3 * i]));
          const float zc = fmaxf(ii[2], 1e-6f);
          const Corners cr = corners(grid_index(__fdiv_rn(ii[0], zc), norm_x, W),
                                     grid_index(__fdiv_rn(ii[1], zc), norm_y, H), H, W);
          float fq[3];
          fq[0] = bilerp(fv, FCH, t, cr);
          fq[1] = bilerp(fv, FCH, t + 4, cr);
          fq[2] = t < 3 ? bilerp(rv, 3, t, cr) : 0.f;
#pragma unroll
          for (int q = 0; q < 3; ++q) fd[32 * ((s * ROWS + k) * 4 + q)] = fq[q];
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
          fd[32 * ((s * ROWS + k) * 4 + 3)] = t == 0 ? dir[0] : t == 1 ? dir[1] : t == 2 ? dir[2] : dir[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            // the channel of slot q: feature t, t + 4, rgb t (lane 3: none)
            const int ch = q < 2 ? t + 4 * q : FCH + min(t, 2);
            float a = hv[V_VF + CF * 4 + ch];
#pragma unroll
            for (int j = 0; j < 4; ++j) a += hv[V_VF + ch * 4 + j] * dir[j];
            av[32 * ((s * ROWS + k) * 3 + q)] = (q < 2 || t < 3) ? fq[q] + relu(a) : 0.f;
          }
        }
      }

      // 2. Agg: masked mean / unbiased var (lane-local), global_fc on the
      // tensor cores, online masked softmax pooling, fc
      float mv[6][ROWS];   // slots 0..2 var, 3..5 mean
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float sm = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) sm += av[32 * ((s * ROWS + k) * 3 + q)] * m[s];
          const float mean = sm / cnt;
          float vv = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float d = av[32 * ((s * ROWS + k) * 3 + q)] - mean;
            vv += d * d * m[s];
          }
          mv[q][k] = vv / fmaxf(cnt - 1.f, 1.f);
          mv[3 + q][k] = mean;
        }
      }
      float gsh[4][4];
      init_bias<4>(gsh, hv + V_GF, t);
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        const AFrag a = split(mv[2 * kt][0], mv[2 * kt][1], mv[2 * kt + 1][0],
                              mv[2 * kt + 1][1]);
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
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float gv[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gv[j][e] = gsh[j][e];
        const float* a_s = av + 32 * (s * ROWS * 3);   // row k, slot q: 32 (3k + q)
        const AFrag a0 = split(a_s[0], a_s[32 * 3], a_s[32], a_s[32 * 4]);
        const AFrag a1 = split(a_s[32 * 2], a_s[32 * 5], 0.f, 0.f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma3(gv[j], a0, fl[32 * (F_GFA + j)]);
          mma3(gv[j], a1, fl[32 * (F_GFA + 4 + j)]);
        }
        relu_all<4>(gv);
        float lp[ROWS] = {0.f, 0.f};
        dot_rows<4>(gv, hv + V_GF + GL, t, lp);
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const float qs = quad_sum(lp[k]);   // every lane, then the mask
          const float lg = m[s] != 0.f ? relu(qs + hv[V_GF + 2 * GL]) : NEG;
          const float mxn = fmaxf(pmx[k], lg);
          const float sc = expf(pmx[k] - mxn), e = expf(lg - mxn);
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
      init_bias<2>(agg, hv + V_FC, t);
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
      const AFrag aagg0 = split_acc(agg[0]), aagg1 = split_acc(agg[1]);

      // 3. h = relu(lr0(agg)), sigma = softplus(sigma(h)), and color_0's
      // view-independent part [h, agg] once per row; h is made one
      // 8-column block at a time, each block at once the next K tile of
      // color_0, so h is never whole in the registers
      float base[8][4];
      init_bias<8>(base, hv + V_C0, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mma3(base[j], aagg0, fl[32 * (F_C0S + 8 * 8 + j)]);
        mma3(base[j], aagg1, fl[32 * (F_C0S + 9 * 8 + j)]);
      }
      float sp[ROWS] = {0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        float hh[1][4];
        init_bias<1>(hh, hv + V_L0 + 8 * kt, t);
        mma3(hh[0], aagg0, fl[32 * (F_L0 + kt)]);
        mma3(hh[0], aagg1, fl[32 * (F_L0 + 8 + kt)]);
        relu_all<1>(hh);
        dot_rows<1>(hh, hv + V_L0 + HID + 8 * kt, t, sp);
        const AFrag a = split_acc(hh[0]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma3(base[j], a, fl[32 * (F_C0S + kt * 8 + j)]);
      }
      float sig[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) sig[k] = softplus(quad_sum(sp[k]) + hv[V_L0 + 2 * HID]);

      // per view: + the 15 per-view inputs, color_2; then the masked
      // softmax over views as torch computes it (exp(l - max) / Σ) and the
      // blend of the source rgb (lane t < 3 holds rgb channel t in slot 2)
      float lgt[S][ROWS];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* f_s = fd + 32 * (s * ROWS * 4);   // row k, slot q: 32 (4k + q)
        const AFrag a0 = split(f_s[0], f_s[32 * 4], f_s[32], f_s[32 * 5]);
        const AFrag a1 = split(f_s[32 * 2], f_s[32 * 6], f_s[32 * 3], f_s[32 * 7]);
        float lp[ROWS] = {0.f, 0.f};
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
          dot_rows<4>(tv, hv + V_C0 + HID + 32 * half, t, lp);
        }
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const float qs = quad_sum(lp[k]);
          lgt[s][k] = m[s] != 0.f ? relu(qs + hv[V_C0 + 2 * HID]) : NEG;
        }
      }
      float col[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        float mx = lgt[0][k];
#pragma unroll
        for (int s = 1; s < S; ++s) mx = fmaxf(mx, lgt[s][k]);
        float den = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) den = __fadd_rn(den, expf(lgt[s][k] - mx));
        float c = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s)
          c = __fadd_rn(c, __fmul_rn(fd[32 * ((s * ROWS + k) * 4 + 2)],
                                     __fdiv_rn(expf(lgt[s][k] - mx), den)));
        col[k] = c;
      }
      if (is_fg) {
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          sig_f[k] = inw[k] ? sig[k] : 0.f;
          col_f[k] = inw[k] ? col[k] : 0.f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          sig_b[k] = sig[k];
          col_b[k] = col[k];
        }
      }
    }

    // compositing, fg then bg, rounded as the plain version rounds
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      if (!valid[k]) continue;
      const long long r = (long long)b * N + pix[k];
      const float wf = __fsub_rn(1.f, expf(-sig_f[k]));
      const float ab = __fsub_rn(1.f, expf(-sig_b[k]));
      const float wb = __fmul_rn(ab, __fadd_rn(__fsub_rn(1.f, wf), 1e-10f));
      if (t < 3) {
        float out = __fadd_rn(__fmul_rn(wf, col_f[k]), __fmul_rn(wb, col_b[k]));
        if (white_bkgd) out = __fadd_rn(out, __fsub_rn(1.f, __fadd_rn(wf, wb)));
        rgb_out[r * 3 + t] = out;
      } else {
        const float zf = inw[k] ? __ldg(fg.z + (long long)b * Nf + fpix[k]) : 0.f;
        const float zb = __ldg(bg.z + r);
        depth_out[r] = __fadd_rn(__fmul_rn(wf, zf), __fmul_rn(wb, zb));
        w_out[2 * r] = wf;
        w_out[2 * r + 1] = wb;
      }
    }
  }
}

template <int S, typename TF>
cudaError_t launch(const LayerIn<TF>& fg, const LayerIn<TF>& bg,
                   const long long* xy0, const float* src_exts,
                   const float* src_ixts, const float* tar_ext,
                   const float* vmask, const float* params, float* rgb,
                   float* depth, float* weights, int B, int H, int W, int Hr,
                   int Wr, int hr, int wr, int white_bkgd, float render_scale,
                   cudaStream_t stream) {
  constexpr int THREADS = warps_for<S>() * 32;
  static int blocks_per_sm = 0;   // per S and TF: set once, then read
  cudaError_t err;
  if (blocks_per_sm == 0) {
    err = cudaFuncSetAttribute(layer_render_kernel<S, TF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes<S>());
    if (err != cudaSuccess) return err;
    int nb = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, layer_render_kernel<S, TF>,
                                                        THREADS, smem_bytes<S>());
    if (err != cudaSuccess) return err;
    if (nb < 1) return cudaErrorInvalidConfiguration;
    blocks_per_sm = nb;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const long long n_tiles = (long long)B * (((long long)Hr * Wr + RAYS - 1) / RAYS);
  const long long want = (n_tiles + warps_for<S>() - 1) / warps_for<S>();
  const long long most = (long long)sms * blocks_per_sm;
  const long long blocks = want < most ? want : most;
  layer_render_kernel<S, TF><<<(unsigned)blocks, THREADS, smem_bytes<S>(), stream>>>(
      fg, bg, xy0, src_exts, src_ixts, tar_ext, vmask, params, rgb, depth, weights,
      B, H, W, Hr, Wr, hr, wr, white_bkgd, render_scale);
  return cudaGetLastError();
}

template <typename TF>
int dispatch(const float* xyz_f, const float* z_f, const void* feat_f,
             const float* rgb_f, const float* xyz_b, const float* z_b,
             const void* feat_b, const float* rgb_b, const long long* xy0,
             const float* src_exts, const float* src_ixts, const float* tar_ext,
             const float* vmask, const float* params, float* rgb, float* depth,
             float* weights, int B, int S, int H, int W, int Hr, int Wr, int hr,
             int wr, int white_bkgd, float render_scale, cudaStream_t st) {
  const LayerIn<TF> fg{xyz_f, z_f, static_cast<const TF*>(feat_f), rgb_f};
  const LayerIn<TF> bg{xyz_b, z_b, static_cast<const TF*>(feat_b), rgb_b};
#define ENERF_LAYER_RENDER_S(s)                                                   \
  case s:                                                                         \
    return (int)launch<s, TF>(fg, bg, xy0, src_exts, src_ixts, tar_ext, vmask,   \
                              params, rgb, depth, weights, B, H, W, Hr, Wr, hr,  \
                              wr, white_bkgd, render_scale, st);
  switch (S) {
    ENERF_LAYER_RENDER_S(2) ENERF_LAYER_RENDER_S(3) ENERF_LAYER_RENDER_S(4)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ENERF_LAYER_RENDER_S
}

}  // namespace

// feat_f, feat_b: float (feat_bf16 == 0) or __nv_bfloat16 (feat_bf16 == 1);
// xy0 (B, 2) int64 [x0, y0], the window's origin clamped into the frame;
// params: the fg head's HeadLayout::SIZE floats, then the bg head's;
// every other tensor float.
extern "C" int enerf_layer_render(const float* xyz_f, const float* z_f,
                                  const void* feat_f, const float* rgb_f,
                                  const float* xyz_b, const float* z_b,
                                  const void* feat_b, const float* rgb_b,
                                  const long long* xy0, const float* src_exts,
                                  const float* src_ixts, const float* tar_ext,
                                  const float* vmask, const float* params,
                                  float* rgb, float* depth, float* weights,
                                  int B, int S, int H, int W, int Hr, int Wr,
                                  int hr, int wr, int n_params, int white_bkgd,
                                  int feat_bf16, float render_scale, void* stream) {
  if (n_params != LAYERS * HeadLayout::SIZE) return (int)cudaErrorInvalidValue;
  if (hr < 1 || wr < 1 || hr > Hr || wr > Wr) return (int)cudaErrorInvalidValue;
  if ((long long)B * Hr * Wr == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return feat_bf16
      ? dispatch<__nv_bfloat16>(xyz_f, z_f, feat_f, rgb_f, xyz_b, z_b, feat_b, rgb_b, xy0,
                                src_exts, src_ixts, tar_ext, vmask, params, rgb, depth,
                                weights, B, S, H, W, Hr, Wr, hr, wr, white_bkgd,
                                render_scale, st)
      : dispatch<float>(xyz_f, z_f, feat_f, rgb_f, xyz_b, z_b, feat_b, rgb_b, xy0,
                        src_exts, src_ixts, tar_ext, vmask, params, rgb, depth,
                        weights, B, S, H, W, Hr, Wr, hr, wr, white_bkgd,
                        render_scale, st);
}
