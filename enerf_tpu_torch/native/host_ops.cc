// Host-side data-pipeline kernels (C++) of enerf_tpu_torch's loaders: the
// port's copy of enerf_tpu/native/host_ops.cc, plus the PNG row unfilter
// that enerf_tpu_torch/utils/image_io.py decodes with.
//
// Every kernel is one fused pass with no temporaries, where the numpy
// expressions it replaces ((img / 255. * 2 - 1).astype(f32)) walk the
// image three or four times through float64 temporaries. Exposed to
// Python via ctypes (enerf_tpu_torch/native/__init__.py), with a numpy
// fallback when no compiler is available.
//
// Build: g++ -O3 -shared -fPIC host_ops.cc -o libhost_ops.so

#include <cstdint>
#include <cstddef>
#include <cmath>

extern "C" {

// u8 image -> float32 in [0, 1]; one pass (imageio u8 -> model input).
void u8_to_unit_f32(const uint8_t* src, float* dst, size_t n) {
  constexpr float k = 1.0f / 255.0f;
  for (size_t i = 0; i < n; ++i) dst[i] = src[i] * k;
}

// u8 image -> float32 in [-1, 1]; fused (x/255)*2-1 (the reference's
// src-image preprocessing, lib/datasets/dtu/enerf.py "img*2-1").
void u8_to_pm1_f32(const uint8_t* src, float* dst, size_t n) {
  constexpr float k = 2.0f / 255.0f;
  for (size_t i = 0; i < n; ++i) dst[i] = src[i] * k - 1.0f;
}

// u8 HxWxC image + u8 HxW mask -> float32 in [-1, 1] with the mask == 0
// pixels at -1 (the zeroed u8 pixel, normalized), one pass (ZJU-MoCap's
// img[mask == 0] = 0 then normalize; reference
// lib/datasets/zjumocap/enerf.py:152).
void u8_to_pm1_masked_f32(const uint8_t* src, const uint8_t* mask,
                          float* dst, size_t h, size_t w, size_t c) {
  constexpr float k = 2.0f / 255.0f;
  for (size_t p = 0; p < h * w; ++p) {
    const uint8_t m = mask[p];
    for (size_t ch = 0; ch < c; ++ch) {
      const size_t i = p * c + ch;
      dst[i] = m ? (src[i] * k - 1.0f) : -1.0f;
    }
  }
}

// float32 [0, 1] image -> u8 with clamp, one pass (the video frames and
// the saved result images). Truncating, not rounding: the reference's
// (img * 255).astype(uint8) after a clip, as enerf_tpu/native computes it.
void f32_unit_to_u8(const float* src, uint8_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i];
    v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    dst[i] = static_cast<uint8_t>(v * 255.0f);
  }
}

// u8 HxWx4 RGBA -> f32 HxWx3 alpha-composited onto white in [0,1]
// (NeRF-synthetic images; reference lib/datasets/nerf/enerf.py:127
// img[...,:3]*img[...,-1:] + (1-img[...,-1:])), one fused pass.
void u8_rgba_over_white_f32(const uint8_t* src, float* dst, size_t npix) {
  constexpr float k = 1.0f / 255.0f;
  for (size_t p = 0; p < npix; ++p) {
    const uint8_t* s = src + p * 4;
    float* d = dst + p * 3;
    const float a = s[3] * k;
    const float bg = 1.0f - a;
    d[0] = s[0] * k * a + bg;
    d[1] = s[1] * k * a + bg;
    d[2] = s[2] * k * a + bg;
  }
}

// Fused y = x*scale + offset over f32 (e.g. [0,255] float image ->
// [-1,1]: scale=2/255, offset=-1), one pass, no temporaries.
void f32_scale_offset(const float* src, float* dst, size_t n,
                      float scale, float offset) {
  for (size_t i = 0; i < n; ++i) dst[i] = src[i] * scale + offset;
}

// Copy one f32 sample into row `row` of a preallocated batch buffer
// (collation without np.stack's temporary list walk).
void collate_f32(const float* sample, float* batch, size_t row, size_t n) {
  float* out = batch + row * n;
  for (size_t i = 0; i < n; ++i) out[i] = sample[i];
}

// PFM payload (already frombuffer'd f32, bottom-up scanlines) -> top-down
// with optional 0.5x nearest downsample fused in (the DTU depth path:
// read_pfm + cv2.resize INTER_NEAREST fx=fy=0.5; reference
// lib/datasets/dtu/enerf.py:90-92). scale must be 1 or 2.
void pfm_flip_downsample_f32(const float* src, float* dst,
                             size_t h, size_t w, size_t scale) {
  const size_t oh = h / scale, ow = w / scale;
  for (size_t y = 0; y < oh; ++y) {
    // source row y*scale counted from the BOTTOM (pfm is bottom-up)
    const float* srow = src + (h - 1 - y * scale) * w;
    float* drow = dst + y * ow;
    for (size_t x = 0; x < ow; ++x) drow[x] = srow[x * scale];
  }
}

// PNG scanline reconstruction (PNG spec, section 9: filter method 0).
// `raw` holds h rows of 1 filter-type byte + `stride` filtered bytes (the
// inflated IDAT stream); `dst` receives the h x stride reconstructed
// bytes. `bpp` is the bytes per complete pixel (1..4 at 8 bits a sample).
// Returns 0, or the 1-based row whose filter type is not 0..4.
int png_unfilter(const uint8_t* raw, uint8_t* dst, size_t h, size_t stride,
                 size_t bpp) {
  for (size_t y = 0; y < h; ++y) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t type = in[0];
    ++in;
    uint8_t* out = dst + y * stride;
    const uint8_t* up = y ? out - stride : nullptr;
    switch (type) {
      case 0:
        for (size_t i = 0; i < stride; ++i) out[i] = in[i];
        break;
      case 1:
        for (size_t i = 0; i < stride; ++i)
          out[i] = in[i] + (i >= bpp ? out[i - bpp] : 0);
        break;
      case 2:
        for (size_t i = 0; i < stride; ++i) out[i] = in[i] + (up ? up[i] : 0);
        break;
      case 3:
        for (size_t i = 0; i < stride; ++i) {
          const unsigned a = i >= bpp ? out[i - bpp] : 0;
          const unsigned b = up ? up[i] : 0;
          out[i] = in[i] + static_cast<uint8_t>((a + b) >> 1);
        }
        break;
      case 4:
        for (size_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = in[i] + static_cast<uint8_t>(pred);
        }
        break;
      default:
        return static_cast<int>(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
