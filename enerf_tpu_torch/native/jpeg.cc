// Baseline JPEG codec of enerf_tpu_torch's loaders, built into the same
// host library as host_ops.cc (enerf_tpu_torch/native/__init__.py).
//
// Decoder: sequential Huffman JPEG (SOF0 / SOF1) with 8-bit samples, one
// component (gray) or three (YCbCr) in one interleaved scan, sampling
// 4:4:4, 4:2:2 or 4:2:0, restart intervals, any width and height. Its
// output equals libjpeg-turbo's with its default decompression settings
// (what Pillow, and imageio through it, return):
//   - the "islow" integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
//     the post-IDCT range-limit table indexed by the low 10 bits);
//   - "fancy" triangle upsampling (jdsample.c): h2v1 with biases +1 / +2,
//     h2v2 with +8 / +7 by output column parity; the edge column and the
//     rows above the first and below the last real row replicated; a
//     component at most 2 samples wide is box-upsampled instead;
//   - fixed-point YCbCr -> RGB (jdcolor.c, SCALEBITS 16).
// Everything else fails with a message instead of giving a wrong image:
// progressive, lossless, hierarchical or arithmetic-coded files, 12-bit
// samples, 2 or 4 components (CMYK), an Adobe APP14 marker (a colour
// transform), RGB component ids, other sampling factors, several scans,
// an EXIF orientation other than 1, and truncated or corrupt data.
//
// Encoder: baseline, 4:2:0 for RGB (one component for gray), the IJG
// quality-scaled Annex K quantization tables and the standard Huffman
// tables of Annex K.3, a JFIF APP0 header.
//
// Build: with host_ops.cc, g++ -O3 -shared -fPIC host_ops.cc jpeg.cc

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Fail {
  char msg[256];
};

#define JFAIL(...)                                        \
  do {                                                    \
    Fail f_;                                              \
    std::snprintf(f_.msg, sizeof(f_.msg), __VA_ARGS__);   \
    throw f_;                                             \
  } while (0)

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | value; 0: longer code
};

void build_huff(HuffTable& h) {
  // canonical codes (JPEG Annex C), checked as libjpeg's
  // jpeg_make_d_derived_tbl checks them
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < h.bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) JFAIL("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (h.bits[l]) {
      h.valoffset[l] = p - huffcode[p];
      p += h.bits[l];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0x7fffffff;
  std::memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 0; i < h.bits[l]; i++, p++) {
      int look = huffcode[p] << (kLookBits - l);
      for (int c = 1 << (kLookBits - l); c > 0; c--)
        h.look[look++] = static_cast<uint16_t>((l << 8) | h.vals[p]);
    }
  }
}

struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;
  int cnt = 0;        // bits in buf (the low cnt bits)
  int fake = 0;       // zero bits supplied past a marker or the file's end
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t b = 0;
      if (at_marker) {
        fake += 8;
      } else if (pos >= n) {
        at_marker = true;
        fake += 8;
      } else if (d[pos] != 0xFF) {
        b = d[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;    // fill bytes
        if (q < n && d[q] == 0x00) {          // a stuffed 0xFF data byte
          b = 0xFF;
          pos = q + 1;
        } else {                              // a marker: stop before it
          at_marker = true;
          fake += 8;
        }
      }
      buf = (buf << 8) | b;
      cnt += 8;
    }
  }
  inline int peek(int k) {
    if (cnt < k) fill();
    return static_cast<int>((buf >> (cnt - k)) & ((1u << k) - 1));
  }
  inline void skip(int k) { cnt -= k; }
  inline int get(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    cnt -= k;
    return v;
  }
  // bits taken from the zeros supplied past the end of the segment
  int overread() const { return fake > cnt ? fake - cnt : 0; }
  // the real bits still unread before the marker
  int real_left() const { return cnt - (fake < cnt ? fake : cnt); }
  void reset() {
    buf = 0;
    cnt = 0;
    fake = 0;
    at_marker = false;
  }
};

inline int decode_symbol(BitReader& br, const HuffTable& h) {
  int look = br.peek(kLookBits);
  int e = h.look[look];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  int code = br.get(kLookBits);
  int l = kLookBits;
  while (code > h.maxcode[l]) {
    code = (code << 1) | br.get(1);
    if (++l > 16) JFAIL("corrupt entropy data (bad Huffman code)");
  }
  return h.vals[(code + h.valoffset[l]) & 0xFF];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;        // Huffman table ids from the scan
  int bw = 0, bh = 0;        // blocks a row / rows of blocks in the plane
  int dw = 0, dh = 0;        // downsampled width and height (real samples)
  std::vector<uint8_t> plane;
  int stride = 0;
  int pred = 0;
};

struct Frame {
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  Component comp[3];
  uint16_t quant[4][64];     // natural order
  bool quant_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false, saw_sof = false;
};

inline int32_t descale(int64_t x, int n) {
  return static_cast<int32_t>((x + (int64_t(1) << (n - 1))) >> n);
}

// libjpeg's jpeg_idct_islow, dequantization included; out: 8 rows of
// `stride` bytes. The range limit is libjpeg's post-IDCT table: the low
// 10 bits of the descaled value select clamp(v + 128) for v in
// [-512, 511] and wrap beyond.
inline uint8_t idct_limit(int32_t v) {
  int i = v & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                    F0899 = 7373, F1175 = 9633, F1501 = 12299,
                    F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (in[0] * qt[0]) * (1 << P1);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * qt[16], z3 = in[48] * qt[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = in[0] * qt[0];
    z3 = in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * qt[56];
    tmp1 = in[40] * qt[40];
    tmp2 = in[24] * qt[24];
    tmp3 = in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = descale(tmp10 + tmp3, CB - P1);
    w[56] = descale(tmp10 - tmp3, CB - P1);
    w[8] = descale(tmp11 + tmp2, CB - P1);
    w[48] = descale(tmp11 - tmp2, CB - P1);
    w[16] = descale(tmp12 + tmp1, CB - P1);
    w[40] = descale(tmp12 - tmp1, CB - P1);
    w[24] = descale(tmp13 + tmp0, CB - P1);
    w[32] = descale(tmp13 - tmp0, CB - P1);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t dc = idct_limit(descale(w[0], P1 + 3));
      for (int i = 0; i < 8; i++) o[i] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CB);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CB + P1 + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, S));
    o[7] = idct_limit(descale(tmp10 - tmp3, S));
    o[1] = idct_limit(descale(tmp11 + tmp2, S));
    o[6] = idct_limit(descale(tmp11 - tmp2, S));
    o[2] = idct_limit(descale(tmp12 + tmp1, S));
    o[5] = idct_limit(descale(tmp12 - tmp1, S));
    o[3] = idct_limit(descale(tmp13 + tmp0, S));
    o[4] = idct_limit(descale(tmp13 - tmp0, S));
  }
}

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// EXIF orientation of an APP1 payload, 1 when absent or unreadable
int exif_orientation(const uint8_t* p, size_t len) {
  if (len < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return 1;
  const uint8_t* t = p + 6;
  size_t tl = len - 6;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return 1;
  auto rd16 = [&](size_t o) -> uint32_t {
    return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
  };
  auto rd32 = [&](size_t o) -> uint32_t {
    return le ? t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                    (uint32_t(t[o + 3]) << 24)
              : (uint32_t(t[o]) << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) |
                    t[o + 3];
  };
  size_t ifd = rd32(4);
  if (ifd + 2 > tl) return 1;
  size_t count = rd16(ifd);
  for (size_t i = 0; i < count; i++) {
    size_t e = ifd + 2 + 12 * i;
    if (e + 12 > tl) return 1;
    if (rd16(e) == 0x0112) return static_cast<int>(rd16(e + 8));
  }
  return 1;
}

const char* sof_name(int m) {
  switch (m) {
    case 0xC2: case 0xC6: case 0xCA: case 0xCE: return "progressive";
    case 0xC3: case 0xC7: case 0xCB: case 0xCF: return "lossless";
    case 0xC5: return "hierarchical";
    case 0xC9: return "arithmetic-coded";
    default: return "unsupported";
  }
}

// Parse markers up to and including SOS; returns the offset of the scan's
// entropy-coded data.
size_t parse_headers(const uint8_t* d, size_t n, Frame& f) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) JFAIL("not a JPEG file (no SOI)");
  size_t pos = 2;
  while (true) {
    if (pos >= n) JFAIL("truncated file (no scan)");
    if (d[pos] != 0xFF) JFAIL("corrupt file (expected a marker at byte %zu)", pos);
    while (pos < n && d[pos] == 0xFF) pos++;
    if (pos >= n) JFAIL("truncated file (no scan)");
    int m = d[pos++];
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) JFAIL("no scan before EOI");
    if (pos + 2 > n) JFAIL("truncated file (marker 0x%02X)", m);
    int len = u16(d + pos);
    if (len < 2 || pos + len > n) JFAIL("truncated file (marker 0x%02X)", m);
    const uint8_t* p = d + pos + 2;
    size_t plen = len - 2;
    pos += len;
    if (m == 0xE0) {
      if (plen >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) f.saw_jfif = true;
    } else if (m == 0xE1) {
      int o = exif_orientation(p, plen);
      if (o != 1)
        JFAIL("EXIF orientation %d: the decoder does not rotate images", o);
    } else if (m == 0xEE) {
      if (plen >= 5 && std::memcmp(p, "Adobe", 5) == 0) f.saw_adobe = true;
    } else if (m == 0xDB) {
      size_t i = 0;
      while (i < plen) {
        int pq = p[i] >> 4, tq = p[i] & 15;
        if (tq > 3 || pq > 1) JFAIL("bad DQT segment");
        size_t need = 1 + 64 * (pq + 1);
        if (i + need > plen) JFAIL("bad DQT segment");
        for (int k = 0; k < 64; k++)
          f.quant[tq][kNatural[k]] = static_cast<uint16_t>(
              pq ? u16(p + i + 1 + 2 * k) : p[i + 1 + k]);
        f.quant_defined[tq] = true;
        i += need;
      }
    } else if (m == 0xC4) {
      size_t i = 0;
      while (i < plen) {
        if (i + 17 > plen) JFAIL("bad DHT segment");
        int tc = p[i] >> 4, th = p[i] & 15;
        if (tc > 1 || th > 3) JFAIL("bad DHT segment");
        HuffTable& h = tc ? f.ac[th] : f.dc[th];
        int count = 0;
        h.bits[0] = 0;
        for (int l = 1; l <= 16; l++) {
          h.bits[l] = p[i + l];
          count += h.bits[l];
        }
        if (count > 256 || i + 17 + count > plen) JFAIL("bad DHT segment");
        std::memcpy(h.vals, p + i + 17, count);
        build_huff(h);
        h.defined = true;
        i += 17 + count;
      }
    } else if (m == 0xDD) {
      if (plen < 2) JFAIL("bad DRI segment");
      f.restart_interval = u16(p);
    } else if (m == 0xC0 || m == 0xC1) {
      if (f.saw_sof) JFAIL("two frame headers");
      if (plen < 6) JFAIL("bad SOF segment");
      if (p[0] != 8) JFAIL("%d-bit samples: only 8-bit JPEG is decoded", p[0]);
      f.height = u16(p + 1);
      f.width = u16(p + 3);
      f.ncomp = p[5];
      if (f.height == 0) JFAIL("height 0 (DNL marker) is not supported");
      if (f.width == 0) JFAIL("width 0");
      if (f.ncomp != 1 && f.ncomp != 3)
        JFAIL("%d components: only gray (1) and YCbCr (3) are decoded%s",
              f.ncomp, f.ncomp == 4 ? " (CMYK / YCCK is not)" : "");
      if (plen < 6 + 3 * size_t(f.ncomp)) JFAIL("bad SOF segment");
      for (int c = 0; c < f.ncomp; c++) {
        Component& cp = f.comp[c];
        cp.id = p[6 + 3 * c];
        cp.h = p[7 + 3 * c] >> 4;
        cp.v = p[7 + 3 * c] & 15;
        cp.tq = p[8 + 3 * c];
        if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3)
          JFAIL("bad SOF segment");
        if (cp.h > f.hmax) f.hmax = cp.h;
        if (cp.v > f.vmax) f.vmax = cp.v;
      }
      f.saw_sof = true;
    } else if ((m >= 0xC2 && m <= 0xCF) && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      JFAIL("%s JPEG (SOF marker 0x%02X) is not supported: only baseline "
            "sequential Huffman", sof_name(m), m);
    } else if (m == 0xCC) {
      JFAIL("arithmetic-coded JPEG (DAC marker) is not supported");
    } else if (m == 0xDA) {
      if (!f.saw_sof) JFAIL("scan before the frame header");
      int ns = plen ? p[0] : 0;
      if (plen < 1 + 2 * size_t(ns) + 3) JFAIL("bad SOS segment");
      if (ns != f.ncomp)
        JFAIL("a scan of %d of %d components: only one interleaved scan of "
              "all components is decoded", ns, f.ncomp);
      for (int s = 0; s < ns; s++) {
        int cid = p[1 + 2 * s];
        if (cid != f.comp[s].id)
          JFAIL("scan component order differs from the frame's");
        f.comp[s].td = p[2 + 2 * s] >> 4;
        f.comp[s].ta = p[2 + 2 * s] & 15;
        if (f.comp[s].td > 3 || f.comp[s].ta > 3) JFAIL("bad SOS segment");
      }
      const uint8_t* t = p + 1 + 2 * ns;
      if (t[0] != 0 || t[1] != 63 || t[2] != 0)
        JFAIL("spectral selection %d..%d / approximation %d in a sequential "
              "scan", t[0], t[1], t[2]);
      return pos;
    }
    // other APPn, COM and anything unknown: skipped
  }
}

void check_layout(const Frame& f) {
  if (f.saw_adobe)
    JFAIL("Adobe APP14 marker (colour transform) is not supported");
  if (f.ncomp == 3) {
    if (!f.saw_jfif && f.comp[0].id == 'R' && f.comp[1].id == 'G' &&
        f.comp[2].id == 'B')
      JFAIL("RGB-coded JPEG (component ids R, G, B) is not supported");
    for (int c = 0; c < 3; c++) {
      const Component& cp = f.comp[c];
      int eh = f.hmax / cp.h, ev = f.vmax / cp.v;
      bool exact = eh * cp.h == f.hmax && ev * cp.v == f.vmax;
      if (!exact || !((eh == 1 && ev == 1) || (eh == 2 && ev == 1) ||
                      (eh == 2 && ev == 2)))
        JFAIL("sampling factors %dx%d of component %d (max %dx%d): only "
              "4:4:4, 4:2:2 and 4:2:0 are decoded", cp.h, cp.v, c, f.hmax,
              f.vmax);
    }
  }
  for (int c = 0; c < f.ncomp; c++) {
    const Component& cp = f.comp[c];
    if (!f.quant_defined[cp.tq]) JFAIL("missing quantization table %d", cp.tq);
    if (!f.dc[cp.td].defined || !f.ac[cp.ta].defined)
      JFAIL("missing Huffman table");
  }
}

void decode_block(BitReader& br, const Frame& f, Component& cp,
                  int16_t* coef) {
  std::memset(coef, 0, 64 * sizeof(int16_t));
  int s = decode_symbol(br, f.dc[cp.td]);
  if (s > 11) JFAIL("corrupt entropy data (DC size %d)", s);
  int diff = s ? extend(br.get(s), s) : 0;
  cp.pred += diff;
  coef[0] = static_cast<int16_t>(cp.pred);
  const HuffTable& ac = f.ac[cp.ta];
  for (int k = 1; k < 64; k++) {
    int rs = decode_symbol(br, ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63) JFAIL("corrupt entropy data (AC index past 63)");
      coef[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

// The scan's entropy-coded data into the component planes; returns the
// offset just past it (at the next marker).
size_t decode_scan(const uint8_t* d, size_t n, size_t pos, Frame& f) {
  int ncomp = f.ncomp;
  int mcux, mcuy;
  if (ncomp == 1) {           // non-interleaved: one block an MCU
    Component& cp = f.comp[0];
    cp.dw = f.width;
    cp.dh = f.height;
    mcux = (cp.dw + 7) / 8;
    mcuy = (cp.dh + 7) / 8;
    cp.bw = mcux;
    cp.bh = mcuy;
  } else {
    mcux = (f.width + 8 * f.hmax - 1) / (8 * f.hmax);
    mcuy = (f.height + 8 * f.vmax - 1) / (8 * f.vmax);
    for (int c = 0; c < ncomp; c++) {
      Component& cp = f.comp[c];
      cp.dw = (f.width * cp.h + f.hmax - 1) / f.hmax;
      cp.dh = (f.height * cp.v + f.vmax - 1) / f.vmax;
      cp.bw = mcux * cp.h;
      cp.bh = mcuy * cp.v;
    }
  }
  for (int c = 0; c < ncomp; c++) {
    Component& cp = f.comp[c];
    cp.stride = cp.bw * 8;
    cp.plane.assign(size_t(cp.stride) * cp.bh * 8, 0);
    cp.pred = 0;
  }
  BitReader br{d, n, pos};
  int16_t coef[64];
  int total = mcux * mcuy;
  int next_rst = 0;
  int in_interval = 0;
  for (int m = 0; m < total; m++) {
    if (f.restart_interval && in_interval == f.restart_interval) {
      if (br.overread()) JFAIL("truncated or corrupt entropy data");
      if (br.real_left() >= 8) JFAIL("corrupt entropy data before a restart");
      size_t q = br.pos;
      while (q < n && d[q] == 0xFF) q++;
      if (q >= n || d[q] != 0xD0 + next_rst)
        JFAIL("missing restart marker RST%d", next_rst);
      br.pos = q + 1;
      br.reset();
      for (int c = 0; c < ncomp; c++) f.comp[c].pred = 0;
      next_rst = (next_rst + 1) & 7;
      in_interval = 0;
    }
    int my = m / mcux, mx = m % mcux;
    for (int c = 0; c < ncomp; c++) {
      Component& cp = f.comp[c];
      int bh = ncomp == 1 ? 1 : cp.v, bw = ncomp == 1 ? 1 : cp.h;
      for (int by = 0; by < bh; by++) {
        for (int bx = 0; bx < bw; bx++) {
          decode_block(br, f, cp, coef);
          int row = (my * bh + by) * 8, col = (mx * bw + bx) * 8;
          idct_islow(coef, f.quant[cp.tq],
                     cp.plane.data() + size_t(row) * cp.stride + col,
                     cp.stride);
        }
      }
    }
    in_interval++;
  }
  if (br.overread()) JFAIL("truncated or corrupt entropy data");
  return br.pos;
}

// One component upsampled to the full width x height (libjpeg-turbo's
// jdsample.c with do_fancy_upsampling).
void upsample(const Frame& f, const Component& cp, uint8_t* out) {
  int W = f.width, H = f.height;
  int eh = f.hmax / cp.h, ev = f.vmax / cp.v;
  const uint8_t* pl = cp.plane.data();
  int st = cp.stride, dw = cp.dw;
  std::vector<int> rowbuf(2 * dw + 2);
  std::vector<int> cs(dw);
  for (int y = 0; y < H; y++) {
    uint8_t* o = out + size_t(y) * W;
    if (eh == 1 && ev == 1) {
      std::memcpy(o, pl + size_t(y) * st, W);
      continue;
    }
    if (eh == 2 && ev == 1) {
      const uint8_t* in = pl + size_t(y) * st;
      if (dw <= 2) {
        for (int x = 0; x < W; x++) o[x] = in[x >> 1];
        continue;
      }
      int* r = rowbuf.data();
      r[0] = in[0];
      r[1] = (in[0] * 3 + in[1] + 2) >> 2;
      for (int k = 1; k < dw - 1; k++) {
        int v = in[k] * 3;
        r[2 * k] = (v + in[k - 1] + 1) >> 2;
        r[2 * k + 1] = (v + in[k + 1] + 2) >> 2;
      }
      r[2 * dw - 2] = (in[dw - 1] * 3 + in[dw - 2] + 1) >> 2;
      r[2 * dw - 1] = in[dw - 1];
      for (int x = 0; x < W; x++) o[x] = static_cast<uint8_t>(r[x]);
      continue;
    }
    // h2v2
    int ry = y >> 1;
    if (dw <= 2) {
      const uint8_t* in = pl + size_t(ry) * st;
      for (int x = 0; x < W; x++) o[x] = in[x >> 1];
      continue;
    }
    int ny = (y & 1) ? (ry + 1 < cp.dh ? ry + 1 : cp.dh - 1)
                     : (ry > 0 ? ry - 1 : 0);
    const uint8_t* in0 = pl + size_t(ry) * st;
    const uint8_t* in1 = pl + size_t(ny) * st;
    for (int k = 0; k < dw; k++) cs[k] = in0[k] * 3 + in1[k];
    int* r = rowbuf.data();
    r[0] = (cs[0] * 4 + 8) >> 4;
    r[1] = (cs[0] * 3 + cs[1] + 7) >> 4;
    for (int k = 1; k < dw - 1; k++) {
      r[2 * k] = (cs[k] * 3 + cs[k - 1] + 8) >> 4;
      r[2 * k + 1] = (cs[k] * 3 + cs[k + 1] + 7) >> 4;
    }
    r[2 * dw - 2] = (cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4;
    r[2 * dw - 1] = (cs[dw - 1] * 4 + 7) >> 4;
    for (int x = 0; x < W; x++) o[x] = static_cast<uint8_t>(r[x]);
  }
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void ycc_to_rgb(const uint8_t* y, const uint8_t* cb, const uint8_t* cr,
                size_t npix, uint8_t* out) {
  constexpr int SB = 16;
  constexpr int64_t HALF = int64_t(1) << (SB - 1);
  auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + HALF;
  }
  for (size_t i = 0; i < npix; i++) {
    int Y = y[i], b = cb[i], r = cr[i];
    out[3 * i] = clamp255(Y + cr_r[r]);
    out[3 * i + 1] = clamp255(Y + static_cast<int>((cb_g[b] + cr_g[r]) >> SB));
    out[3 * i + 2] = clamp255(Y + cb_b[b]);
  }
}

void decode(const uint8_t* d, size_t n, Frame& f, uint8_t* out) {
  size_t pos = parse_headers(d, n, f);
  check_layout(f);
  pos = decode_scan(d, n, pos, f);
  // after the scan: EOI (a second scan or a DNL marker is not decoded)
  while (true) {
    if (pos >= n) JFAIL("truncated file (no EOI)");
    if (d[pos] != 0xFF) JFAIL("corrupt data after the scan");
    while (pos < n && d[pos] == 0xFF) pos++;
    if (pos >= n) JFAIL("truncated file (no EOI)");
    int m = d[pos++];
    if (m == 0xD9) break;
    if (m == 0xDA) JFAIL("several scans: only single-scan JPEG is decoded");
    if (m == 0xDC) JFAIL("DNL marker is not supported");
    if (m >= 0xD0 && m <= 0xD7) continue;
    if (pos + 2 > n) JFAIL("truncated file");
    pos += u16(d + pos);
  }
  size_t npix = size_t(f.width) * f.height;
  if (f.ncomp == 1) {
    const Component& cp = f.comp[0];
    for (int y = 0; y < f.height; y++)
      std::memcpy(out + size_t(y) * f.width,
                  cp.plane.data() + size_t(y) * cp.stride, f.width);
    return;
  }
  std::vector<uint8_t> planes(3 * npix);
  for (int c = 0; c < 3; c++) upsample(f, f.comp[c], planes.data() + c * npix);
  ycc_to_rgb(planes.data(), planes.data() + npix, planes.data() + 2 * npix,
             npix, out);
}

void copy_msg(const char* msg, char* err, size_t errlen) {
  if (err && errlen) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

// ---------------------------------------------------------------------------
// Encoder
// ---------------------------------------------------------------------------

// Annex K quantization tables, zigzag order (IJG quality 50)
const int kStdLuma[64] = {
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
    26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
    56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
    95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99};
const int kStdChroma[64] = {
    17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 Huffman tables: bits[1..16], then the values
const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
};

void build_enc(const uint8_t* bits, const uint8_t* vals, EncTable& t) {
  std::memset(t.size, 0, sizeof(t.size));
  int code = 0, p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      t.code[vals[p]] = static_cast<uint16_t>(code++);
      t.size[vals[p]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0;
  void byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
  void word(int w) {
    byte(w >> 8);
    byte(w & 0xFF);
  }
  void bits(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      int b = (acc >> (nbits - 8)) & 0xFF;
      byte(b);
      if (b == 0xFF) byte(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) bits(0x7F, 8 - nbits);   // pad with 1 bits
    acc = 0;
  }
};

int bit_size(int v) {
  v = v < 0 ? -v : v;
  int s = 0;
  while (v) {
    s++;
    v >>= 1;
  }
  return s;
}

// cos((2x + 1) u pi / 16) C(u), C(0) = 1 / sqrt(2), else 1
struct CosTable {
  double v[8][8];
  CosTable() {
    for (int x = 0; x < 8; x++)
      for (int u = 0; u < 8; u++)
        v[x][u] = std::cos((2 * x + 1) * u * M_PI / 16.0) *
                  (u == 0 ? std::sqrt(0.5) : 1.0);
  }
};
const CosTable kCos;

void encode_block(Writer& w, const double* px, const int* qnat, int& pred,
                  const EncTable& dc, const EncTable& ac) {
  // forward DCT-II in double: F(u, v) = C(u) C(v) / 4 sum f cos cos
  const auto& cosv = kCos.v;
  double tmp[64];
  for (int y = 0; y < 8; y++)
    for (int u = 0; u < 8; u++) {
      double s = 0;
      for (int x = 0; x < 8; x++) s += px[y * 8 + x] * cosv[x][u];
      tmp[y * 8 + u] = s;
    }
  int q[64];
  for (int v = 0; v < 8; v++)
    for (int u = 0; u < 8; u++) {
      double s = 0;
      for (int y = 0; y < 8; y++) s += tmp[y * 8 + u] * cosv[y][v];
      s *= 0.25;
      q[v * 8 + u] = static_cast<int>(std::lround(s / qnat[v * 8 + u]));
    }
  int diff = q[0] - pred;
  pred = q[0];
  int s = bit_size(diff);
  w.bits(dc.code[s], dc.size[s]);
  if (s) w.bits(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = q[kNatural[k]];
    if (!v) {
      run++;
      continue;
    }
    while (run > 15) {
      w.bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    s = bit_size(v);
    if (s > 10) s = 10, v = v < 0 ? -1023 : 1023;
    int sym = (run << 4) | s;
    w.bits(ac.code[sym], ac.size[sym]);
    w.bits(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) w.bits(ac.code[0x00], ac.size[0x00]);
}

void scaled_table(const int* base, int quality, int* zz) {
  if (quality < 1) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (static_cast<long>(base[i]) * scale + 50) / 100;
    zz[i] = static_cast<int>(t < 1 ? 1 : (t > 255 ? 255 : t));
  }
}

void write_dht(Writer& w, int tc_th, const uint8_t* bits, const uint8_t* vals,
               int nvals) {
  w.word(0xFFC4);
  w.word(2 + 17 + nvals);
  w.byte(tc_th);
  for (int l = 1; l <= 16; l++) w.byte(bits[l]);
  for (int i = 0; i < nvals; i++) w.byte(vals[i]);
}

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int C,
                            int quality) {
  bool color = C == 3;
  int zq[2][64], nq[2][64];
  scaled_table(kStdLuma, quality, zq[0]);
  scaled_table(kStdChroma, quality, zq[1]);
  for (int t = 0; t < 2; t++)
    for (int k = 0; k < 64; k++) nq[t][kNatural[k]] = zq[t][k];
  EncTable dcl, acl, dcc, acc;
  build_enc(kDcLumaBits, kDcVals, dcl);
  build_enc(kAcLumaBits, kAcLumaVals, acl);
  build_enc(kDcChromaBits, kDcVals, dcc);
  build_enc(kAcChromaBits, kAcChromaVals, acc);

  // planes: Y at full size; Cb, Cr 2x2-averaged (libjpeg's h2v2_downsample,
  // biases 1 / 2 alternating), edges replicated to whole MCUs
  int hm = color ? 2 : 1;
  int mcux = (W + 8 * hm - 1) / (8 * hm), mcuy = (H + 8 * hm - 1) / (8 * hm);
  int PW = mcux * 8 * hm, PH = mcuy * 8 * hm;
  std::vector<uint8_t> Y(size_t(PW) * PH), Cb, Cr;
  auto src = [&](int y, int x, int c) {
    y = y < H ? y : H - 1;
    x = x < W ? x : W - 1;
    return static_cast<int>(img[(size_t(y) * W + x) * C + c]);
  };
  if (color) {
    std::vector<uint8_t> fcb(size_t(PW) * PH), fcr(size_t(PW) * PH);
    for (int y = 0; y < PH; y++)
      for (int x = 0; x < PW; x++) {
        int r = src(y, x, 0), g = src(y, x, 1), b = src(y, x, 2);
        size_t i = size_t(y) * PW + x;
        Y[i] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
        fcb[i] = static_cast<uint8_t>(
            (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16);
        fcr[i] = static_cast<uint8_t>(
            (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16);
      }
    int cw = PW / 2, ch = PH / 2;
    Cb.resize(size_t(cw) * ch);
    Cr.resize(size_t(cw) * ch);
    for (int y = 0; y < ch; y++)
      for (int x = 0; x < cw; x++) {
        size_t a = size_t(2 * y) * PW + 2 * x, b = a + PW;
        int bias = (x & 1) ? 2 : 1;
        Cb[size_t(y) * cw + x] = static_cast<uint8_t>(
            (fcb[a] + fcb[a + 1] + fcb[b] + fcb[b + 1] + bias) >> 2);
        Cr[size_t(y) * cw + x] = static_cast<uint8_t>(
            (fcr[a] + fcr[a + 1] + fcr[b] + fcr[b + 1] + bias) >> 2);
      }
  } else {
    for (int y = 0; y < PH; y++)
      for (int x = 0; x < PW; x++) Y[size_t(y) * PW + x] = src(y, x, 0);
  }

  Writer w;
  w.out.reserve(size_t(H) * W * C / 4 + 1024);
  w.word(0xFFD8);
  // JFIF APP0: version 1.01, no density units, 1:1
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  w.word(0xFFE0);
  w.word(2 + sizeof(jfif));
  for (uint8_t b : jfif) w.byte(b);
  for (int t = 0; t < (color ? 2 : 1); t++) {
    w.word(0xFFDB);
    w.word(2 + 65);
    w.byte(t);
    for (int k = 0; k < 64; k++) w.byte(zq[t][k]);
  }
  w.word(0xFFC0);
  w.word(8 + 3 * C);
  w.byte(8);
  w.word(H);
  w.word(W);
  w.byte(C);
  for (int c = 0; c < C; c++) {
    w.byte(c + 1);
    w.byte(c == 0 ? (hm << 4) | hm : 0x11);
    w.byte(c == 0 ? 0 : 1);
  }
  write_dht(w, 0x00, kDcLumaBits, kDcVals, 12);
  write_dht(w, 0x10, kAcLumaBits, kAcLumaVals, 162);
  if (color) {
    write_dht(w, 0x01, kDcChromaBits, kDcVals, 12);
    write_dht(w, 0x11, kAcChromaBits, kAcChromaVals, 162);
  }
  w.word(0xFFDA);
  w.word(6 + 2 * C);
  w.byte(C);
  for (int c = 0; c < C; c++) {
    w.byte(c + 1);
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);

  int pred[3] = {0, 0, 0};
  double px[64];
  auto block = [&](const std::vector<uint8_t>& pl, int stride, int by, int bx,
                   int t, int& p) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++)
        px[y * 8 + x] = pl[size_t(by * 8 + y) * stride + bx * 8 + x] - 128.0;
    encode_block(w, px, nq[t], p, t ? dcc : dcl, t ? acc : acl);
  };
  for (int my = 0; my < mcuy; my++)
    for (int mx = 0; mx < mcux; mx++) {
      for (int by = 0; by < hm; by++)
        for (int bx = 0; bx < hm; bx++)
          block(Y, PW, my * hm + by, mx * hm + bx, 0, pred[0]);
      if (color) {
        block(Cb, PW / 2, my, mx, 1, pred[1]);
        block(Cr, PW / 2, my, mx, 1, pred[2]);
      }
    }
  w.flush();
  w.word(0xFFD9);
  return w.out;
}

}  // namespace

extern "C" {

// The size of a JPEG image: 0 and (*h, *w, *c) on success, else 1 and a
// message in err. Checks the headers, not the scan.
int jpeg_header(const uint8_t* data, size_t n, int* h, int* w, int* c,
                char* err, size_t errlen) {
  try {
    Frame f;
    parse_headers(data, n, f);
    check_layout(f);
    *h = f.height;
    *w = f.width;
    *c = f.ncomp;
    return 0;
  } catch (const Fail& e) {
    copy_msg(e.msg, err, errlen);
    return 1;
  } catch (...) {
    copy_msg("out of memory", err, errlen);
    return 1;
  }
}

// Decode into out (h * w * c bytes, as jpeg_header gave them): 0 on
// success, else 1 and a message in err.
int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, size_t out_size,
                char* err, size_t errlen) {
  try {
    Frame f;
    // parse once to size-check before writing into out
    Frame g;
    parse_headers(data, n, g);
    if (size_t(g.width) * g.height * g.ncomp != out_size)
      JFAIL("output buffer of %zu bytes for a %dx%dx%d image", out_size,
            g.height, g.width, g.ncomp);
    decode(data, n, f, out);
    return 0;
  } catch (const Fail& e) {
    copy_msg(e.msg, err, errlen);
    return 1;
  } catch (...) {
    copy_msg("out of memory", err, errlen);
    return 1;
  }
}

// Encode an h x w x c u8 image (c = 1 or 3): the number of bytes written
// to out, or the size needed (and nothing written) when cap is too small;
// 0 on a bad argument.
size_t jpeg_encode(const uint8_t* img, int h, int w, int c, int quality,
                   uint8_t* out, size_t cap) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535 || (c != 1 && c != 3))
    return 0;
  try {
    std::vector<uint8_t> data = encode(img, h, w, c, quality);
    if (data.size() <= cap) std::memcpy(out, data.data(), data.size());
    return data.size();
  } catch (...) {
    return 0;
  }
}

}  // extern "C"
