// The port's image codec on the host: baseline JPEG decode and encode
// and Pillow's BILINEAR resample, the same arithmetic as the plain
// version in mxnet_tpu_torch/_imgcodec.py (which holds the comments on
// where each step comes from: libjpeg-turbo's jidctint.c, jdsample.c,
// jdcolor.c, jfdctint.c, jcsample.c, jccolor.c, jcparam.c, jchuff.c,
// jccoefct.c, and Pillow's Resample.c).
//
// Host code, no CUDA: the JAX package decodes on the host too. Built by
// ops/_build.py with the host C++ compiler and called through ctypes,
// which releases the GIL for the length of a call.
//
// Entry points (0 on success; otherwise imgcodec_error() says why):
//   imgcodec_decode(buf, n, out, cap, dims)  dims = {h, w, c}; out NULL
//                                            reads the header only
//   imgcodec_encode(img, h, w, c, quality, hs, vs, restart, out, cap,
//                   &len)                    1: cap too small, len needed
//   imgcodec_resize(in, h, w, c, out, oh, ow)
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct CodecError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError{msg}; }

[[noreturn]] void unsupported(const std::string& what) {
  fail("JPEG: " + what +
       " streams are not supported (baseline Huffman 8-bit, 1 or 3 "
       "components only)");
}

int natural_order[80];  // filled by tables(): call it before any use

struct Tables {
  int32_t cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t y_r[256], y_g[256], y_b[256], cb_r[256], cb_g2[256], half_b[256],
      cr_g2[256], cr_b[256];
  uint8_t idct_limit[1024];
  Tables() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      int cells[8][2];
      int n = 0;
      for (int i = 0; i < 8; ++i) {
        int j = s - i;
        if (j >= 0 && j < 8) {
          cells[n][0] = i;
          cells[n][1] = j;
          ++n;
        }
      }
      for (int t = 0; t < n; ++t) {
        int u = (s % 2 == 0) ? n - 1 - t : t;
        natural_order[k++] = cells[u][0] * 8 + cells[u][1];
      }
    }
    for (; k < 80; ++k) natural_order[k] = 63;
    auto fix = [](double x) { return (int64_t)(x * 65536 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int32_t)((fix(1.40200) * x + 32768) >> 16);
      cb_b[i] = (int32_t)((fix(1.77200) * x + 32768) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + 32768;
      y_r[i] = fix(0.299) * i;
      y_g[i] = fix(0.587) * i;
      y_b[i] = fix(0.114) * i + 32768;
      cb_r[i] = -fix(0.16874) * i;
      cb_g2[i] = -fix(0.33126) * i;
      half_b[i] = fix(0.5) * i + (128 << 16) + 32768 - 1;
      cr_g2[i] = -fix(0.41869) * i;
      cr_b[i] = -fix(0.08131) * i;
    }
    // prepare_range_limit_table, from the IDCT's origin
    uint8_t t[5 * 256 + 128];
    std::memset(t, 0, sizeof t);
    const int base = 256, post = base + 128;
    for (int i = 0; i < 256; ++i) t[base + i] = (uint8_t)i;
    for (int i = 128; i < 512; ++i) t[post + i] = 255;
    for (int i = 0; i < 128; ++i) t[post + 1024 - 128 + i] = t[base + i];
    std::memcpy(idct_limit, t + post, 1024);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

inline uint8_t clamp255(int64_t v) {
  return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------------------
// ISLOW IDCT / FDCT
// ---------------------------------------------------------------------------

template <typename Get, typename Put>
inline void idct_pass(Get z, Put out, int n) {
  int64_t z1 = (z(2) + z(6)) * 4433;
  int64_t tmp2 = z1 + z(6) * -15137;
  int64_t tmp3 = z1 + z(2) * 6270;
  int64_t tmp0 = (z(0) + z(4)) * 8192;
  int64_t tmp1 = (z(0) - z(4)) * 8192;
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = z(7), t1 = z(5), t2 = z(3), t3 = z(1);
  int64_t a1 = t0 + t3, a2 = t1 + t2, a3 = t0 + t2, a4 = t1 + t3;
  int64_t z5 = (a3 + a4) * 9633;
  t0 *= 2446;
  t1 *= 16819;
  t2 *= 25172;
  t3 *= 12299;
  a1 *= -7373;
  a2 *= -20995;
  a3 = a3 * -16069 + z5;
  a4 = a4 * -3196 + z5;
  t0 += a1 + a3;
  t1 += a2 + a4;
  t2 += a2 + a3;
  t3 += a1 + a4;
  const int64_t r = (int64_t)1 << (n - 1);
  out(0, (tmp10 + t3 + r) >> n);
  out(7, (tmp10 - t3 + r) >> n);
  out(1, (tmp11 + t2 + r) >> n);
  out(6, (tmp11 - t2 + r) >> n);
  out(2, (tmp12 + t1 + r) >> n);
  out(5, (tmp12 - t1 + r) >> n);
  out(3, (tmp13 + t0 + r) >> n);
  out(4, (tmp13 - t0 + r) >> n);
}

// 64 quantized coefficients (row-major) times the table -> 8x8 samples
void idct_block(const int16_t* coef, const int32_t* q, uint8_t* out,
                int stride, const uint8_t* limit) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    idct_pass([&](int k) { return (int64_t)coef[k * 8 + c] * q[k * 8 + c]; },
              [&](int k, int64_t v) { ws[k * 8 + c] = v; }, 11);
  }
  for (int r = 0; r < 8; ++r) {
    uint8_t* o = out + (size_t)r * stride;
    idct_pass([&](int k) { return ws[r * 8 + k]; },
              [&](int k, int64_t v) { o[k] = limit[v & 1023]; }, 18);
  }
}

template <typename Get, typename Put>
inline void fdct_pass(Get d, Put out, bool first) {
  int64_t tmp0 = d(0) + d(7), tmp7 = d(0) - d(7);
  int64_t tmp1 = d(1) + d(6), tmp6 = d(1) - d(6);
  int64_t tmp2 = d(2) + d(5), tmp5 = d(2) - d(5);
  int64_t tmp3 = d(3) + d(4), tmp4 = d(3) - d(4);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const int n = first ? 11 : 15;
  const int64_t r = (int64_t)1 << (n - 1);
  if (first) {
    out(0, (tmp10 + tmp11) * 4);
    out(4, (tmp10 - tmp11) * 4);
  } else {
    out(0, (tmp10 + tmp11 + 2) >> 2);
    out(4, (tmp10 - tmp11 + 2) >> 2);
  }
  int64_t z1 = (tmp12 + tmp13) * 4433;
  out(2, (z1 + tmp13 * 6270 + r) >> n);
  out(6, (z1 + tmp12 * -15137 + r) >> n);
  z1 = tmp4 + tmp7;
  int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  int64_t z5 = (z3 + z4) * 9633;
  tmp4 *= 2446;
  tmp5 *= 16819;
  tmp6 *= 25172;
  tmp7 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  out(7, (tmp4 + z1 + z3 + r) >> n);
  out(5, (tmp5 + z2 + z4 + r) >> n);
  out(3, (tmp6 + z2 + z3 + r) >> n);
  out(1, (tmp7 + z1 + z4 + r) >> n);
}

// ---------------------------------------------------------------------------
// decoding
// ---------------------------------------------------------------------------

struct Huff {
  bool defined = false;
  uint16_t lut[512];  // next 9 bits -> (length << 8) | symbol, 0: longer
  int32_t maxcode[18];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t vals[256];

  void build(const uint8_t* bits, const uint8_t* v, int total) {
    std::memcpy(vals, v, total);
    std::memset(lut, 0, sizeof lut);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < bits[len - 1]; ++i) {
        if (code >= (1 << len)) fail("imdecode: corrupt JPEG (DHT codes)");
        if (len <= 9) {
          int lo = code << (9 - len);
          for (int j = 0; j < (1 << (9 - len)); ++j)
            lut[lo + j] = (uint16_t)((len << 8) | vals[k]);
        }
        ++code;
        ++k;
      }
      maxcode[len] = bits[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

struct Comp {
  int id, h, v, tq;
  int gh = 0, gw = 0;
  bool latched = false;
  int32_t q[64];
  std::vector<int16_t> coef;
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n) : d_(d), n_(n) { fill(); }
  inline void fill() {
    while (nbits_ <= 56) {
      uint64_t b = pos_ < n_ ? d_[pos_] : 0;
      acc_ |= b << (56 - nbits_);
      ++pos_;
      nbits_ += 8;
    }
  }
  inline uint32_t peek16() const { return (uint32_t)(acc_ >> 48); }
  inline void skip(int n) {
    acc_ <<= n;
    nbits_ -= n;
    if (nbits_ <= 56) fill();
  }
  inline uint32_t get(int n) {
    uint32_t v = (uint32_t)(acc_ >> (64 - n));
    skip(n);
    return v;
  }
  // bits past the data, counted as the plain version pads (8 bytes)
  inline bool overrun() const {
    return (int64_t)(pos_ * 8) - nbits_ > (int64_t)(n_ + 8) * 8 - 32;
  }

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

inline int decode_symbol(BitReader& br, const Huff& h) {
  uint32_t p = br.peek16();
  uint16_t e = h.lut[p >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 255;
  }
  for (int len = 10; len <= 16; ++len) {
    int32_t code = (int32_t)(p >> (16 - len));
    if (h.maxcode[len] >= 0 && code <= h.maxcode[len] &&
        code >= h.mincode[len]) {
      br.skip(len);
      return h.vals[h.valptr[len] + code - h.mincode[len]];
    }
  }
  fail("imdecode: corrupt JPEG (bad Huffman code)");
}

inline int extend(uint32_t v, int t) {
  return v < (1u << (t - 1)) ? (int)v - ((1 << t) - 1) : (int)v;
}

struct Frame {
  int h = 0, w = 0;
  std::vector<Comp> comps;
  int32_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff huff[2][4];
  int restart = 0;
  bool jfif = false;
  int adobe = -1;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool seen_sof = false, seen_scan = false;
};

const char* sof_mode(int m) {
  switch (m) {
    case 0xC2: return "progressive (SOF2)";
    case 0xC3: return "lossless (SOF3)";
    case 0xC5: return "hierarchical (SOF5)";
    case 0xC6: return "hierarchical progressive (SOF6)";
    case 0xC7: return "hierarchical lossless (SOF7)";
    case 0xC9: return "arithmetic-coded (SOF9)";
    case 0xCA: return "arithmetic-coded progressive (SOF10)";
    case 0xCB: return "arithmetic-coded lossless (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical progressive (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless (SOF15)";
    default: return nullptr;
  }
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// one scan's entropy-coded bytes [p, end): split at RST markers (when a
// restart interval is set) and unstuffed
void scan_segments(const uint8_t* p, const uint8_t* end, bool restart,
                   std::vector<std::vector<uint8_t>>& segs) {
  segs.assign(1, {});
  segs.back().reserve(end - p);
  while (p < end) {
    uint8_t b = *p++;
    if (b != 0xFF) {
      segs.back().push_back(b);
      continue;
    }
    const uint8_t* k = p;
    while (k < end && *k == 0xFF) ++k;
    if (k < end && *k == 0x00 && k == p) {
      segs.back().push_back(0xFF);
      p = k + 1;
    } else if (restart && k < end && *k >= 0xD0 && *k <= 0xD7) {
      segs.emplace_back();
      p = k + 1;
    } else {
      segs.back().push_back(0xFF);
    }
  }
}

void decode_scan(Frame& fr, const int* sc_ci, const int* sc_td,
                 const int* sc_ta, int ns, const uint8_t* ecs,
                 const uint8_t* ecs_end) {
  for (int k = 0; k < ns; ++k) {
    if (!fr.huff[0][sc_td[k]].defined)
      fail("imdecode: corrupt JPEG (Huffman table (0, " +
           std::to_string(sc_td[k]) + ") undefined)");
    if (!fr.huff[1][sc_ta[k]].defined)
      fail("imdecode: corrupt JPEG (Huffman table (1, " +
           std::to_string(sc_ta[k]) + ") undefined)");
  }
  long units;
  int bw1 = 0;
  if (ns == 1) {
    Comp& c = fr.comps[sc_ci[0]];
    bw1 = ceil_div(ceil_div(fr.w * c.h, fr.hmax), 8);
    int bh1 = ceil_div(ceil_div(fr.h * c.v, fr.vmax), 8);
    units = (long)bw1 * bh1;
  } else {
    units = (long)fr.mcux * fr.mcuy;
  }
  std::vector<std::vector<uint8_t>> segs;
  scan_segments(ecs, ecs_end, fr.restart != 0, segs);
  const long per = fr.restart ? fr.restart : units;
  const long nseg = (units + per - 1) / per;
  static const std::vector<uint8_t> empty;
  for (long s = 0; s < nseg; ++s) {
    const std::vector<uint8_t>& seg = s < (long)segs.size() ? segs[s] : empty;
    BitReader br(seg.data(), seg.size());
    int pred[4] = {0, 0, 0, 0};
    const long u_end = std::min(units, (s + 1) * per);
    for (long u = s * per; u < u_end; ++u) {
      for (int k = 0; k < ns; ++k) {
        Comp& c = fr.comps[sc_ci[k]];
        const Huff& dc = fr.huff[0][sc_td[k]];
        const Huff& ac = fr.huff[1][sc_ta[k]];
        int nv = ns == 1 ? 1 : c.v, nh = ns == 1 ? 1 : c.h;
        for (int v = 0; v < nv; ++v) {
          for (int hh = 0; hh < nh; ++hh) {
            int by, bx;
            if (ns == 1) {
              by = (int)(u / bw1);
              bx = (int)(u % bw1);
            } else {
              by = (int)(u / fr.mcux) * c.v + v;
              bx = (int)(u % fr.mcux) * c.h + hh;
            }
            int16_t* out = c.coef.data() + ((size_t)by * c.gw + bx) * 64;
            int t = decode_symbol(br, dc);
            if (t) {
              if (t > 16) fail("imdecode: corrupt JPEG (DC magnitude)");
              pred[k] += extend(br.get(t), t);
            }
            out[0] = (int16_t)pred[k];
            for (int i = 1; i < 64;) {
              int rs = decode_symbol(br, ac);
              int r = rs >> 4, tt = rs & 15;
              if (tt) {
                i += r;
                out[natural_order[i]] = (int16_t)extend(br.get(tt), tt);
                ++i;
              } else if (r == 15) {
                i += 16;
              } else {
                break;
              }
            }
            if (br.overrun())
              fail("imdecode: truncated JPEG (entropy-coded data ends "
                   "inside a block)");
          }
        }
      }
    }
  }
}

// upsample one real-size plane (dh x dw) by (hf, vf) into out (H x W)
void upsample(const uint8_t* p, int dh, int dw, int hf, int vf, uint8_t* out,
              int H, int W) {
  if (hf == 1 && vf == 1) {
    for (int y = 0; y < H; ++y) std::memcpy(out + (size_t)y * W, p + (size_t)y * dw, W);
    return;
  }
  std::vector<int> row(2 * (size_t)dw + 2);
  if (hf == 2 && vf == 1 && dw > 2) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* s = p + (size_t)y * dw;
      int* o = row.data();
      for (int j = 0; j < dw; ++j) {
        int l = s[j > 0 ? j - 1 : 0], r = s[j < dw - 1 ? j + 1 : dw - 1];
        o[2 * j] = (3 * s[j] + l + 1) >> 2;
        o[2 * j + 1] = (3 * s[j] + r + 2) >> 2;
      }
      for (int x = 0; x < W; ++x) out[(size_t)y * W + x] = (uint8_t)o[x];
    }
  } else if (hf == 1 && vf == 2) {
    for (int y = 0; y < H; ++y) {
      int i = y >> 1;
      const uint8_t* s = p + (size_t)i * dw;
      const uint8_t* n = (y & 1) ? p + (size_t)std::min(i + 1, dh - 1) * dw
                                 : p + (size_t)std::max(i - 1, 0) * dw;
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; ++x)
        out[(size_t)y * W + x] = (uint8_t)((3 * s[x] + n[x] + bias) >> 2);
    }
  } else if (hf == 2 && vf == 2 && dw > 2) {
    std::vector<int> cs(dw);
    for (int y = 0; y < H; ++y) {
      int i = y >> 1;
      const uint8_t* s = p + (size_t)i * dw;
      const uint8_t* n = (y & 1) ? p + (size_t)std::min(i + 1, dh - 1) * dw
                                 : p + (size_t)std::max(i - 1, 0) * dw;
      for (int j = 0; j < dw; ++j) cs[j] = 3 * s[j] + n[j];
      int* o = row.data();
      for (int j = 0; j < dw; ++j) {
        int l = cs[j > 0 ? j - 1 : 0], r = cs[j < dw - 1 ? j + 1 : dw - 1];
        o[2 * j] = (3 * cs[j] + l + 8) >> 4;
        o[2 * j + 1] = (3 * cs[j] + r + 7) >> 4;
      }
      for (int x = 0; x < W; ++x) out[(size_t)y * W + x] = (uint8_t)o[x];
    }
  } else {
    for (int y = 0; y < H; ++y) {
      const uint8_t* s = p + (size_t)(y / vf) * dw;
      for (int x = 0; x < W; ++x) out[(size_t)y * W + x] = s[x / hf];
    }
  }
}

// parse (and with out != nullptr decode) a JPEG stream
void jpeg_decode(const uint8_t* buf, size_t n, uint8_t* out, int64_t cap,
                 int32_t* dims) {
  const Tables& T = tables();  // natural_order too, before any DQT
  if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8)
    fail("imdecode: not a JPEG stream (no SOI marker)");
  Frame fr;
  size_t pos = 2;
  bool eoi = false;
  while (pos < n) {
    if (buf[pos] != 0xFF)
      fail("imdecode: corrupt JPEG (byte where a marker belongs, offset " +
           std::to_string(pos) + ")");
    while (pos < n && buf[pos] == 0xFF) ++pos;
    if (pos >= n) break;
    int marker = buf[pos++];
    if (marker == 0xD9) {
      eoi = true;
      break;
    }
    if ((marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
    if (pos + 2 > n) break;
    size_t length = ((size_t)buf[pos] << 8) | buf[pos + 1];
    if (length < 2 || pos + length > n)
      fail("imdecode: corrupt JPEG (marker of length " +
           std::to_string(length) + ")");
    const uint8_t* p = buf + pos + 2;
    size_t plen = length - 2;
    pos += length;
    auto need = [&](size_t k) {
      if (plen < k) fail("imdecode: corrupt JPEG (short marker segment)");
    };
    if (marker == 0xC0 || marker == 0xC1) {
      need(6);
      if (p[0] != 8) unsupported(std::to_string(p[0]) + "-bit");
      fr.h = (p[1] << 8) | p[2];
      fr.w = (p[3] << 8) | p[4];
      int nc = p[5];
      if (nc == 4) unsupported("4-component (CMYK/YCCK)");
      if (nc != 1 && nc != 3) unsupported(std::to_string(nc) + "-component");
      if (fr.h == 0 || fr.w == 0) fail("imdecode: JPEG of size 0");
      need(6 + 3 * (size_t)nc);
      for (int i = 0; i < nc; ++i) {
        Comp c;
        c.id = p[6 + 3 * i];
        c.h = p[7 + 3 * i] >> 4;
        c.v = p[7 + 3 * i] & 15;
        c.tq = p[8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
          fail("imdecode: corrupt JPEG (sampling)");
        fr.comps.push_back(c);
      }
      fr.seen_sof = true;
      if (!out) {
        dims[0] = fr.h;
        dims[1] = fr.w;
        dims[2] = nc;
        return;
      }
      for (auto& c : fr.comps) {
        fr.hmax = std::max(fr.hmax, c.h);
        fr.vmax = std::max(fr.vmax, c.v);
      }
      fr.mcux = ceil_div(fr.w, 8 * fr.hmax);
      fr.mcuy = ceil_div(fr.h, 8 * fr.vmax);
      for (auto& c : fr.comps) {
        c.gh = fr.mcuy * c.v;
        c.gw = fr.mcux * c.h;
        c.coef.assign((size_t)c.gh * c.gw * 64, 0);
      }
    } else if (sof_mode(marker)) {
      unsupported(sof_mode(marker));
    } else if (marker == 0xCC) {
      unsupported("arithmetic-coded");
    } else if (marker == 0xC4) {
      size_t i = 0;
      while (i < plen) {
        if (i + 17 > plen) fail("imdecode: corrupt JPEG (DHT)");
        int tc = p[i] >> 4, th = p[i] & 15;
        int total = 0;
        for (int k = 0; k < 16; ++k) total += p[i + 1 + k];
        if (tc > 1 || th > 3 || total > 256 || i + 17 + total > plen)
          fail("imdecode: corrupt JPEG (DHT)");
        fr.huff[tc][th].build(p + i + 1, p + i + 17, total);
        i += 17 + total;
      }
    } else if (marker == 0xDB) {
      size_t i = 0;
      while (i < plen) {
        int pq = p[i] >> 4, tq = p[i] & 15;
        size_t sz = pq == 0 ? 64 : 128;
        if (tq > 3 || i + 1 + sz > plen) fail("imdecode: corrupt JPEG (DQT)");
        for (int k = 0; k < 64; ++k) {
          int v = pq == 0 ? p[i + 1 + k]
                          : (p[i + 1 + 2 * k] << 8) | p[i + 2 + 2 * k];
          fr.qt[tq][natural_order[k]] = v;
        }
        fr.qt_defined[tq] = true;
        i += 1 + sz;
      }
    } else if (marker == 0xDD) {
      need(2);
      fr.restart = (p[0] << 8) | p[1];
    } else if (marker == 0xE0) {
      if (plen >= 5 && std::memcmp(p, "JFIF\0", 5) == 0) fr.jfif = true;
    } else if (marker == 0xEE) {
      if (plen >= 12 && std::memcmp(p, "Adobe", 5) == 0) fr.adobe = p[11];
    } else if (marker == 0xDA) {
      if (!fr.seen_sof) fail("imdecode: corrupt JPEG (SOS before SOF)");
      need(1);
      int ns = p[0];
      if (ns < 1 || ns > 4) fail("imdecode: corrupt JPEG (SOS)");
      need(4 + 2 * (size_t)ns);
      int ci[4], td[4], ta[4];
      for (int i = 0; i < ns; ++i) {
        int cid = p[1 + 2 * i], tbl = p[2 + 2 * i];
        ci[i] = -1;
        for (size_t k = 0; k < fr.comps.size(); ++k)
          if (fr.comps[k].id == cid) {
            ci[i] = (int)k;
            break;
          }
        if (ci[i] < 0)
          fail("imdecode: corrupt JPEG (scan of unknown component " +
               std::to_string(cid) + ")");
        td[i] = tbl >> 4;
        ta[i] = tbl & 15;
        if (td[i] > 3 || ta[i] > 3) fail("imdecode: corrupt JPEG (SOS)");
      }
      int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ahal = p[3 + 2 * ns];
      if (ss != 0 || se != 63 || ahal != 0)
        unsupported("progressive (spectral selection)");
      for (int i = 0; i < ns; ++i) {
        Comp& c = fr.comps[ci[i]];
        if (!c.latched) {
          if (c.tq > 3 || !fr.qt_defined[c.tq])
            fail("imdecode: corrupt JPEG (quantization table " +
                 std::to_string(c.tq) + " undefined)");
          std::memcpy(c.q, fr.qt[c.tq], sizeof c.q);
          c.latched = true;
        }
      }
      // the entropy-coded data runs to the first marker other than RSTn
      size_t end = pos;
      while (end < n) {
        if (buf[end] == 0xFF) {
          size_t k = end + 1;
          while (k < n && buf[k] == 0xFF) ++k;
          if (k < n && buf[k] != 0x00 && !(buf[k] >= 0xD0 && buf[k] <= 0xD7))
            break;
          end = k;
          continue;
        }
        ++end;
      }
      decode_scan(fr, ci, td, ta, ns, buf + pos, buf + end);
      fr.seen_scan = true;
      pos = end;
    } else if (marker == 0xDC) {
      unsupported("DNL-sized");
    }
  }
  if (!eoi) fail("imdecode: truncated JPEG (no EOI marker)");
  if (!fr.seen_sof) fail("imdecode: JPEG without a frame header");
  if (!out) fail("imdecode: JPEG without a frame header");
  if (!fr.seen_scan) fail("imdecode: JPEG without a scan");
  const int H = fr.h, W = fr.w, nc = (int)fr.comps.size();
  if (cap < (int64_t)H * W * nc) fail("imdecode: output buffer too small");
  std::vector<std::vector<uint8_t>> full(nc);
  std::vector<uint8_t> plane;
  for (int k = 0; k < nc; ++k) {
    Comp& c = fr.comps[k];
    if (!c.latched)
      fail("imdecode: corrupt JPEG (component " + std::to_string(c.id) +
           " in no scan)");
    const int ph = c.gh * 8, pw = c.gw * 8;
    plane.resize((size_t)ph * pw);
    for (int by = 0; by < c.gh; ++by)
      for (int bx = 0; bx < c.gw; ++bx)
        idct_block(c.coef.data() + ((size_t)by * c.gw + bx) * 64, c.q,
                   plane.data() + (size_t)by * 8 * pw + bx * 8, pw,
                   T.idct_limit);
    const int dh = ceil_div(H * c.v, fr.vmax), dw = ceil_div(W * c.h, fr.hmax);
    const int hf = fr.hmax / c.h, vf = fr.vmax / c.v;
    if (hf * c.h != fr.hmax || vf * c.v != fr.vmax)
      unsupported("fractional-sampling");
    std::vector<uint8_t> real((size_t)dh * dw);
    for (int y = 0; y < dh; ++y)
      std::memcpy(real.data() + (size_t)y * dw, plane.data() + (size_t)y * pw, dw);
    full[k].resize((size_t)H * W);
    upsample(real.data(), dh, dw, hf, vf, full[k].data(), H, W);
  }
  const size_t npix = (size_t)H * W;
  if (nc == 1) {
    std::memcpy(out, full[0].data(), npix);
  } else {
    bool ycc;
    if (fr.jfif)
      ycc = true;
    else if (fr.adobe >= 0)
      ycc = fr.adobe != 0;
    else
      ycc = !(fr.comps[0].id == 82 && fr.comps[1].id == 71 &&
              fr.comps[2].id == 66);
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (size_t i = 0; i < npix; ++i) {
      uint8_t* o = out + 3 * i;
      if (ycc) {
        int y = Y[i], cb = Cb[i], cr = Cr[i];
        o[0] = clamp255(y + T.cr_r[cr]);
        o[1] = clamp255(y + ((T.cb_g[cb] + T.cr_g[cr]) >> 16));
        o[2] = clamp255(y + T.cb_b[cb]);
      } else {
        o[0] = Y[i];
        o[1] = Cb[i];
        o[2] = Cr[i];
      }
    }
  }
  dims[0] = H;
  dims[1] = W;
  dims[2] = nc;
}

// ---------------------------------------------------------------------------
// encoding
// ---------------------------------------------------------------------------

const uint8_t kBaseQuant[2][64] = {
    {16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40,
     26, 24, 22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51,
     56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87,
     95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103,
     99},
    {17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

const uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119}};
const uint8_t kAcVals[2][162] = {
    {1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20,
     50, 129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98,
     114, 130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53,
     54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87,
     88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118,
     119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147,
     148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168,
     169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196,
     197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217,
     218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243,
     244, 245, 246, 247, 248, 249, 250},
    {0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50,
     129, 8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114,
     209, 10, 22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42,
     53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86,
     87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117,
     118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138,
     146, 147, 148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166,
     167, 168, 169, 170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194,
     195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215,
     216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243,
     244, 245, 246, 247, 248, 249, 250}};

struct HuffCodes {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(len, 0, sizeof len);
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i) {
        code[vals[k]] = (uint16_t)c;
        len[vals[k]] = (uint8_t)l;
        ++c;
        ++k;
      }
      c <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  inline void put(uint32_t v, int n) {
    acc_ = (acc_ << n) | (v & ((1u << n) - 1));
    nbits_ += n;
    while (nbits_ >= 8) {
      uint8_t b = (uint8_t)(acc_ >> (nbits_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
      nbits_ -= 8;
    }
  }
  void flush() {
    if (nbits_) put(0x7F, 8 - nbits_);
    acc_ = 0;
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

struct Recip {
  int64_t r, c, s;
};

Recip reciprocal(int divisor) {
  int b = 31 - __builtin_clz((unsigned)divisor);
  int r = 16 + b;
  int64_t fq = ((int64_t)1 << r) / divisor, fr = ((int64_t)1 << r) % divisor;
  int64_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

void put_marker(std::vector<uint8_t>& o, int code, const std::vector<uint8_t>& p) {
  o.push_back(0xFF);
  o.push_back((uint8_t)code);
  size_t n = p.size() + 2;
  o.push_back((uint8_t)(n >> 8));
  o.push_back((uint8_t)(n & 255));
  o.insert(o.end(), p.begin(), p.end());
}

// the padded, downsampled plane of one component, as _comp_planes makes it
std::vector<int32_t> comp_plane(const int32_t* full, int H, int W, int hf,
                                int vf, int vmax, int bw, int bh) {
  const int out_w = bw * 8;
  const int rows = ceil_div(H, vmax) * vmax / vf;
  const int ph = bh * 8;
  std::vector<int32_t> ds((size_t)std::max(rows, ph) * out_w);
  auto src = [&](int y, int x) {
    return full[(size_t)std::min(y, H - 1) * W + std::min(x, W - 1)];
  };
  for (int y = 0; y < rows; ++y) {
    for (int x = 0; x < out_w; ++x) {
      int32_t v;
      if (hf == 1 && vf == 1) {
        v = src(y, x);
      } else if (hf == 2 && vf == 1) {
        v = (src(y, 2 * x) + src(y, 2 * x + 1) + (x & 1)) >> 1;
      } else if (hf == 2 && vf == 2) {
        v = (src(2 * y, 2 * x) + src(2 * y, 2 * x + 1) + src(2 * y + 1, 2 * x) +
             src(2 * y + 1, 2 * x + 1) + 1 + (x & 1)) >> 2;
      } else {
        int64_t s = 0;
        for (int a = 0; a < vf; ++a)
          for (int b = 0; b < hf; ++b) s += src(y * vf + a, x * hf + b);
        int n = hf * vf;
        v = (int32_t)((s + n / 2) / n);
      }
      ds[(size_t)y * out_w + x] = v;
    }
  }
  for (int y = rows; y < ph; ++y)
    std::memcpy(&ds[(size_t)y * out_w], &ds[(size_t)(rows - 1) * out_w],
                out_w * sizeof(int32_t));
  return ds;
}

void jpeg_encode(const uint8_t* img, int H, int W, int nc, int quality,
                 int hs, int vs, int restart, std::vector<uint8_t>& o) {
  if (H <= 0 || W <= 0 || H >= 65536 || W >= 65536)
    fail("imencode: JPEG of size " + std::to_string(W) + "x" + std::to_string(H));
  if (nc != 1 && nc != 3)
    fail("imencode: JPEG takes 1 or 3 channels, got " + std::to_string(nc));
  if (nc == 1) hs = vs = 1;
  if (hs < 1 || hs > 2 || vs < 1 || vs > 2) fail("imencode: sampling");
  if (restart < 0 || restart > 65535) fail("imencode: restart interval");
  const Tables& T = tables();
  int q = std::min(std::max(quality, 1), 100);
  int scale = q < 50 ? 5000 / q : 200 - 2 * q;
  const int ntab = nc == 1 ? 1 : 2;
  uint8_t qzz[2][64];
  int32_t qnat[2][64];
  for (int t = 0; t < ntab; ++t)
    for (int k = 0; k < 64; ++k) {
      int v = (kBaseQuant[t][k] * scale + 50) / 100;
      v = std::min(std::max(v, 1), 255);
      qzz[t][k] = (uint8_t)v;
      qnat[t][natural_order[k]] = v;
    }
  struct C {
    int id, h, v, tq;
  } comps[3] = {{1, hs, vs, 0}, {2, 1, 1, 1}, {3, 1, 1, 1}};
  const int hmax = hs, vmax = vs;
  const size_t npix = (size_t)H * W;
  std::vector<std::vector<int32_t>> fulls(nc, std::vector<int32_t>(npix));
  for (size_t i = 0; i < npix; ++i) {
    if (nc == 1) {
      fulls[0][i] = img[i];
    } else {
      int r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      fulls[0][i] = (int32_t)((T.y_r[r] + T.y_g[g] + T.y_b[b]) >> 16);
      fulls[1][i] = (int32_t)((T.cb_r[r] + T.cb_g2[g] + T.half_b[b]) >> 16);
      fulls[2][i] = (int32_t)((T.half_b[r] + T.cr_g2[g] + T.cr_b[b]) >> 16);
    }
  }
  std::vector<std::vector<int16_t>> qb(nc);
  int gbw[3], gbh[3];
  for (int k = 0; k < nc; ++k) {
    const C& c = comps[k];
    int hf = hmax / c.h, vf = vmax / c.v;
    int dw = ceil_div(W * c.h, hmax), dh = ceil_div(H * c.v, vmax);
    int bw = ceil_div(dw, 8), bh = ceil_div(dh, 8);
    gbw[k] = bw;
    gbh[k] = bh;
    std::vector<int32_t> pl = comp_plane(fulls[k].data(), H, W, hf, vf, vmax, bw, bh);
    Recip rc[64];
    for (int i = 0; i < 64; ++i) rc[i] = reciprocal(qnat[c.tq][i] << 3);
    qb[k].resize((size_t)bw * bh * 64);
    const int pw = bw * 8;
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        int64_t blk[64], ws[64];
        for (int r = 0; r < 8; ++r)
          for (int cc = 0; cc < 8; ++cc)
            blk[r * 8 + cc] = pl[(size_t)(by * 8 + r) * pw + bx * 8 + cc] - 128;
        for (int r = 0; r < 8; ++r)
          fdct_pass([&](int k2) { return blk[r * 8 + k2]; },
                    [&](int k2, int64_t v) { ws[r * 8 + k2] = v; }, true);
        for (int cc = 0; cc < 8; ++cc)
          fdct_pass([&](int k2) { return ws[k2 * 8 + cc]; },
                    [&](int k2, int64_t v) { blk[k2 * 8 + cc] = v; }, false);
        int16_t* dst = &qb[k][((size_t)by * bw + bx) * 64];
        for (int i = 0; i < 64; ++i) {
          int64_t x = blk[i], m = x < 0 ? -x : x;
          int64_t v = ((m + rc[i].c) * rc[i].r) >> rc[i].s;
          dst[i] = (int16_t)(x < 0 ? -v : v);
        }
      }
  }
  HuffCodes dc[2], ac[2];
  for (int t = 0; t < 2; ++t) {
    dc[t].build(kDcBits[t], kDcVals);
    ac[t].build(kAcBits[t], kAcVals[t]);
  }
  // headers
  o.clear();
  o.push_back(0xFF);
  o.push_back(0xD8);
  put_marker(o, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < ntab; ++t) {
    std::vector<uint8_t> p(65);
    p[0] = (uint8_t)t;
    std::memcpy(p.data() + 1, qzz[t], 64);
    put_marker(o, 0xDB, p);
  }
  {
    std::vector<uint8_t> p = {8, (uint8_t)(H >> 8), (uint8_t)(H & 255),
                              (uint8_t)(W >> 8), (uint8_t)(W & 255),
                              (uint8_t)nc};
    for (int k = 0; k < nc; ++k) {
      p.push_back((uint8_t)comps[k].id);
      p.push_back((uint8_t)((comps[k].h << 4) | comps[k].v));
      p.push_back((uint8_t)comps[k].tq);
    }
    put_marker(o, 0xC0, p);
  }
  for (int t = 0; t < ntab; ++t) {
    std::vector<uint8_t> p(1 + 16 + 12);
    p[0] = (uint8_t)t;
    std::memcpy(p.data() + 1, kDcBits[t], 16);
    std::memcpy(p.data() + 17, kDcVals, 12);
    put_marker(o, 0xC4, p);
    p.resize(1 + 16 + 162);
    p[0] = (uint8_t)(0x10 | t);
    std::memcpy(p.data() + 1, kAcBits[t], 16);
    std::memcpy(p.data() + 17, kAcVals[t], 162);
    put_marker(o, 0xC4, p);
  }
  if (restart)
    put_marker(o, 0xDD, {(uint8_t)(restart >> 8), (uint8_t)(restart & 255)});
  {
    std::vector<uint8_t> p(1, (uint8_t)nc);
    for (int k = 0; k < nc; ++k) {
      int t = k == 0 ? 0 : 1;
      p.push_back((uint8_t)comps[k].id);
      p.push_back((uint8_t)((t << 4) | t));
    }
    p.push_back(0);
    p.push_back(63);
    p.push_back(0);
    put_marker(o, 0xDA, p);
  }
  BitWriter bw(o);
  int pred[3] = {0, 0, 0};
  auto emit = [&](int k, const int16_t* blk) {
    const int t = k == 0 ? 0 : 1;
    int diff = blk[0] - pred[k];
    pred[k] = blk[0];
    int mag = diff < 0 ? -diff : diff;
    int nbits = mag ? 32 - __builtin_clz((unsigned)mag) : 0;
    bw.put(dc[t].code[nbits], dc[t].len[nbits]);
    if (nbits) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), nbits);
    int run = 0;
    for (int i = 1; i < 64; ++i) {
      int v = blk[natural_order[i]];
      if (!v) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac[t].code[0xF0], ac[t].len[0xF0]);
        run -= 16;
      }
      int m = v < 0 ? -v : v;
      int nb = 32 - __builtin_clz((unsigned)m);
      int sym = (run << 4) + nb;
      bw.put(ac[t].code[sym], ac[t].len[sym]);
      bw.put((uint32_t)(v < 0 ? v - 1 : v), nb);
      run = 0;
    }
    if (run) bw.put(ac[t].code[0], ac[t].len[0]);
  };
  long nmcu;
  int mcux;
  if (nc == 1) {
    mcux = gbw[0];
    nmcu = (long)gbw[0] * gbh[0];
  } else {
    mcux = ceil_div(W, 8 * hmax);
    nmcu = (long)mcux * ceil_div(H, 8 * vmax);
  }
  int16_t dummy[64];
  for (long m = 0; m < nmcu; ++m) {
    if (restart && m && m % restart == 0) {
      bw.flush();
      o.push_back(0xFF);
      o.push_back((uint8_t)(0xD0 + ((m / restart - 1) % 8)));
      pred[0] = pred[1] = pred[2] = 0;
    }
    const int a = (int)(m / mcux), b = (int)(m % mcux);
    if (nc == 1) {
      emit(0, &qb[0][((size_t)a * gbw[0] + b) * 64]);
      continue;
    }
    for (int k = 0; k < nc; ++k) {
      const C& c = comps[k];
      int prev_dc = 0;
      for (int v = 0; v < c.v; ++v)
        for (int hh = 0; hh < c.h; ++hh) {
          int by = a * c.v + v, bx = b * c.h + hh;
          if (by < gbh[k] && bx < gbw[k]) {
            const int16_t* blk = &qb[k][((size_t)by * gbw[k] + bx) * 64];
            emit(k, blk);
            prev_dc = blk[0];
          } else {
            std::memset(dummy, 0, sizeof dummy);
            dummy[0] = (int16_t)prev_dc;
            emit(k, dummy);
          }
        }
    }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
}

// ---------------------------------------------------------------------------
// Pillow's bilinear resample
// ---------------------------------------------------------------------------

constexpr int kPrecisionBits = 32 - 8 - 2;

struct Coeffs {
  int ksize;
  std::vector<int> xmin, xmax;
  std::vector<int32_t> kk;
};

Coeffs coeffs(int in_size, int out_size) {
  Coeffs c;
  double scale = (double)((float)in_size - 0.0f) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 1.0 * filterscale;
  c.ksize = (int)std::ceil(support) * 2 + 1;
  c.xmin.resize(out_size);
  c.xmax.resize(out_size);
  c.kk.assign((size_t)out_size * c.ksize, 0);
  std::vector<double> k(c.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = 0.0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double a = (x + xmin - center + 0.5) * ss;
      if (a < 0.0) a = -a;
      double w = a < 1.0 ? 1.0 - a : 0.0;
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
      double v = k[x];
      c.kk[(size_t)xx * c.ksize + x] =
          v < 0 ? (int32_t)(-0.5 + v * (1 << kPrecisionBits))
                : (int32_t)(0.5 + v * (1 << kPrecisionBits));
    }
    c.xmin[xx] = xmin;
    c.xmax[xx] = xmax;
  }
  return c;
}

inline uint8_t clip8(int64_t in) {
  if (in >= ((int64_t)1 << kPrecisionBits << 8)) return 255;
  if (in <= 0) return 0;
  return (uint8_t)(in >> kPrecisionBits);
}

void resize(const uint8_t* in, int h, int w, int nc, uint8_t* out, int oh,
            int ow) {
  if (h <= 0 || w <= 0 || nc <= 0 || oh <= 0 || ow <= 0)
    fail("resize: bad size");
  const uint8_t* src = in;
  std::vector<uint8_t> tmp;
  int cw = w;
  if (ow != w) {
    Coeffs c = coeffs(w, ow);
    tmp.resize((size_t)h * ow * nc);
    for (int y = 0; y < h; ++y) {
      const uint8_t* row = in + (size_t)y * w * nc;
      uint8_t* o = tmp.data() + (size_t)y * ow * nc;
      for (int xx = 0; xx < ow; ++xx) {
        const int32_t* k = &c.kk[(size_t)xx * c.ksize];
        const int xmin = c.xmin[xx], xmax = c.xmax[xx];
        for (int ch = 0; ch < nc; ++ch) {
          int64_t ss = 1 << (kPrecisionBits - 1);
          for (int x = 0; x < xmax; ++x)
            ss += (int64_t)row[(size_t)(x + xmin) * nc + ch] * k[x];
          o[(size_t)xx * nc + ch] = clip8(ss);
        }
      }
    }
    src = tmp.data();
    cw = ow;
  }
  if (oh != h) {
    Coeffs c = coeffs(h, oh);
    const size_t rowlen = (size_t)cw * nc;
    for (int yy = 0; yy < oh; ++yy) {
      const int32_t* k = &c.kk[(size_t)yy * c.ksize];
      uint8_t* o = out + (size_t)yy * rowlen;
      for (size_t i = 0; i < rowlen; ++i) {
        int64_t ss = 1 << (kPrecisionBits - 1);
        for (int y = 0; y < c.xmax[yy]; ++y)
          ss += (int64_t)src[(size_t)(y + c.xmin[yy]) * rowlen + i] * k[y];
        o[i] = clip8(ss);
      }
    }
  } else {
    std::memcpy(out, src, (size_t)h * cw * nc);
  }
}

}  // namespace

extern "C" {

const char* imgcodec_error() { return g_error.c_str(); }

int32_t imgcodec_decode(const uint8_t* buf, int64_t n, uint8_t* out,
                        int64_t cap, int32_t* dims) {
  try {
    jpeg_decode(buf, (size_t)n, out, cap, dims);
    return 0;
  } catch (const CodecError& e) {
    g_error = e.msg;
  } catch (const std::exception& e) {
    g_error = std::string("imdecode: ") + e.what();
  }
  return -1;
}

int32_t imgcodec_encode(const uint8_t* img, int32_t h, int32_t w, int32_t c,
                        int32_t quality, int32_t hs, int32_t vs,
                        int32_t restart, uint8_t* out, int64_t cap,
                        int64_t* out_len) {
  try {
    std::vector<uint8_t> o;
    o.reserve((size_t)h * w * c / 4 + 1024);
    jpeg_encode(img, h, w, c, quality, hs, vs, restart, o);
    *out_len = (int64_t)o.size();
    if ((int64_t)o.size() > cap) return 1;
    std::memcpy(out, o.data(), o.size());
    return 0;
  } catch (const CodecError& e) {
    g_error = e.msg;
  } catch (const std::exception& e) {
    g_error = std::string("imencode: ") + e.what();
  }
  return -1;
}

int32_t imgcodec_resize(const uint8_t* in, int32_t h, int32_t w, int32_t c,
                        uint8_t* out, int32_t oh, int32_t ow) {
  try {
    resize(in, h, w, c, out, oh, ow);
    return 0;
  } catch (const CodecError& e) {
    g_error = e.msg;
  } catch (const std::exception& e) {
    g_error = std::string("resize: ") + e.what();
  }
  return -1;
}

}  // extern "C"
