// Baseline JPEG decoder of onepiece_tpu_torch (host C++, built by _native.py).
//
// The card's machine has neither OpenCV nor PIL, and ScanNet exports store
// colour as JPEG. This decodes the subset such files use and reproduces
// libjpeg-turbo's default decompression (what cv2.imdecode runs) bit for
// bit, because every stage of that path is integer arithmetic:
//   - baseline (SOF0) Huffman entropy decoding, 8-bit samples, 1 or 3
//     components in one interleaved scan, restart intervals, up to four
//     quantisation and Huffman tables of each kind;
//   - the accurate integer inverse DCT (jidctint.c, jpeg_idct_islow) with
//     its post-IDCT range-limit table;
//   - fancy (triangle-filter) chroma upsampling for 4:2:2 (h2v1) and 4:2:0
//     (h2v2), with its rounding biases and edge rules (jdsample.c), the
//     last real row and column of each component repeated as jdmainct.c
//     repeats them;
//   - the fixed-point YCbCr -> RGB tables (jdcolor.c).
// Extended sequential, progressive, arithmetic-coded, lossless, hierarchical
// and 12-bit streams, RGB- or CMYK-coded colour, other samplings and
// multi-scan files are rejected; so are truncated or corrupt streams
// (libjpeg would warn and fill with gray). Errors come back as a message,
// never a partial image.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zig-zag index -> natural (row-major) index
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // symbol index = code + valoffset[len]
  uint8_t vals[256];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals, bool dc) {
  int p = 0;
  uint32_t code = 0;
  std::memset(h.look_len, 0, sizeof(h.look_len));
  for (int len = 1; len <= 16; len++) {
    h.valoffset[len] = p - static_cast<int32_t>(code);
    for (int i = 0; i < counts[len - 1]; i++, p++, code++) {
      // No code may be all ones (jdhuff.c: code + 1 must fit in len bits);
      // checked before the lookup tables are written, so none overruns.
      if (code + 1 >= (1u << len)) throw Error("bad Huffman table");
      if (len <= kLookBits) {
        int shift = kLookBits - len;
        for (int k = 0; k < (1 << shift); k++) {
          h.look_len[(code << shift) | k] = static_cast<uint8_t>(len);
          h.look_sym[(code << shift) | k] = vals[p];
        }
      }
    }
    h.maxcode[len] = counts[len - 1] ? static_cast<int32_t>(code) - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  std::memcpy(h.vals, vals, nvals);
  if (dc)
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) throw Error("bad DC Huffman table");
  h.defined = true;
}

// Entropy-coded data with its 0xFF00 stuffing removed. At a marker or at the
// end of the buffer it supplies zero bits and counts them; consuming one of
// them means the scan was truncated or corrupt.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int cnt = 0;
  int zero_bits = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 56) {
      uint32_t byte = 0;
      if (at_marker || p >= end) {
        zero_bits += 8;
      } else if (*p != 0xFF) {
        byte = *p++;
      } else if (p + 1 < end && p[1] == 0x00) {
        byte = 0xFF;
        p += 2;
      } else {  // a marker (or a lone 0xFF at the end): stop before it
        at_marker = true;
        zero_bits += 8;
      }
      buf |= static_cast<uint64_t>(byte) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int n) {
    if (cnt < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    cnt -= n;
  }
  int get(int n) {  // n in 1..16
    uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  void check() const {
    if (zero_bits > cnt) throw Error("truncated or corrupt JPEG data");
  }
  void reset() {
    buf = 0;
    cnt = 0;
    zero_bits = 0;
    at_marker = false;
  }
};

int decode_symbol(BitReader& br, const Huffman& h) {
  uint32_t look = br.peek(kLookBits);
  int len = h.look_len[look];
  if (len) {
    br.skip(len);
    return h.look_sym[look];
  }
  uint32_t bits = br.peek(16);
  for (len = kLookBits + 1; len <= 16; len++) {
    int32_t code = static_cast<int32_t>(bits >> (16 - len));
    if (code <= h.maxcode[len]) {
      br.skip(len);
      return h.vals[code + h.valoffset[len]];
    }
  }
  throw Error("corrupt JPEG data: bad Huffman code");
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ---- the accurate integer inverse DCT, jidctint.c -------------------------

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// The post-IDCT range limit of jdmaster.c's prepare_range_limit_table:
// index (x & 1023) for an IDCT output x (before the +128 level shift).
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++)
      t[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
  }
};
const RangeLimit kIdctLimit;

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = (in[0] * q[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * q[56];
    tmp1 = in[40] * q[40];
    tmp2 = in[24] * q[24];
    tmp3 = in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    w[0] = static_cast<int>(descale(tmp10 + tmp3, S));
    w[56] = static_cast<int>(descale(tmp10 - tmp3, S));
    w[8] = static_cast<int>(descale(tmp11 + tmp2, S));
    w[48] = static_cast<int>(descale(tmp11 - tmp2, S));
    w[16] = static_cast<int>(descale(tmp12 + tmp1, S));
    w[40] = static_cast<int>(descale(tmp12 - tmp1, S));
    w[24] = static_cast<int>(descale(tmp13 + tmp0, S));
    w[32] = static_cast<int>(descale(tmp13 - tmp0, S));
  }
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = lim[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int k = 0; k < 8; k++) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS + PASS1_BITS + 3;
    o[0] = lim[descale(tmp10 + tmp3, S) & 1023];
    o[7] = lim[descale(tmp10 - tmp3, S) & 1023];
    o[1] = lim[descale(tmp11 + tmp2, S) & 1023];
    o[6] = lim[descale(tmp11 - tmp2, S) & 1023];
    o[2] = lim[descale(tmp12 + tmp1, S) & 1023];
    o[5] = lim[descale(tmp12 - tmp1, S) & 1023];
    o[3] = lim[descale(tmp13 + tmp0, S) & 1023];
    o[4] = lim[descale(tmp13 - tmp0, S) & 1023];
  }
}

// ---- YCbCr -> RGB, jdcolor.c ---------------------------------------------

struct ColorTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  ColorTables() {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << SCALEBITS) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const ColorTables kColor;

inline uint8_t clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : static_cast<uint8_t>(v); }

// ---- chroma upsampling, jdsample.c ------------------------------------------

// One output row of a component upsampled 2x across, into `out` (2 * dw
// samples): h2v1_fancy_upsample from the nearest row alone; with
// `vertical`, h2v2_fancy_upsample from the nearest row and the next
// nearest (`far`: the row above for even output rows, below for odd ones).
void upsample_row(const uint8_t* near, const uint8_t* far, int dw, bool vertical, uint8_t* out) {
  if (dw <= 2) {  // libjpeg's box filter below three columns
    for (int x = 0; x < dw; x++) out[2 * x] = out[2 * x + 1] = near[x];
    return;
  }
  if (!vertical) {
    out[0] = near[0];
    out[1] = static_cast<uint8_t>((near[0] * 3 + near[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; x++) {
      int v = near[x] * 3;
      out[2 * x] = static_cast<uint8_t>((v + near[x - 1] + 1) >> 2);
      out[2 * x + 1] = static_cast<uint8_t>((v + near[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = static_cast<uint8_t>((near[dw - 1] * 3 + near[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = near[dw - 1];
    return;
  }
  int this_sum = near[0] * 3 + far[0], next_sum = near[1] * 3 + far[1];
  out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
  out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
  int last_sum = this_sum;
  this_sum = next_sum;
  for (int x = 1; x < dw - 1; x++) {
    next_sum = near[x + 1] * 3 + far[x + 1];
    out[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
  }
  out[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
  out[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
}

// ---- the stream ---------------------------------------------------------------

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;   // Huffman tables of the scan
  int bw = 0, bh = 0;   // blocks across and down the coded plane
  int dw = 0, dh = 0;   // downsampled_width / height: the real samples
  std::vector<uint8_t> plane;
  int pred = 0;
};

struct Jpeg {
  Jpeg(const uint8_t* d, size_t n) : data(d), size(n) {}
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0;
  bool headers_only = false;  // stop at the scan: size and channels only
  bool have_frame = false, saw_jfif = false, saw_adobe = false, done = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t quant[4][64];
  bool have_quant[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;
  int hmax = 1, vmax = 1;

  uint8_t byte() {
    if (pos >= size) throw Error("truncated JPEG");
    return data[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {
    if (byte() != 0xFF) throw Error("corrupt JPEG: expected a marker");
    int m;
    do m = byte();
    while (m == 0xFF);
    return m;
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pt = byte(), pq = pt >> 4, t = pt & 15;
      if (t > 3 || pq > 1) throw Error("bad DQT");
      for (int k = 0; k < 64; k++) quant[t][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : byte());
      have_quant[t] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc = byte(), cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) throw Error("bad DHT");
      uint8_t counts[16], vals[256];
      int n = 0;
      for (int i = 0; i < 16; i++) n += counts[i] = byte();
      if (n > 256) throw Error("bad Huffman table");
      for (int i = 0; i < n; i++) vals[i] = byte();
      build_huffman(cls ? ac[t] : dc[t], counts, vals, n, cls == 0);
    }
  }

  void read_sof() {
    if (have_frame) throw Error("more than one frame");
    int precision = byte();
    height = u16();
    width = u16();
    int n = byte();
    if (precision != 8) throw Error(std::to_string(precision) + "-bit JPEG is not supported");
    if (height == 0) throw Error("JPEG height defined by DNL is not supported");
    if (width == 0) throw Error("JPEG width 0");
    if (n != 1 && n != 3) throw Error(std::to_string(n) + "-component JPEG is not supported");
    comps.resize(n);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) throw Error("bad SOF");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (auto& c : comps) {
      int rh = hmax / c.h, rv = vmax / c.v;
      bool ok = hmax % c.h == 0 && vmax % c.v == 0 &&
                ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
      if (!ok || (n == 3 && &c == &comps[0] && (rh != 1 || rv != 1)))
        throw Error("chroma sampling other than 4:4:4, 4:2:2 and 4:2:0 is not supported");
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
    }
    have_frame = true;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = decode_symbol(br, dc[c.td]);
    int diff = s ? extend(br.get(s), s) : 0;
    c.pred += diff;
    blk[0] = static_cast<int16_t>(c.pred);
    const Huffman& a = ac[c.ta];
    for (int k = 1; k < 64; k++) {
      int rs = decode_symbol(br, a);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw Error("corrupt JPEG data: coefficient index past 63");
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
  }

  // Move to the marker that ends the entropy-coded data; nothing but the
  // encoder's 1-bit padding may be left unread before it.
  void to_marker(BitReader& br) {
    br.check();
    pos = br.p - data;
    if (br.at_marker) return;
    if (pos >= size) throw Error("truncated JPEG");
    if (pos + 1 >= size || data[pos] != 0xFF || data[pos + 1] == 0x00)
      throw Error("corrupt JPEG data: extraneous bytes before a marker");
  }

  void read_scan() {
    if (!have_frame) throw Error("SOS before SOF");
    int ns = byte();
    if (ns != static_cast<int>(comps.size()))
      throw Error("multi-scan (non-interleaved) JPEG is not supported");
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      Component& c = comps[i];
      if (c.id != id) throw Error("scan components out of frame order");
      c.td = t >> 4;
      c.ta = t & 15;
      if (c.td > 3 || c.ta > 3 || !dc[c.td].defined || !ac[c.ta].defined)
        throw Error("scan uses an undefined Huffman table");
      if (!have_quant[c.tq]) throw Error("frame uses an undefined quantisation table");
    }
    int ss = byte(), se = byte(), a = byte();
    if (ss != 0 || se != 63 || a != 0) throw Error("bad sequential scan parameters");

    bool single = ns == 1;
    int mcux, mcuy;
    if (single) {  // one block per MCU over the component's own plane
      mcux = (comps[0].dw + 7) / 8;
      mcuy = (comps[0].dh + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    for (auto& c : comps) {
      c.bw = single ? mcux : mcux * c.h;
      c.bh = single ? mcuy : mcuy * c.v;
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
      c.pred = 0;
    }
    BitReader br{data + pos, data + size};
    int16_t blk[64];
    int total = mcux * mcuy, next_rst = 0;
    for (int m = 0; m < total; m++) {
      if (restart_interval && m && m % restart_interval == 0) {
        to_marker(br);
        int marker = next_marker();
        if (marker != 0xD0 + next_rst) throw Error("corrupt JPEG data: restart marker out of sequence");
        next_rst = (next_rst + 1) & 7;
        br.reset();
        br.p = data + pos;
        for (auto& c : comps) c.pred = 0;
      }
      int mx = m % mcux, my = m / mcux;
      for (auto& c : comps) {
        int nh = single ? 1 : c.h, nv = single ? 1 : c.v;
        const uint16_t* q = quant[c.tq];
        size_t stride = static_cast<size_t>(c.bw) * 8;
        for (int by = 0; by < nv; by++)
          for (int bx = 0; bx < nh; bx++) {
            decode_block(br, c, blk);
            size_t row = (static_cast<size_t>(my) * nv + by) * 8, col = (static_cast<size_t>(mx) * nh + bx) * 8;
            idct_islow(blk, q, c.plane.data() + row * stride + col, static_cast<int>(stride));
          }
      }
      br.check();
    }
    to_marker(br);
    done = true;
  }

  void parse() {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8) throw Error("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) {  // EOI
        if (!done) throw Error("JPEG without image data");
        return;
      }
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) throw Error("unexpected JPEG marker");
      size_t len = u16();
      if (len < 2 || pos + len - 2 > size) throw Error("truncated JPEG");
      size_t end = pos + len - 2;
      if (m == 0xC0) {
        read_sof();
      } else if (m == 0xC1) {
        throw Error("extended sequential (SOF1) JPEG is not supported");
      } else if (m == 0xC2 || m == 0xC6) {
        throw Error("progressive JPEG is not supported");
      } else if (m == 0xC3 || m == 0xC7) {
        throw Error("lossless JPEG is not supported");
      } else if (m == 0xC5) {
        throw Error("hierarchical JPEG is not supported");
      } else if (m >= 0xC9 && m <= 0xCF) {  // SOF9-SOF15 and DAC (0xCC)
        throw Error("arithmetic-coded JPEG is not supported");
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xDD) {
        restart_interval = u16();
      } else if (m == 0xDA) {
        if (done) throw Error("multi-scan JPEG is not supported");
        if (headers_only) {
          if (!have_frame) throw Error("SOS before SOF");
          return;
        }
        read_scan();
        continue;  // pos is at the marker after the scan
      } else if (m == 0xDC) {
        throw Error("DNL marker is not supported");
      } else if (m == 0xE0) {
        if (len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0) saw_jfif = true;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = data[pos + 11];
        }
      }
      if (pos > end) throw Error("corrupt JPEG marker segment");
      pos = end;
    }
  }

  void check_colour() const {
    if (comps.size() != 3 || saw_jfif) return;
    bool rgb = saw_adobe ? adobe_transform == 0
                         : (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
    if (rgb) throw Error("RGB-coded JPEG is not supported");
  }

  void write(uint8_t* out) const {
    if (comps.size() == 1) {
      const Component& c = comps[0];
      for (int y = 0; y < height; y++)
        std::memcpy(out + static_cast<size_t>(y) * width, c.plane.data() + static_cast<size_t>(y) * c.bw * 8, width);
      return;
    }
    std::vector<uint8_t> up[3];
    for (int i = 0; i < 3; i++) up[i].resize(static_cast<size_t>(width) + 16);
    const uint8_t* rows[3];
    for (int y = 0; y < height; y++) {
      for (int i = 0; i < 3; i++) {
        const Component& c = comps[i];
        size_t stride = static_cast<size_t>(c.bw) * 8;
        int rh = hmax / c.h, rv = vmax / c.v;
        if (rh == 1) {
          rows[i] = c.plane.data() + static_cast<size_t>(y) * stride;
          continue;
        }
        int cy = rv == 2 ? y / 2 : y;
        int fy = cy;
        if (rv == 2) fy = (y & 1) ? std::min(cy + 1, c.dh - 1) : std::max(cy - 1, 0);
        cy = std::min(cy, c.dh - 1);
        const uint8_t* near = c.plane.data() + static_cast<size_t>(cy) * stride;
        const uint8_t* far = c.plane.data() + static_cast<size_t>(fy) * stride;
        upsample_row(near, far, c.dw, rv == 2, up[i].data());
        rows[i] = up[i].data();
      }
      uint8_t* o = out + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; x++) {
        int yy = rows[0][x], cb = rows[1][x], cr = rows[2][x];
        o[3 * x] = clamp255(yy + kColor.cr_r[cr]);
        o[3 * x + 1] = clamp255(yy + static_cast<int>((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(yy + kColor.cb_b[cb]);
      }
    }
  }
};

void set_error(const char* msg, char* err, int errlen) {
  if (errlen > 0) std::snprintf(err, errlen, "%s", msg);
}

}  // namespace

extern "C" {

// Height, width and channels (1 or 3) of a JPEG stream from its headers;
// 0 on success, else -1 with a message in `err`.
int jpeg_info(const uint8_t* data, int64_t size, int* height, int* width, int* channels, char* err, int errlen) {
  try {
    Jpeg j(data, static_cast<size_t>(size));
    j.headers_only = true;
    j.parse();
    j.check_colour();
    *height = j.height;
    *width = j.width;
    *channels = static_cast<int>(j.comps.size());
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what(), err, errlen);
    return -1;
  }
}

// Decode into `out` ((height, width) gray or (height, width, 3) RGB uint8,
// `out_size` bytes); 0 on success, else -1 with a message in `err`.
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size, char* err, int errlen) {
  try {
    Jpeg j(data, static_cast<size_t>(size));
    j.parse();
    j.check_colour();
    if (out_size != static_cast<int64_t>(j.height) * j.width * static_cast<int64_t>(j.comps.size()))
      throw Error("output buffer of the wrong size");
    j.write(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(e.what(), err, errlen);
    return -1;
  }
}
}
