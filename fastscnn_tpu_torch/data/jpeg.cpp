// JPEG decoding and encoding on the host, for the port's data path.
//
// Written from ITU-T T.81 and libjpeg's documented integer algorithms, so
// that the decoder's pixels equal those of libjpeg-turbo at its defaults
// (the islow IDCT, fancy upsampling), which is what Pillow decodes with,
// and the encoder's bytes equal what Pillow writes through libjpeg-turbo
// for ``Image.fromarray(a).save(f, "JPEG", quality=q)``.
//
// Decoder: SOF0, SOF1 and SOF2 (baseline, extended-sequential and
// progressive Huffman), SOF9 and SOF10 (sequential and progressive
// arithmetic coding, with DAC conditioning) and SOF3 (lossless Huffman:
// predictors 1-7, point transform), 8-bit samples, 1, 3 (YCbCr or RGB) or 4
// components (CMYK or YCCK, given as Pillow's Adobe-inverted CMYK), every
// whole sampling ratio of factors 1-4 with libjpeg-turbo's upsampling for
// it, restart intervals and fill bytes. Everything libjpeg-turbo or Pillow
// refuses (12/16-bit samples, hierarchical frames, lossless arithmetic
// coding, 2 components, fractional sampling ratios, a DNL height, truncated
// or corrupt scans) is refused with a message naming the variant.
//
// Encoder: baseline, quality scaling of the T.81 Annex K tables as
// jpeg_set_quality(q, force_baseline=TRUE) does, 4:2:0 YCbCr for RGB and
// one component for L, the Annex K Huffman tables and a JFIF 1.01 APP0.
//
// C interface (ctypes): every function takes an error buffer and returns a
// negative value on failure with the message written there. The caller owns
// every pixel and byte buffer: it reads the size with jc_info first.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

// natural (row-major) index of the k-th coefficient in zigzag order, with
// 16 extra entries of 63 so that a run past the block's end stays in bounds
struct Zigzag {
  int natural[80];
  Zigzag() {
    int k = 0;
    for (int s = 0; s < 15; ++s) {
      int lo = std::max(0, s - 7), hi = std::min(s, 7);
      if (s % 2 == 0)
        for (int r = hi; r >= lo; --r) natural[k++] = r * 8 + (s - r);
      else
        for (int r = lo; r <= hi; ++r) natural[k++] = r * 8 + (s - r);
    }
    for (; k < 80; ++k) natural[k] = 63;
  }
};
const Zigzag kZigzag;

inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// ---------------------------------------------------------------------------
// Shared fixed-point constants of libjpeg's islow DCTs (jfdctint.c and
// jidctint.c): CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// ---------------------------------------------------------------------------
// Decoder

struct HuffTable {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[512] = {};  // 9-bit lookahead: (length << 8) | value, 0 when longer

  void build() {
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) fail("corrupt Huffman table");  // no code is all ones
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; ++l)
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int base = huffcode[p] << (9 - l);
        for (int fill = 0; fill < (1 << (9 - l)); ++fill)
          look[base | fill] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    defined = true;
  }
};

// Entropy-coded data: bytes 0xFF 0x00 are a data byte 0xFF, any other 0xFF
// (after optional fill bytes 0xFF) starts a marker, where reading stops and
// zero bits are fed instead. Consuming a fed bit means the scan ran past its
// data: truncated or corrupt.
struct BitReader {
  const uint8_t* d;
  size_t pos, end;
  uint64_t acc = 0;
  int bits = 0;
  int fake = 0;
  bool at_marker = false;

  BitReader(const uint8_t* data, size_t p, size_t n) : d(data), pos(p), end(n) {}

  void reset(size_t p) {
    pos = p;
    acc = 0;
    bits = 0;
    fake = 0;
    at_marker = false;
  }

  void fill() {
    while (bits <= 56) {
      uint32_t b;
      if (at_marker) {
        b = 0;
        fake += 8;
      } else if (pos >= end) {
        at_marker = true;
        continue;
      } else {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < end && d[q] == 0xFF) ++q;
          if (q < end && d[q] == 0x00) {
            pos = q + 1;
          } else {
            pos = q - 1;  // at the 0xFF before the marker's code
            at_marker = true;
            continue;
          }
        } else {
          ++pos;
        }
      }
      acc = (acc << 8) | b;
      bits += 8;
    }
  }

  inline void consume(int n) {
    bits -= n;
    if (bits < fake) fail("truncated or corrupt scan: the entropy-coded data ends early");
  }

  inline uint32_t peek16() {
    if (bits < 16) fill();
    return static_cast<uint32_t>(acc >> (bits - 16)) & 0xFFFF;
  }

  inline int get(int n) {
    if (n == 0) return 0;
    if (bits < n) fill();
    int v = static_cast<int>((acc >> (bits - n)) & ((1u << n) - 1));
    consume(n);
    return v;
  }

  inline int decode(const HuffTable& t) {
    uint32_t p = peek16();
    int e = t.look[p >> 7];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int32_t code = static_cast<int32_t>(p >> (16 - l));
      if (code <= t.maxcode[l]) {
        consume(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    fail("corrupt scan: a Huffman code that the table does not hold");
  }

  // position of the next marker's first 0xFF, skipping what is left
  size_t marker_pos() const {
    size_t q = pos;
    while (q + 1 < end && !(d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF)) ++q;
    return q;
  }
};

// HUFF_EXTEND: the s-bit magnitude category value x as a signed number
inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

// T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | next MPS << 8 |
// switch << 7 | next LPS; entry 113 is the fixed 0.5 estimate of signs and
// refinement bits
#define QE(q, lps, mps, sw) ((uint32_t(q) << 16) | (uint32_t(mps) << 8) | ((sw) << 7) | (lps))
const uint32_t kAriTab[114] = {
    QE(0x5a1d, 1, 1, 1),     QE(0x2586, 14, 2, 0),    QE(0x1114, 16, 3, 0),
    QE(0x080b, 18, 4, 0),    QE(0x03d8, 20, 5, 0),    QE(0x01da, 23, 6, 0),
    QE(0x00e5, 25, 7, 0),    QE(0x006f, 28, 8, 0),    QE(0x0036, 30, 9, 0),
    QE(0x001a, 33, 10, 0),   QE(0x000d, 35, 11, 0),   QE(0x0006, 9, 12, 0),
    QE(0x0003, 10, 13, 0),   QE(0x0001, 12, 13, 0),   QE(0x5a7f, 15, 15, 1),
    QE(0x3f25, 36, 16, 0),   QE(0x2cf2, 38, 17, 0),   QE(0x207c, 39, 18, 0),
    QE(0x17b9, 40, 19, 0),   QE(0x1182, 42, 20, 0),   QE(0x0cef, 43, 21, 0),
    QE(0x09a1, 45, 22, 0),   QE(0x072f, 46, 23, 0),   QE(0x055c, 48, 24, 0),
    QE(0x0406, 49, 25, 0),   QE(0x0303, 51, 26, 0),   QE(0x0240, 52, 27, 0),
    QE(0x01b1, 54, 28, 0),   QE(0x0144, 56, 29, 0),   QE(0x00f5, 57, 30, 0),
    QE(0x00b7, 59, 31, 0),   QE(0x008a, 60, 32, 0),   QE(0x0068, 62, 33, 0),
    QE(0x004e, 63, 34, 0),   QE(0x003b, 32, 35, 0),   QE(0x002c, 33, 9, 0),
    QE(0x5ae1, 37, 37, 1),   QE(0x484c, 64, 38, 0),   QE(0x3a0d, 65, 39, 0),
    QE(0x2ef1, 67, 40, 0),   QE(0x261f, 68, 41, 0),   QE(0x1f33, 69, 42, 0),
    QE(0x19a8, 70, 43, 0),   QE(0x1518, 72, 44, 0),   QE(0x1177, 73, 45, 0),
    QE(0x0e74, 74, 46, 0),   QE(0x0bfb, 75, 47, 0),   QE(0x09f8, 77, 48, 0),
    QE(0x0861, 78, 49, 0),   QE(0x0706, 79, 50, 0),   QE(0x05cd, 48, 51, 0),
    QE(0x04de, 50, 52, 0),   QE(0x040f, 50, 53, 0),   QE(0x0363, 51, 54, 0),
    QE(0x02d4, 52, 55, 0),   QE(0x025c, 53, 56, 0),   QE(0x01f8, 54, 57, 0),
    QE(0x01a4, 55, 58, 0),   QE(0x0160, 56, 59, 0),   QE(0x0125, 57, 60, 0),
    QE(0x00f6, 58, 61, 0),   QE(0x00cb, 59, 62, 0),   QE(0x00ab, 61, 63, 0),
    QE(0x008f, 61, 32, 0),   QE(0x5b12, 65, 65, 1),   QE(0x4d04, 80, 66, 0),
    QE(0x412c, 81, 67, 0),   QE(0x37d8, 82, 68, 0),   QE(0x2fe8, 83, 69, 0),
    QE(0x293c, 84, 70, 0),   QE(0x2379, 86, 71, 0),   QE(0x1edf, 87, 72, 0),
    QE(0x1aa9, 87, 73, 0),   QE(0x174e, 72, 74, 0),   QE(0x1424, 72, 75, 0),
    QE(0x119c, 74, 76, 0),   QE(0x0f6b, 74, 77, 0),   QE(0x0d51, 75, 78, 0),
    QE(0x0bb6, 77, 79, 0),   QE(0x0a40, 77, 48, 0),   QE(0x5832, 80, 81, 1),
    QE(0x4d1c, 88, 82, 0),   QE(0x438e, 89, 83, 0),   QE(0x3bdd, 90, 84, 0),
    QE(0x34ee, 91, 85, 0),   QE(0x2eae, 92, 86, 0),   QE(0x299a, 93, 87, 0),
    QE(0x2516, 86, 71, 0),   QE(0x5570, 88, 89, 1),   QE(0x4ca9, 95, 90, 0),
    QE(0x44d9, 96, 91, 0),   QE(0x3e22, 97, 92, 0),   QE(0x3824, 99, 93, 0),
    QE(0x32b4, 99, 94, 0),   QE(0x2e17, 93, 86, 0),   QE(0x56a8, 95, 96, 1),
    QE(0x4f46, 101, 97, 0),  QE(0x47e5, 102, 98, 0),  QE(0x41cf, 103, 99, 0),
    QE(0x3c3d, 104, 100, 0), QE(0x375e, 99, 93, 0),   QE(0x5231, 105, 102, 0),
    QE(0x4c0f, 106, 103, 0), QE(0x4639, 107, 104, 0), QE(0x415e, 103, 99, 0),
    QE(0x5627, 105, 106, 1), QE(0x50e7, 108, 107, 0), QE(0x4b85, 109, 103, 0),
    QE(0x5597, 110, 109, 0), QE(0x504f, 111, 107, 0), QE(0x5a10, 110, 111, 1),
    QE(0x5522, 112, 109, 0), QE(0x59eb, 112, 111, 1), QE(0x5a1d, 113, 113, 0)};
#undef QE

// The QM decoder of T.81 Annex D as jdarith.c runs it: a marker met inside
// the data is legal and feeds zero bytes from there on
struct ArithReader {
  const uint8_t* d;
  size_t pos, end;
  int64_t a = 0, c = 0;
  int ct = -16;
  bool at_marker = false;

  ArithReader(const uint8_t* data, size_t p, size_t n) : d(data), pos(p), end(n) {}

  void reset(size_t p) {
    pos = p;
    a = c = 0;
    ct = -16;
    at_marker = false;
  }

  int next_byte() {
    if (at_marker || pos >= end) {
      at_marker = true;
      return 0;
    }
    int b = d[pos];
    if (b != 0xFF) {
      ++pos;
      return b;
    }
    size_t q = pos + 1;
    while (q < end && d[q] == 0xFF) ++q;
    if (q < end && d[q] == 0x00) {
      pos = q + 1;
      return 0xFF;
    }
    pos = q - 1;  // at the 0xFF before the marker's code
    at_marker = true;
    return 0;
  }

  inline int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | next_byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes in: A becomes 0x10000 below
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - static_cast<int64_t>(qe);
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < static_cast<int64_t>(qe)) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < static_cast<int64_t>(qe)) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  size_t marker_pos() const {
    size_t q = pos;
    while (q + 1 < end && !(d[q] == 0xFF && d[q + 1] != 0x00 && d[q + 1] != 0xFF)) ++q;
    return q;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int dw = 0, dh = 0;          // downsampled_width/height: real samples
  int wblocks = 0, hblocks = 0;  // blocks holding real samples
  int bw = 0, bh = 0;          // blocks allocated: whole MCUs
  int pred = 0;                // last DC value (Huffman) or last_dc_val (arithmetic)
  int dc_context = 0;          // arithmetic DC conditioning category
  bool scanned = false;
  bool latched = false;
  uint16_t q[64] = {};         // quantization table, natural order, latched at the first scan
  std::vector<int16_t> coef;   // bh * bw blocks of 64 coefficients, natural order
  std::vector<uint8_t> plane;  // the samples: wblocks*8 x hblocks*8 after the IDCT, or
                               // bw x bh of a lossless frame
  int stride = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  // parse up to the first scan header: width, height and channels
  void header() { run(true); }

  void decode(uint8_t* out) {
    run(false);
    finish(out);
  }

  int width = 0, height = 0, channels = 0;

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  uint16_t qt_[4][64] = {};
  bool qt_def_[4] = {};
  HuffTable dc_[4], ac_[4];
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];  // arithmetic conditioning (DAC)
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  bool frame_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  bool eoi_ = false, any_scan_ = false;
  bool rgb_ = false;   // three components that hold R, G, B (no YCbCr transform)
  bool ycck_ = false;  // four components that hold Y, Cb, Cr, K
  int ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  Component comp_[4];
  int eobrun_ = 0;
  bool arith_error_ = false;  // jdarith's ct == -1: the rest of the interval decodes nothing

  int u16(size_t p) const {
    if (p + 2 > n_) fail("truncated file: a marker segment ends early");
    return (d_[p] << 8) | d_[p + 1];
  }

  // next marker code from pos_, skipping anything before it; -1 at the end
  int next_marker() {
    while (pos_ < n_ && d_[pos_] != 0xFF) ++pos_;
    while (pos_ < n_ && d_[pos_] == 0xFF) ++pos_;
    if (pos_ >= n_) return -1;
    return d_[pos_++];
  }

  void run(bool header_only) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    std::memset(dac_l_, 0, sizeof(dac_l_));
    std::memset(dac_u_, 1, sizeof(dac_u_));
    std::memset(dac_k_, 5, sizeof(dac_k_));
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0) break;
      if (m == 0xD9) {
        eoi_ = true;
        break;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // stray RSTn or TEM
      if (m == 0xD8) fail("corrupt file: a second SOI marker");
      int len = u16(pos_);
      if (len < 2 || pos_ + len > n_) fail("truncated file: a marker segment ends early");
      size_t body = pos_ + 2, bend = pos_ + len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA:
          frame(m, body, bend);
          break;
        case 0xCB: fail("lossless arithmetic-coded JPEG (SOF11)");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: case 0xDE: case 0xDF:
          fail("hierarchical JPEG (SOF5-SOF7, SOF13-SOF15, DHP, EXP)");
        case 0xC4: dht(body, bend); break;
        case 0xCC: dac(body, bend); break;
        case 0xDB: dqt(body, bend); break;
        case 0xDD:
          if (len < 4) fail("corrupt DRI marker");
          restart_interval_ = u16(body);
          break;
        case 0xDC: fail("a DNL marker (height given after the first scan)");
        case 0xE0: app0(body, bend); break;
        case 0xEE: app14(body, bend); break;
        case 0xDA:
          if (!frame_) fail("corrupt file: a scan before the frame header");
          if (!any_scan_) colour_space();
          if (header_only) return;
          pos_ = bend;
          scan(body, bend);
          any_scan_ = true;
          continue;
        default:
          break;  // APPn, COM, JPGn: skipped
      }
      pos_ = bend;
    }
    if (!frame_) fail("no frame header (SOF marker)");
    if (header_only) fail("truncated file: no scan");
    if (!any_scan_) fail("truncated file: no scan");
    for (int c = 0; c < ncomp_; ++c)
      if (!comp_[c].scanned) fail("truncated file: a component has no scan");
    if (!eoi_) fail("truncated file: no EOI marker after the last scan");
  }

  void app0(size_t b, size_t e) {
    if (e - b >= 14 && d_[b] == 'J' && d_[b + 1] == 'F' && d_[b + 2] == 'I' && d_[b + 3] == 'F' &&
        d_[b + 4] == 0)
      jfif_ = true;
  }

  void app14(size_t b, size_t e) {
    if (e - b >= 12 && std::memcmp(d_ + b, "Adobe", 5) == 0) {
      adobe_ = true;
      adobe_transform_ = d_[b + 11];
    }
  }

  void dqt(size_t p, size_t e) {
    while (p < e) {
      int pq = d_[p] >> 4, tq = d_[p] & 15;
      ++p;
      if (pq > 1 || tq > 3) fail("corrupt DQT marker");
      size_t need = pq ? 128 : 64;
      if (p + need > e) fail("corrupt DQT marker");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (d_[p + 2 * k] << 8) | d_[p + 2 * k + 1] : d_[p + k];
        qt_[tq][kZigzag.natural[k]] = static_cast<uint16_t>(v);
      }
      qt_def_[tq] = true;
      p += need;
    }
  }

  void dht(size_t p, size_t e) {
    while (p < e) {
      if (p + 17 > e) fail("corrupt DHT marker");
      int tc = d_[p] >> 4, th = d_[p] & 15;
      if (tc > 1 || th > 3) fail("corrupt DHT marker");
      HuffTable& t = tc ? ac_[th] : dc_[th];
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        t.bits[l] = d_[p + l];
        count += t.bits[l];
      }
      p += 17;
      if (count > 256 || p + count > e) fail("corrupt DHT marker");
      std::memset(t.vals, 0, sizeof(t.vals));
      std::memcpy(t.vals, d_ + p, count);
      p += count;
      if (tc == 0)
        for (int i = 0; i < count; ++i)
          if (t.vals[i] > 16) fail("corrupt DHT marker");
      t.build();
    }
  }

  // jdmarker.c's get_dac: index < 16 a DC table's L (low nibble) and U,
  // index 16..31 an AC table's Kx
  void dac(size_t p, size_t e) {
    for (; p + 2 <= e; p += 2) {
      int index = d_[p], val = d_[p + 1];
      if (index >= 32) fail("corrupt DAC marker");
      if (index >= 16) {
        dac_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dac_l_[index] = static_cast<uint8_t>(val & 15);
        dac_u_[index] = static_cast<uint8_t>(val >> 4);
        if (dac_l_[index] > dac_u_[index]) fail("corrupt DAC marker: L above U");
      }
    }
    if (p != e) fail("corrupt DAC marker");
  }

  void frame(int m, size_t p, size_t e) {
    if (frame_) fail("corrupt file: a second frame header");
    if (e - p < 6) fail("corrupt frame header");
    int precision = d_[p];
    if (precision != 8) fail(std::to_string(precision) + "-bit samples (only 8-bit samples are read)");
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp_ = d_[p + 5];
    if (height == 0) fail("a DNL marker (height given after the first scan)");
    if (width == 0) fail("corrupt frame header: width 0");
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
      fail(std::to_string(ncomp_) + " components (only 1, 3 and 4 are read)");
    if (e - p < static_cast<size_t>(6 + 3 * ncomp_)) fail("corrupt frame header");
    progressive_ = (m == 0xC2 || m == 0xCA);
    arith_ = (m == 0xC9 || m == 0xCA);
    lossless_ = (m == 0xC3);
    hmax_ = vmax_ = 1;
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.id = d_[p + 6 + 3 * c];
      k.h = d_[p + 7 + 3 * c] >> 4;
      k.v = d_[p + 7 + 3 * c] & 15;
      k.tq = d_[p + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) fail("corrupt frame header");
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
    }
    // jdsample.c upsamples by whole ratios only; a lossless frame of several
    // components is read at 1x1 sampling alone
    for (int c = 0; c < ncomp_; ++c) {
      const Component& k = comp_[c];
      bool fractional = hmax_ % k.h || vmax_ % k.v;
      if (fractional || (lossless_ && ncomp_ > 1 && (k.h != 1 || k.v != 1))) {
        std::string s = "sampling factors";
        for (int i = 0; i < ncomp_; ++i)
          s += std::string(i ? ", " : " ") + std::to_string(comp_[i].h) + "x" +
               std::to_string(comp_[i].v);
        fail(s + (fractional ? " (a fractional upsampling ratio)"
                             : " in a lossless frame of several components (only 1x1 is read)"));
      }
    }
    int bs = lossless_ ? 1 : 8;  // samples a block side: a lossless "block" is one sample
    mcux_ = (width + bs * hmax_ - 1) / (bs * hmax_);
    mcuy_ = (height + bs * vmax_ - 1) / (bs * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& k = comp_[c];
      k.dw = static_cast<int>((static_cast<int64_t>(width) * k.h + hmax_ - 1) / hmax_);
      k.dh = static_cast<int>((static_cast<int64_t>(height) * k.v + vmax_ - 1) / vmax_);
      k.wblocks = (k.dw + bs - 1) / bs;
      k.hblocks = (k.dh + bs - 1) / bs;
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
    }
    channels = ncomp_;
    frame_ = true;
  }

  // libjpeg's default_decompress_parms: three components are YCbCr under
  // JFIF, RGB under an Adobe APP14 transform 0 or ids 'R','G','B', else
  // YCbCr; four are YCCK under an Adobe transform other than 0, else CMYK
  void colour_space() {
    if (ncomp_ == 3) {
      if (jfif_) rgb_ = false;
      else if (adobe_) rgb_ = (adobe_transform_ == 0);
      else rgb_ = (comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B');
      if (lossless_ && !rgb_) fail("a lossless YCbCr frame (no colour conversion of lossless data)");
    } else if (ncomp_ == 4) {
      ycck_ = adobe_ && adobe_transform_ != 0;
      if (lossless_ && ycck_) fail("a lossless YCCK frame (no colour conversion of lossless data)");
    }
  }

  void scan(size_t p, size_t e) {
    if (e - p < 1) fail("corrupt scan header");
    int ns = d_[p];
    if (ns < 1 || ns > ncomp_ || e - p < static_cast<size_t>(4 + 2 * ns)) fail("corrupt scan header");
    Component* cs[4];
    for (int i = 0; i < ns; ++i) {
      int id = d_[p + 1 + 2 * i], tbl = d_[p + 2 + 2 * i];
      Component* k = nullptr;
      for (int c = 0; c < ncomp_; ++c)
        if (comp_[c].id == id) k = &comp_[c];
      if (!k) fail("corrupt scan header: an unknown component");
      for (int j = 0; j < i; ++j)
        if (cs[j] == k) fail("corrupt scan header: a component twice");
      k->dc_tbl = tbl >> 4;
      k->ac_tbl = tbl & 15;
      if (!arith_ && (k->dc_tbl > 3 || k->ac_tbl > 3)) fail("corrupt scan header");
      cs[i] = k;
    }
    size_t q = p + 1 + 2 * ns;
    int ss = d_[q], se = d_[q + 1], ah = d_[q + 2] >> 4, al = d_[q + 2] & 15;
    if (lossless_) {
      if (ss < 1 || ss > 7 || al > 7) fail("corrupt lossless scan: predictor " + std::to_string(ss));
      lossless_scan(cs, ns, ss, al);
      return;
    }
    if (progressive_) {
      bool bad = ss > 63 || se > 63 || se < ss || al > 13 || (ss == 0 && se != 0) ||
                 (ss > 0 && ns != 1) || (ah != 0 && ah != al + 1);
      if (bad) fail("corrupt progressive scan parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += cs[i]->h * cs[i]->v;
      if (blocks > 10) fail("corrupt scan header: too many blocks in an MCU");
    }
    bool need_dc = ss == 0 && ah == 0, need_ac = ss > 0 || !progressive_;
    for (int i = 0; i < ns; ++i) {
      Component* k = cs[i];
      if (!k->latched) {
        if (!qt_def_[k->tq]) fail("corrupt file: a quantization table is missing");
        std::memcpy(k->q, qt_[k->tq], sizeof(k->q));
        k->latched = true;
      }
      if (!arith_ && ((need_dc && !dc_[k->dc_tbl].defined) || (need_ac && !ac_[k->ac_tbl].defined)))
        fail("corrupt file: a Huffman table is missing");
      k->pred = 0;
      k->dc_context = 0;
      k->scanned = true;
      if (k->coef.empty()) k->coef.assign(static_cast<size_t>(k->bw) * k->bh * 64, 0);
    }
    if (arith_) {
      arith_scan(cs, ns, ss, se, ah, al);
      return;
    }

    BitReader br(d_, pos_, n_);
    eobrun_ = 0;
    int next_rst = 0;
    int64_t total = ns == 1 ? static_cast<int64_t>(cs[0]->wblocks) * cs[0]->hblocks
                            : static_cast<int64_t>(mcux_) * mcuy_;
    int togo = restart_interval_;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_) {
        if (togo == 0) {
          size_t mp = br.marker_pos();
          if (mp + 1 >= n_ || d_[mp + 1] != 0xD0 + next_rst)
            fail("corrupt scan: a restart marker is missing or out of order");
          br.reset(mp + 2);
          next_rst = (next_rst + 1) & 7;
          for (int i = 0; i < ns; ++i) cs[i]->pred = 0;
          eobrun_ = 0;
          togo = restart_interval_;
        }
        --togo;
      }
      for_mcu_blocks(cs, ns, m, [&](Component& k, int16_t* c) { block(br, k, c, ss, se, ah, al); });
    }
    pos_ = br.marker_pos();
  }

  // the blocks of an MCU, in coding order: (component, coefficient block)
  template <typename F>
  void for_mcu_blocks(Component** cs, int ns, int64_t m, F&& f) {
    int per_row = ns == 1 ? cs[0]->wblocks : mcux_;
    int my = static_cast<int>(m / per_row), mx = static_cast<int>(m % per_row);
    if (ns == 1) {
      Component* k = cs[0];
      f(*k, &k->coef[(static_cast<size_t>(my) * k->bw + mx) * 64]);
      return;
    }
    for (int i = 0; i < ns; ++i) {
      Component* k = cs[i];
      for (int v = 0; v < k->v; ++v)
        for (int h = 0; h < k->h; ++h)
          f(*k, &k->coef[(static_cast<size_t>(my * k->v + v) * k->bw + mx * k->h + h) * 64]);
    }
  }

  // jdarith.c's start_pass and process_restart: zero the statistics the
  // scan uses and the DC predictions
  void arith_reset(Component** cs, int ns, int ss, int se, int ah) {
    for (int i = 0; i < ns; ++i) {
      if (!progressive_ || (ss == 0 && ah == 0)) {
        std::memset(dc_stats_[cs[i]->dc_tbl], 0, 64);
        cs[i]->pred = 0;
        cs[i]->dc_context = 0;
      }
      if (!progressive_ || se) std::memset(ac_stats_[cs[i]->ac_tbl], 0, 256);
    }
    arith_error_ = false;
  }

  void arith_scan(Component** cs, int ns, int ss, int se, int ah, int al) {
    ArithReader ar(d_, pos_, n_);
    arith_reset(cs, ns, ss, se, ah);
    int64_t total = ns == 1 ? static_cast<int64_t>(cs[0]->wblocks) * cs[0]->hblocks
                            : static_cast<int64_t>(mcux_) * mcuy_;
    int next_rst = 0, togo = restart_interval_;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval_) {
        if (togo == 0) {
          size_t mp = ar.marker_pos();
          if (mp + 1 >= n_ || d_[mp + 1] != 0xD0 + next_rst)
            fail("corrupt scan: a restart marker is missing or out of order");
          ar.reset(mp + 2);
          next_rst = (next_rst + 1) & 7;
          arith_reset(cs, ns, ss, se, ah);
          togo = restart_interval_;
        }
        --togo;
      }
      if (arith_error_) continue;
      for_mcu_blocks(cs, ns, m, [&](Component& k, int16_t* c) {
        if (arith_error_) return;
        if (!progressive_) {
          arith_dc(ar, k, c, 0);
          if (!arith_error_) arith_ac_first(ar, k, c, 1, 63, 0);
        } else if (ss == 0 && ah == 0) {
          arith_dc(ar, k, c, al);
        } else if (ss == 0) {
          uint8_t fixed = 113;
          if (ar.decode(&fixed)) c[0] = static_cast<int16_t>(c[0] | (1 << al));
        } else if (ah == 0) {
          arith_ac_first(ar, k, c, ss, se, al);
        } else {
          arith_ac_refine(ar, k, c, ss, se, al);
        }
      });
    }
    pos_ = ar.marker_pos();
  }

  // Figures F.19-F.24: a DC difference, its conditioning category, the DC
  // value (scaled by al in a progressive first scan)
  void arith_dc(ArithReader& ar, Component& k, int16_t* c, int al) {
    int tbl = k.dc_tbl;
    uint8_t* st = dc_stats_[tbl] + k.dc_context;
    if (ar.decode(st) == 0) {
      k.dc_context = 0;
    } else {
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = dc_stats_[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            arith_error_ = true;  // magnitude overflow
            return;
          }
          st += 1;
        }
      }
      if (m < static_cast<int>((1L << dac_l_[tbl]) >> 1))
        k.dc_context = 0;
      else if (m > static_cast<int>((1L << dac_u_[tbl]) >> 1))
        k.dc_context = 12 + sign * 4;
      else
        k.dc_context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      k.pred = progressive_ ? k.pred + v : (k.pred + v) & 0xFFFF;
    }
    c[0] = static_cast<int16_t>(progressive_ ? static_cast<int>(static_cast<unsigned>(k.pred) << al)
                                             : k.pred);
  }

  // Figure F.20 (and G.1.3.2): the AC values ss..se, scaled by al
  void arith_ac_first(ArithReader& ar, Component& k, int16_t* c, int ss, int se, int al) {
    int tbl = k.ac_tbl;
    uint8_t fixed = 113;
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = ac_stats_[tbl] + 3 * (i - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        ++i;
        if (i > se) {
          arith_error_ = true;  // spectral overflow
          return;
        }
      }
      int sign = ar.decode(&fixed);
      st += 2;
      int m = ar.decode(st);
      if (m != 0) {
        if (ar.decode(st)) {
          m <<= 1;
          st = ac_stats_[tbl] + (i <= dac_k_[tbl] ? 189 : 217);
          while (ar.decode(st)) {
            if ((m <<= 1) == 0x8000) {
              arith_error_ = true;  // magnitude overflow
              return;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c[kZigzag.natural[i]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
  }

  // Figure G.10's decoder (jdarith.c's decode_mcu_AC_refine)
  void arith_ac_refine(ArithReader& ar, Component& k, int16_t* c, int ss, int se, int al) {
    int tbl = k.ac_tbl;
    uint8_t fixed = 113;
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (c[kZigzag.natural[kex]]) break;
    for (int i = ss; i <= se; ++i) {
      uint8_t* st = ac_stats_[tbl] + 3 * (i - 1);
      if (i > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* th = c + kZigzag.natural[i];
        if (*th) {
          if (ar.decode(st + 2)) *th = static_cast<int16_t>(*th < 0 ? *th + m1 : *th + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          *th = static_cast<int16_t>(ar.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        ++i;
        if (i > se) {
          arith_error_ = true;  // spectral overflow
          return;
        }
      }
    }
  }

  // A lossless scan (T.81 Annex H, libjpeg-turbo's jdlhuff.c and jdpred.c):
  // Huffman-coded differences, interleaved one sample of each component an
  // MCU, undone row by row with predictor ``psv``; the first row of the scan
  // and of each restart interval predicts from the left (its first sample
  // from 2^(7 - al)), the first column from above.
  void lossless_scan(Component** cs, int ns, int psv, int al) {
    for (int i = 0; i < ns; ++i) {
      Component* k = cs[i];
      if (!dc_[k->dc_tbl].defined) fail("corrupt file: a Huffman table is missing");
      k->scanned = true;
      k->stride = k->bw;
      if (k->plane.empty()) k->plane.assign(static_cast<size_t>(k->bw) * k->bh, 0);
    }
    int per_row = ns == 1 ? cs[0]->wblocks : mcux_;
    int rows = ns == 1 ? cs[0]->hblocks : mcuy_;
    if (restart_interval_ && restart_interval_ % per_row)
      fail("a lossless restart interval that is not whole MCU rows");
    int restart_rows = restart_interval_ / per_row;
    BitReader br(d_, pos_, n_);
    std::vector<int> diff(static_cast<size_t>(per_row) * ns), prev(diff.size()), cur(diff.size());
    int next_rst = 0, togo = restart_rows;
    bool first = true;
    for (int y = 0; y < rows; ++y) {
      if (restart_rows) {
        if (togo == 0) {
          size_t mp = br.marker_pos();
          if (mp + 1 >= n_ || d_[mp + 1] != 0xD0 + next_rst)
            fail("corrupt scan: a restart marker is missing or out of order");
          br.reset(mp + 2);
          next_rst = (next_rst + 1) & 7;
          togo = restart_rows;
          first = true;
        }
        --togo;
      }
      for (int x = 0; x < per_row; ++x)
        for (int i = 0; i < ns; ++i) {
          int s = br.decode(dc_[cs[i]->dc_tbl]);
          int d = 0;
          if (s == 16) d = 32768;
          else if (s > 16) fail("corrupt lossless scan: a difference category above 16");
          else if (s) d = extend(br.get(s), s);
          diff[static_cast<size_t>(i) * per_row + x] = d;
        }
      for (int i = 0; i < ns; ++i) {
        const int* df = &diff[static_cast<size_t>(i) * per_row];
        int* up = &prev[static_cast<size_t>(i) * per_row];
        int* r = &cur[static_cast<size_t>(i) * per_row];
        if (first) {
          int ra = (df[0] + (1 << (7 - al))) & 0xFFFF;
          r[0] = ra;
          for (int x = 1; x < per_row; ++x) r[x] = ra = (df[x] + ra) & 0xFFFF;
        } else {
          r[0] = (df[0] + up[0]) & 0xFFFF;
          for (int x = 1; x < per_row; ++x) {
            int ra = r[x - 1], rb = up[x], rc = up[x - 1], pred;
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
            r[x] = (df[x] + pred) & 0xFFFF;
          }
        }
        uint8_t* out = &cs[i]->plane[static_cast<size_t>(y) * cs[i]->stride];
        for (int x = 0; x < per_row; ++x) out[x] = static_cast<uint8_t>(r[x] << al);
      }
      std::swap(prev, cur);
      first = false;
    }
    pos_ = br.marker_pos();
  }

  void block(BitReader& br, Component& k, int16_t* c, int ss, int se, int ah, int al) {
    const int* nat = kZigzag.natural;
    if (!progressive_) {
      int s = br.decode(dc_[k.dc_tbl]);
      if (s) {
        if (s > 11) fail("corrupt scan: a DC difference out of range");
        s = extend(br.get(s), s);
      }
      k.pred += s;
      c[0] = static_cast<int16_t>(k.pred);
      const HuffTable& t = ac_[k.ac_tbl];
      for (int i = 1; i < 64; ++i) {
        int rs = br.decode(t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          i += r;
          if (i > 63) fail("corrupt scan: a run past the end of a block");
          c[nat[i]] = static_cast<int16_t>(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          i += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans: first, then refinement bits
      if (ah == 0) {
        int s = br.decode(dc_[k.dc_tbl]);
        if (s) {
          if (s > 11) fail("corrupt scan: a DC difference out of range");
          s = extend(br.get(s), s);
        }
        k.pred += s;
        c[0] = static_cast<int16_t>(static_cast<unsigned>(k.pred) << al);
      } else if (br.get(1)) {
        c[0] = static_cast<int16_t>(c[0] | (1 << al));
      }
      return;
    }
    const HuffTable& t = ac_[k.ac_tbl];
    if (ah == 0) {  // AC first pass
      if (eobrun_ > 0) {
        --eobrun_;
        return;
      }
      for (int i = ss; i <= se; ++i) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          i += r;
          if (i > se) fail("corrupt scan: a run past the end of a band");
          c[nat[i]] = static_cast<int16_t>(static_cast<unsigned>(extend(br.get(s), s)) << al);
        } else if (r == 15) {
          i += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get(r);
          --eobrun_;
          break;
        }
      }
      return;
    }
    // AC refinement (libjpeg's decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    if (eobrun_ == 0) {
      for (; i <= se; ++i) {
        int rs = br.decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt scan: a refinement coefficient of size other than 1");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get(r);
          break;
        }
        do {
          int16_t* th = c + nat[i];
          if (*th != 0) {
            if (br.get(1) && (*th & p1) == 0) *th = static_cast<int16_t>(*th >= 0 ? *th + p1 : *th + m1);
          } else {
            if (--r < 0) break;
          }
          ++i;
        } while (i <= se);
        if (s) {
          if (i > se) fail("corrupt scan: a run past the end of a band");
          c[nat[i]] = static_cast<int16_t>(s);
        }
      }
    }
    if (eobrun_ > 0) {
      for (; i <= se; ++i) {
        int16_t* th = c + nat[i];
        if (*th != 0 && br.get(1) && (*th & p1) == 0)
          *th = static_cast<int16_t>(*th >= 0 ? *th + p1 : *th + m1);
      }
      --eobrun_;
    }
  }

  // jidctint.c's jpeg_idct_islow: dequantize, columns (with the DC-only
  // shortcut, which gives what the full pass gives), rows, then descale by
  // CONST_BITS + PASS1_BITS + 3, add 128 and clamp to 0..255 (range_limit)
  static void idct(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
    int ws[64];
    for (int col = 0; col < 8; ++col) {
      const int16_t* ip = in + col;
      const uint16_t* qp = q + col;
      int* wp = ws + col;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dc = static_cast<int>(int64_t(ip[0]) * qp[0] * (1 << PASS1_BITS));
        for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
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
      const int n = CONST_BITS - PASS1_BITS;
      wp[0] = (int)descale(tmp10 + tmp3, n);
      wp[56] = (int)descale(tmp10 - tmp3, n);
      wp[8] = (int)descale(tmp11 + tmp2, n);
      wp[48] = (int)descale(tmp11 - tmp2, n);
      wp[16] = (int)descale(tmp12 + tmp1, n);
      wp[40] = (int)descale(tmp12 - tmp1, n);
      wp[24] = (int)descale(tmp13 + tmp0, n);
      wp[32] = (int)descale(tmp13 - tmp0, n);
    }
    for (int row = 0; row < 8; ++row) {
      const int* wp = ws + row * 8;
      uint8_t* o = out + static_cast<size_t>(row) * stride;
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * FIX_0_541196100;
      int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
      int64_t tmp3 = z1 + z2 * FIX_0_765366865;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << CONST_BITS);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
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
      const int n = CONST_BITS + PASS1_BITS + 3;
      o[0] = static_cast<uint8_t>(clamp255((int)descale(tmp10 + tmp3, n) + 128));
      o[7] = static_cast<uint8_t>(clamp255((int)descale(tmp10 - tmp3, n) + 128));
      o[1] = static_cast<uint8_t>(clamp255((int)descale(tmp11 + tmp2, n) + 128));
      o[6] = static_cast<uint8_t>(clamp255((int)descale(tmp11 - tmp2, n) + 128));
      o[2] = static_cast<uint8_t>(clamp255((int)descale(tmp12 + tmp1, n) + 128));
      o[5] = static_cast<uint8_t>(clamp255((int)descale(tmp12 - tmp1, n) + 128));
      o[3] = static_cast<uint8_t>(clamp255((int)descale(tmp13 + tmp0, n) + 128));
      o[4] = static_cast<uint8_t>(clamp255((int)descale(tmp13 - tmp0, n) + 128));
    }
  }

  // one output row of component k at full resolution into row (>= width
  // samples), as libjpeg-turbo's jdsample.c picks the method by the ratios
  // of the sampling factors: fancy (triangle-filter) upsampling for h2v1,
  // h1v2 and h2v2 (h2v1 and h2v2 only past 2 columns), plain replication
  // otherwise; a lossless frame is never fancy
  void upsample_row(const Component& k, int y, uint8_t* row) const {
    int rh = hmax_ / k.h, rv = vmax_ / k.v;
    const uint8_t* pl = k.plane.data();
    int s = k.stride, dw = k.dw;
    bool fancy = !lossless_;
    if (rh == 1 && rv == 1) {
      std::memcpy(row, pl + static_cast<size_t>(y) * s, width);
      return;
    }
    if (rh == 2 && rv == 1 && fancy && dw > 2) {
      // h2v1 fancy upsampling: 3/4 nearer + 1/4 further, rounding 1 then 2,
      // the edge columns copied
      const uint8_t* in = pl + static_cast<size_t>(y) * s;
      row[0] = in[0];
      row[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        int v = in[x] * 3;
        row[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        row[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      row[2 * dw - 2] = static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = in[dw - 1];
      return;
    }
    int iy = y / rv;
    const uint8_t* in0 = pl + static_cast<size_t>(iy) * s;
    // The context row of a vertical filter: the row above the first and
    // the row below the last real sample row (downsampled_height, not the
    // padded block height) are that row repeated.
    int far = (y & 1) ? std::min(iy + 1, k.dh - 1) : std::max(iy - 1, 0);
    const uint8_t* in1 = pl + static_cast<size_t>(far) * s;
    if (rh == 1 && rv == 2 && fancy) {
      // h1v2 fancy upsampling: 3/4 nearer row + 1/4 further row, rounding 1
      // for the upper output row and 2 for the lower
      int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < dw; ++x) row[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    if (rh == 2 && rv == 2 && fancy && dw > 2) {
      // h2v2 fancy upsampling: column sums 3*nearer row + further row, then
      // 3/4 nearer + 1/4 further column with rounding 8 then 7, edges at
      // downsampled_width
      int thiscol = in0[0] * 3 + in1[0];
      int nextcol = in0[1] * 3 + in1[1];
      row[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
      row[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int x = 1; x < dw - 1; ++x) {
        nextcol = in0[x + 1] * 3 + in1[x + 1];
        row[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        row[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      row[2 * dw - 2] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
      row[2 * dw - 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      return;
    }
    // h2v1, h2v2 at <= 2 columns, and every other whole ratio: int_upsample's
    // replication, rh columns and rv rows a sample
    for (int x = 0; x < width; ++x) row[x] = in0[x / rh];
  }

  void finish(uint8_t* out) {
    if (!lossless_)
      for (int c = 0; c < ncomp_; ++c) {
        Component& k = comp_[c];
        k.stride = k.wblocks * 8;
        k.plane.assign(static_cast<size_t>(k.stride) * k.hblocks * 8, 0);
        for (int by = 0; by < k.hblocks; ++by)
          for (int bx = 0; bx < k.wblocks; ++bx)
            idct(&k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64], k.q,
                 &k.plane[static_cast<size_t>(by) * 8 * k.stride + bx * 8], k.stride);
      }
    if (ncomp_ == 1) {
      for (int y = 0; y < height; ++y)
        upsample_row(comp_[0], y, out + static_cast<size_t>(y) * width);
      return;
    }
    // jdcolor.c's tables, SCALEBITS 16: R = Y + Cr_r[Cr], B = Y + Cb_b[Cb],
    // G = Y + ((Cb_g[Cb] + Cr_g[Cr]) >> 16), each clamped to 0..255
    const int SCALEBITS = 16, ONE_HALF = 1 << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int x = i - 128;
      cr_r[i] = (fix(1.40200) * x + ONE_HALF) >> SCALEBITS;
      cb_b[i] = (fix(1.77200) * x + ONE_HALF) >> SCALEBITS;
      cr_g[i] = (-fix(0.71414)) * x;
      cb_g[i] = (-fix(0.34414)) * x + ONE_HALF;
    }
    int rw = 2 * width + 16;
    for (int c = 0; c < ncomp_; ++c) rw = std::max(rw, 2 * comp_[c].dw + 16);
    std::vector<uint8_t> rows[4];
    for (int c = 0; c < ncomp_; ++c) rows[c].assign(rw, 0);
    const int nc = ncomp_;
    for (int y = 0; y < height; ++y) {
      for (int c = 0; c < nc; ++c) upsample_row(comp_[c], y, rows[c].data());
      const uint8_t *r0 = rows[0].data(), *r1 = rows[1].data(), *r2 = rows[2].data();
      uint8_t* o = out + static_cast<size_t>(y) * width * nc;
      if (nc == 4) {
        // Pillow reads four components as "CMYK;I", Adobe's inverted
        // convention: CMYK comes out as 255 - each component; YCCK as the
        // R, G, B of its Y, Cb, Cr (255 - ycck_cmyk_convert's C, M, Y) and
        // 255 - K
        const uint8_t* r3 = rows[3].data();
        for (int x = 0; x < width; ++x) {
          if (ycck_) {
            int yy = r0[x], cb = r1[x], cr = r2[x];
            o[4 * x] = static_cast<uint8_t>(clamp255(yy + cr_r[cr]));
            o[4 * x + 1] = static_cast<uint8_t>(clamp255(yy + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)));
            o[4 * x + 2] = static_cast<uint8_t>(clamp255(yy + cb_b[cb]));
          } else {
            o[4 * x] = static_cast<uint8_t>(255 - r0[x]);
            o[4 * x + 1] = static_cast<uint8_t>(255 - r1[x]);
            o[4 * x + 2] = static_cast<uint8_t>(255 - r2[x]);
          }
          o[4 * x + 3] = static_cast<uint8_t>(255 - r3[x]);
        }
        continue;
      }
      if (rgb_) {
        for (int x = 0; x < width; ++x) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
        }
        continue;
      }
      for (int x = 0; x < width; ++x) {
        int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = static_cast<uint8_t>(clamp255(yy + cr_r[cr]));
        o[3 * x + 1] = static_cast<uint8_t>(clamp255(yy + ((cb_g[cb] + cr_g[cr]) >> SCALEBITS)));
        o[3 * x + 2] = static_cast<uint8_t>(clamp255(yy + cb_b[cb]));
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Encoder

// T.81 Annex K.1 quantization tables, natural order
const uint8_t kLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// T.81 Annex K.3 Huffman tables: code counts by length 1..16, then values
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    int code_ = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        code[vals[p]] = static_cast<uint16_t>(code_++);
        size[vals[p]] = static_cast<uint8_t>(l);
      }
      code_ <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int bits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t v, int n) {
    if (!n) return;
    acc = (acc << n) | (v & ((1u << n) - 1));
    bits += n;
    while (bits >= 8) {
      uint8_t b = static_cast<uint8_t>(acc >> (bits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      bits -= 8;
    }
  }
  void flush() { put(0x7F, 7); bits = 0; }  // pad with 1-bits to the byte boundary
};

// jcdctmgr.c's compute_reciprocal: the reciprocal, correction and shift with
// which libjpeg-turbo quantizes (16-bit DCTELEM); divisor = quantval << 3
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  Divisor dv;
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor, fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  dv.recip = static_cast<uint32_t>(fq);
  dv.corr = c;
  dv.shift = r - 16;
  return dv;
}

// jfdctint.c's jpeg_fdct_islow on samples - 128, results scaled up by 8
void fdct(int32_t* d) {
  for (int row = 0; row < 8; ++row) {
    int32_t* p = d + row * 8;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
    p[4] = (tmp10 - tmp11) * (1 << PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  for (int col = 0; col < 8; ++col) {
    int32_t* p = d + col;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = descale(tmp10 - tmp11, PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

struct Plane {
  int w = 0, h = 0;  // samples held: already padded as the encoder needs
  std::vector<uint8_t> px;
};

class Encoder {
 public:
  Encoder(const uint8_t* pix, int w, int h, int c, int quality)
      : pix_(pix), w_(w), h_(h), c_(c) {
    // jpeg_quality_scaling, then jpeg_add_quant_table with force_baseline
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
      long t = (static_cast<long>(kLumaQ[i]) * scale + 50) / 100;
      qt_[0][i] = static_cast<uint16_t>(std::min(255L, std::max(1L, t)));
      t = (static_cast<long>(kChromaQ[i]) * scale + 50) / 100;
      qt_[1][i] = static_cast<uint16_t>(std::min(255L, std::max(1L, t)));
      div_[0][i] = reciprocal(static_cast<uint32_t>(qt_[0][i]) << 3);
      div_[1][i] = reciprocal(static_cast<uint32_t>(qt_[1][i]) << 3);
    }
  }

  std::vector<uint8_t> run() {
    std::vector<uint8_t> out;
    out.reserve(static_cast<size_t>(w_) * h_ * c_ / 4 + 1024);
    header(out);
    BitWriter bw(out);
    EncTable dcl(kDcLumaBits, kDcVals), acl(kAcLumaBits, kAcLumaVals);
    if (c_ == 1) {
      Plane y = gray_plane();
      int last = 0;
      int16_t blk[64];
      for (int by = 0; by < y.h / 8; ++by)
        for (int bx = 0; bx < y.w / 8; ++bx) {
          forward(y, bx, by, 0, blk);
          encode_block(bw, blk, last, dcl, acl);
        }
    } else {
      EncTable dcc(kDcChromaBits, kDcVals), acc(kAcChromaBits, kAcChromaVals);
      Plane y, cb, cr;
      ycc_planes(y, cb, cr);
      int ywb = (w_ + 7) / 8, yhb = (h_ + 7) / 8;  // Y blocks holding samples
      int mcux = (w_ + 15) / 16, mcuy = (h_ + 15) / 16;
      int ly = 0, lcb = 0, lcr = 0;
      int16_t blk[4][64], cblk[64];
      for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx) {
          // the four Y blocks of the MCU; those past the image's blocks are
          // dummy blocks: AC zero, DC that of the block before in the MCU
          for (int v = 0; v < 2; ++v)
            for (int hh = 0; hh < 2; ++hh) {
              int bi = v * 2 + hh, bx = mx * 2 + hh, by = my * 2 + v;
              if (by < yhb && bx < ywb) {
                forward(y, bx, by, 0, blk[bi]);
              } else {
                std::memset(blk[bi], 0, sizeof(blk[bi]));
                // right edge: the block to the left; bottom row: the last
                // block of the row above (jccoefct.c's compress_data)
                blk[bi][0] = by < yhb ? blk[bi - 1][0] : blk[1][0];
              }
            }
          for (int bi = 0; bi < 4; ++bi) encode_block(bw, blk[bi], ly, dcl, acl);
          forward(cb, mx, my, 1, cblk);
          encode_block(bw, cblk, lcb, dcc, acc);
          forward(cr, mx, my, 1, cblk);
          encode_block(bw, cblk, lcr, dcc, acc);
        }
    }
    bw.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
    return out;
  }

 private:
  const uint8_t* pix_;
  int w_, h_, c_;
  uint16_t qt_[2][64];
  Divisor div_[2][64];

  static void put16(std::vector<uint8_t>& o, int v) {
    o.push_back(static_cast<uint8_t>(v >> 8));
    o.push_back(static_cast<uint8_t>(v));
  }

  void header(std::vector<uint8_t>& o) const {
    const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    o.insert(o.end(), jfif, jfif + sizeof(jfif));
    int ntab = c_ == 1 ? 1 : 2;
    for (int t = 0; t < ntab; ++t) {
      o.push_back(0xFF);
      o.push_back(0xDB);
      put16(o, 67);
      o.push_back(static_cast<uint8_t>(t));
      for (int k = 0; k < 64; ++k) o.push_back(static_cast<uint8_t>(qt_[t][kZigzag.natural[k]]));
    }
    o.push_back(0xFF);
    o.push_back(0xC0);
    put16(o, 8 + 3 * c_);
    o.push_back(8);
    put16(o, h_);
    put16(o, w_);
    o.push_back(static_cast<uint8_t>(c_));
    if (c_ == 1) {
      const uint8_t comp[] = {1, 0x11, 0};
      o.insert(o.end(), comp, comp + 3);
    } else {
      const uint8_t comp[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
      o.insert(o.end(), comp, comp + 9);
    }
    auto dht = [&](int cls_id, const uint8_t* bits, const uint8_t* vals, int n) {
      o.push_back(0xFF);
      o.push_back(0xC4);
      put16(o, 2 + 1 + 16 + n);
      o.push_back(static_cast<uint8_t>(cls_id));
      o.insert(o.end(), bits, bits + 16);
      o.insert(o.end(), vals, vals + n);
    };
    dht(0x00, kDcLumaBits, kDcVals, 12);
    dht(0x10, kAcLumaBits, kAcLumaVals, 162);
    if (c_ == 3) {
      dht(0x01, kDcChromaBits, kDcVals, 12);
      dht(0x11, kAcChromaBits, kAcChromaVals, 162);
    }
    o.push_back(0xFF);
    o.push_back(0xDA);
    put16(o, 6 + 2 * c_);
    o.push_back(static_cast<uint8_t>(c_));
    if (c_ == 1) {
      o.push_back(1);
      o.push_back(0x00);
    } else {
      const uint8_t sel[] = {1, 0x00, 2, 0x11, 3, 0x11};
      o.insert(o.end(), sel, sel + 6);
    }
    o.push_back(0);
    o.push_back(63);
    o.push_back(0);
  }

  // the grey samples with the right and bottom edges replicated out to whole blocks
  Plane gray_plane() const {
    Plane p;
    p.w = (w_ + 7) / 8 * 8;
    p.h = (h_ + 7) / 8 * 8;
    p.px.resize(static_cast<size_t>(p.w) * p.h);
    for (int y = 0; y < p.h; ++y) {
      const uint8_t* in = pix_ + static_cast<size_t>(std::min(y, h_ - 1)) * w_;
      uint8_t* o = &p.px[static_cast<size_t>(y) * p.w];
      std::memcpy(o, in, w_);
      std::memset(o + w_, in[w_ - 1], p.w - w_);
    }
    return p;
  }

  // jccolor.c's rgb_ycc_convert, SCALEBITS 16; Cb and Cr round with
  // ONE_HALF - 1 and add CBCR_OFFSET (128 << 16) so that no clamp is needed.
  // The padding follows jcprepct.c and jcsample.c: the rows are widened to
  // the MCU's width by replicating the right edge, Cb and Cr are
  // downsampled 2x2 (h2v2_downsample, bias 1, 2, 1, 2 along a row) from
  // pairs of rows (an odd last row paired with itself), then the last Y row
  // and the last Cb/Cr row are replicated down to the iMCU's height.
  void ycc_planes(Plane& y, Plane& cb, Plane& cr) const {
    const int32_t SCALEBITS = 16, ONE_HALF = 1 << (SCALEBITS - 1), CBCR_OFFSET = 128 << SCALEBITS;
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << 16) + 0.5); };
    int32_t ry[256], gy[256], by_[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
    for (int i = 0; i < 256; ++i) {
      ry[i] = fix(0.29900) * i;
      gy[i] = fix(0.58700) * i;
      by_[i] = fix(0.11400) * i + ONE_HALF;
      rcb[i] = (-fix(0.16874)) * i;
      gcb[i] = (-fix(0.33126)) * i;
      bcb[i] = fix(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;  // also R => Cr
      gcr[i] = (-fix(0.41869)) * i;
      bcr[i] = (-fix(0.08131)) * i;
    }
    int mw = (w_ + 15) / 16 * 16, mh = (h_ + 15) / 16 * 16;
    int rows = h_ + (h_ & 1);  // real rows, an odd count padded by one
    std::vector<uint8_t> fy(static_cast<size_t>(mw) * rows), fcb(fy.size()), fcr(fy.size());
    for (int r = 0; r < rows; ++r) {
      const uint8_t* in = pix_ + static_cast<size_t>(std::min(r, h_ - 1)) * w_ * 3;
      size_t o = static_cast<size_t>(r) * mw;
      for (int x = 0; x < mw; ++x) {
        const uint8_t* p = in + 3 * std::min(x, w_ - 1);
        int R = p[0], G = p[1], B = p[2];
        fy[o + x] = static_cast<uint8_t>((ry[R] + gy[G] + by_[B]) >> SCALEBITS);
        fcb[o + x] = static_cast<uint8_t>((rcb[R] + gcb[G] + bcb[B]) >> SCALEBITS);
        fcr[o + x] = static_cast<uint8_t>((bcb[R] + gcr[G] + bcr[B]) >> SCALEBITS);
      }
    }
    y.w = mw;
    y.h = mh;
    y.px.resize(static_cast<size_t>(mw) * mh);
    for (int r = 0; r < mh; ++r)
      std::memcpy(&y.px[static_cast<size_t>(r) * mw], &fy[static_cast<size_t>(std::min(r, h_ - 1)) * mw], mw);
    int cw = mw / 2, ch = mh / 2, creal = rows / 2;
    for (Plane* p : {&cb, &cr}) {
      const std::vector<uint8_t>& f = p == &cb ? fcb : fcr;
      p->w = cw;
      p->h = ch;
      p->px.resize(static_cast<size_t>(cw) * ch);
      for (int r = 0; r < creal; ++r) {
        const uint8_t* i0 = &f[static_cast<size_t>(2 * r) * mw];
        const uint8_t* i1 = i0 + mw;
        uint8_t* o = &p->px[static_cast<size_t>(r) * cw];
        int bias = 1;
        for (int x = 0; x < cw; ++x) {
          o[x] = static_cast<uint8_t>((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
      for (int r = creal; r < ch; ++r)
        std::memcpy(&p->px[static_cast<size_t>(r) * cw], &p->px[static_cast<size_t>(creal - 1) * cw], cw);
    }
  }

  // the islow forward DCT of block (bx, by), then libjpeg-turbo's
  // quantization: |x| + correction, times the reciprocal, shifted right by
  // 16 + shift, the sign put back (the same integers as its SIMD quantize)
  void forward(const Plane& p, int bx, int by, int t, int16_t* out) const {
    int32_t d[64];
    for (int r = 0; r < 8; ++r) {
      const uint8_t* in = &p.px[static_cast<size_t>(by * 8 + r) * p.w + bx * 8];
      for (int c = 0; c < 8; ++c) d[r * 8 + c] = in[c] - 128;
    }
    fdct(d);
    for (int i = 0; i < 64; ++i) {
      const Divisor& dv = div_[t][i];
      int32_t x = static_cast<int16_t>(d[i]);  // DCTELEM is 16-bit
      bool neg = x < 0;
      uint32_t a = static_cast<uint16_t>((neg ? -x : x) + dv.corr);
      uint32_t q = static_cast<uint32_t>((static_cast<uint64_t>(a) * dv.recip) >> (16 + dv.shift));
      out[i] = static_cast<int16_t>(neg ? -static_cast<int32_t>(q) : static_cast<int32_t>(q));
    }
  }

  static inline int nbits(int v) { return v ? 32 - __builtin_clz(static_cast<unsigned>(v)) : 0; }

  // jchuff.c's encode_one_block: the DC difference, then runs of zeros and
  // values in zigzag order, ZRL for runs past 15, EOB after the last value
  static void encode_block(BitWriter& bw, const int16_t* blk, int& last, const EncTable& dc,
                           const EncTable& ac) {
    int t = blk[0] - last, t2 = t;
    last = blk[0];
    if (t < 0) {
      t = -t;
      --t2;
    }
    int n = nbits(t);
    bw.put(dc.code[n], dc.size[n]);
    bw.put(static_cast<uint32_t>(t2), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[kZigzag.natural[k]];
      if (!v) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac.code[0xF0], ac.size[0xF0]);
        run -= 16;
      }
      int a = v, a2 = v;
      if (a < 0) {
        a = -a;
        --a2;
      }
      n = nbits(a);
      int sym = (run << 4) + n;
      bw.put(ac.code[sym], ac.size[sym]);
      bw.put(static_cast<uint32_t>(a2), n);
      run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.size[0]);
  }
};

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" {

// width, height and channels (1 or 3) of a JPEG in the subset; 0 or -1
int jc_info(const uint8_t* data, size_t n, int* width, int* height, int* channels, char* err,
            int errlen) {
  try {
    Decoder d(data, n);
    d.header();
    *width = d.width;
    *height = d.height;
    *channels = d.channels;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// decode into out (height x width x channels uint8, the sizes jc_info gave)
int jc_decode(const uint8_t* data, size_t n, uint8_t* out, int width, int height, int channels,
              char* err, int errlen) {
  try {
    Decoder h(data, n);
    h.header();
    if (h.width != width || h.height != height || h.channels != channels)
      throw JpegError("the output buffer does not match the image's size");
    Decoder d(data, n);
    d.decode(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

// a bound on the encoded size of a width x height x channels image
size_t jc_encode_bound(int width, int height, int channels) {
  size_t blocks = static_cast<size_t>((width + 15) / 16) * ((height + 15) / 16) * (channels == 1 ? 4 : 6);
  // at most 16 + 11 bits for the DC and 63 * (16 + 10) bits of AC a block,
  // doubled for byte stuffing, plus the headers
  return blocks * 2 * (27 + 63 * 26) / 8 + 2048;
}

// encode pixels (height x width x channels uint8, channels 1 or 3) into
// out; the encoded length, or -1
long jc_encode(const uint8_t* pixels, int width, int height, int channels, int quality,
               uint8_t* out, size_t cap, char* err, int errlen) {
  try {
    if (width < 1 || height < 1 || width > 65535 || height > 65535)
      throw JpegError("a JPEG is 1 to 65535 pixels a side");
    if (channels != 1 && channels != 3) throw JpegError("only L and RGB images are encoded");
    std::vector<uint8_t> bytes = Encoder(pixels, width, height, channels, quality).run();
    if (bytes.size() > cap) throw JpegError("the output buffer is too small");
    std::memcpy(out, bytes.data(), bytes.size());
    return static_cast<long>(bytes.size());
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
