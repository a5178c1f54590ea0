// GIF, TIFF and WebP bit-level decoding on the host, for the port's data path.
//
// The containers (GIF blocks, TIFF directories, RIFF chunks) are read in
// Python (data/gif.py, data/tiff.py, data/webp.py); this file holds what
// runs per pixel or per bit, written so that the pixels equal those Pillow
// 12 decodes through its GifDecode.c, libtiff 4.7 and libwebp 1.6:
//
// - GIF's LZW (variable code width, clear codes, a table that stops growing
//   at 4096 codes as Pillow's decoder lets it);
// - TIFF's LZW (MSB-first codes that widen one code early, and the old
//   LSB-first variant libtiff still reads) and PackBits;
// - WebP lossless (RFC 9649): the four transforms, the colour cache, LZ77
//   back-references with the 2-D distance codes, meta Huffman images;
// - WebP lossy (RFC 6386 key frames): the boolean decoder, segments,
//   partitions, the intra predictors, the inverse WHT and DCT, the simple
//   and normal loop filters, and YUV 4:2:0 to RGB with libwebp's "fancy"
//   upsampler and fixed-point conversion;
// - the ALPH chunk: raw or lossless-coded alpha and its three filters.
//
// C interface (ctypes): every function takes an error buffer and returns a
// negative value on failure with the message written there. The caller owns
// every buffer. ctypes releases the interpreter lock for each call.

#include <algorithm>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// --- GIF LZW ---------------------------------------------------------------------------

// Decode the LZW data of one GIF image (its sub-blocks already joined) into
// out, at most npix indices; the number written. Codes LSB-first.
long gif_lzw(const uint8_t* data, size_t n, int min_bits, uint8_t* out, long npix) {
  if (min_bits < 0 || min_bits > 12) throw CodecError("GIF LZW minimum code size out of range");
  const int clear = 1 << min_bits, eoi = clear + 1;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int i = 0; i < clear && i < 4096; ++i) {
    suffix[i] = static_cast<uint8_t>(i);
    first[i] = static_cast<uint8_t>(i);
  }
  int bits = min_bits + 1, next = clear + 2, prev = -1;
  uint32_t acc = 0;
  int have = 0;
  size_t pos = 0;
  long written = 0;
  while (written < npix) {
    while (have < bits && pos < n) {
      acc |= static_cast<uint32_t>(data[pos++]) << have;
      have += 8;
    }
    if (have < bits) break;  // the data ended: the rest keeps its fill
    int code = static_cast<int>(acc & ((1u << bits) - 1));
    acc >>= bits;
    have -= bits;
    if (code == clear) {
      bits = min_bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    if (prev < 0) {
      if (code >= clear) throw CodecError("GIF LZW code before the table holds it");
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || (code == next && next >= 4096))
      throw CodecError("GIF LZW code past the table");
    int c = code, sp = 0;
    uint8_t lead;
    if (code == next) {  // KwKwK: the previous string and its own first byte
      stack[sp++] = first[prev];
      c = prev;
    }
    while (c >= clear) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    stack[sp++] = static_cast<uint8_t>(c);
    lead = static_cast<uint8_t>(c);
    while (sp > 0 && written < npix) out[written++] = stack[--sp];
    if (next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = lead;
      first[next] = first[prev];
      ++next;
      if (next == (1 << bits) && bits < 12) ++bits;
    }
    prev = code;
  }
  return written;
}

// --- TIFF LZW and PackBits --------------------------------------------------------------

// libtiff's LZWDecode (codes MSB-first, the width growing one code before
// the table fills it) and LZWDecodeCompat (LSB-first, at the table's size),
// chosen as libtiff chooses: a strip that starts 00 01.. is the old kind.
// Decodes until out holds cap bytes or EOI; the number written.
long tiff_lzw(const uint8_t* data, size_t n, uint8_t* out, size_t cap) {
  const bool compat = n >= 2 && data[0] == 0 && (data[1] & 1);
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = static_cast<uint8_t>(i);
    first[i] = static_cast<uint8_t>(i);
  }
  int bits = 9, next = 258, prev = -1;
  uint64_t acc = 0;
  int have = 0;
  size_t pos = 0, written = 0;
  while (written < cap) {
    while (have < bits && pos < n) {
      if (compat) acc |= static_cast<uint64_t>(data[pos++]) << have;
      else acc = (acc << 8) | data[pos++];
      have += 8;
    }
    if (have < bits) break;
    int code;
    if (compat) {
      code = static_cast<int>(acc & ((1u << bits) - 1));
      acc >>= bits;
    } else {
      code = static_cast<int>((acc >> (have - bits)) & ((1u << bits) - 1));
    }
    have -= bits;
    if (code == 256) {
      bits = 9;
      next = 258;
      prev = -1;
      continue;
    }
    if (code == 257) break;
    if (prev < 0) {
      if (code > 255) throw CodecError("TIFF LZW code before the table holds it");
      out[written++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next || code == 256 || code == 257 || (code == next && next >= 4096))
      throw CodecError("corrupted TIFF LZW table");
    int c = code, sp = 0;
    if (code == next) {
      stack[sp++] = first[prev];
      c = prev;
    }
    while (c > 257) {
      stack[sp++] = suffix[c];
      c = prefix[c];
    }
    stack[sp++] = static_cast<uint8_t>(c);
    const uint8_t lead = static_cast<uint8_t>(c);
    while (sp > 0 && written < cap) out[written++] = stack[--sp];
    if (next < 4096) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = lead;
      first[next] = first[prev];
      ++next;
      const int grow = compat ? (1 << bits) : (1 << bits) - 1;
      if (next >= grow && bits < 12) ++bits;
    }
    prev = code;
  }
  return static_cast<long>(written);
}

// libtiff's PackBitsDecode: a signed count n, n >= 0 copies n + 1 bytes,
// -127..-1 repeats the next byte 1 - n times, -128 is a no-op. Bytes past
// cap are dropped, as libtiff drops them.
long packbits(const uint8_t* data, size_t n, uint8_t* out, size_t cap) {
  size_t pos = 0, written = 0;
  while (pos < n && written < cap) {
    int c = static_cast<int8_t>(data[pos++]);
    if (c >= 0) {
      size_t len = static_cast<size_t>(c) + 1;
      if (pos + len > n) len = n - pos;
      len = std::min(len, cap - written);
      std::memcpy(out + written, data + pos, len);
      written += len;
      pos += static_cast<size_t>(c) + 1;
    } else if (c != -128) {
      if (pos >= n) break;
      size_t len = std::min(static_cast<size_t>(1 - c), cap - written);
      std::memset(out + written, data[pos++], len);
      written += len;
    }
  }
  return static_cast<long>(written);
}

// --- constants of RFC 6386 (VP8) and RFC 9649 (VP8L) ----------------------------------

// RFC 6386 section 13.4: coeff_update_probs[4][8][3][11], one band a line
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255, 239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255, 234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255, 251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255, 248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};

// RFC 6386 section 13.5: default_coeff_probs[4][8][3][11]
const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128, 189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128, 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128, 184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128, 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128, 207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128, 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1, 68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128, 184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128, 23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128, 109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128, 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128, 124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128, 45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128, 203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128, 73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128, 239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128, 69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128, 223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128, 149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128, 247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128, 55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128, 61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128, 166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128, 24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128, 149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128, 20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128, 168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128, 42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};

// RFC 6386 section 11.5: kf_bmode_probs[10][10][9], modes in the order
// DC, TM, VE, HE, RD, VR, LD, VL, HD, HU
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24};

// RFC 6386 section 14.1: dc_qlookup and ac_qlookup
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

// RFC 9649 section 4.2.2: the 120 short distance codes (dy << 4 | 8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};

// --- WebP lossless (VP8L, RFC 9649) -----------------------------------------------------

struct BitReaderL {  // LSB-first
  const uint8_t* d;
  size_t n, pos = 0;
  uint64_t acc = 0;
  int have = 0;
  BitReaderL(const uint8_t* data, size_t size) : d(data), n(size) {}
  void fill() {
    while (have <= 56) {
      uint64_t b = pos < n ? d[pos] : 0;
      if (pos >= n + 8) throw CodecError("truncated WebP lossless bitstream");
      ++pos;
      acc |= b << have;
      have += 8;
    }
  }
  uint32_t peek(int bits) {
    if (have < bits) fill();
    return static_cast<uint32_t>(acc & ((1ull << bits) - 1));
  }
  void skip(int bits) {
    acc >>= bits;
    have -= bits;
  }
  uint32_t read(int bits) {
    if (bits == 0) return 0;
    uint32_t v = peek(bits);
    skip(bits);
    return v;
  }
  // bits consumed past the end of the data
  bool overrun() const { return static_cast<long>(pos) * 8 - have > static_cast<long>(n) * 8; }
};

// A canonical prefix code (RFC 9649 section 3.7.2): a single symbol reads no
// bits; any other set of lengths must fill the code space exactly.
struct Huffman {
  static constexpr int kFast = 10;
  std::vector<int32_t> fast;  // (symbol << 8) | length, or -1 for a longer code
  int count[16] = {0};
  std::vector<int> sorted;    // symbols by length, then value
  int single = -1;

  void build(const std::vector<int>& lengths) {
    const int n = static_cast<int>(lengths.size());
    int nonzero = 0;
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) throw CodecError("WebP lossless code length over 15");
      ++count[lengths[s]];
      if (lengths[s]) {
        ++nonzero;
        single = s;
      }
    }
    if (nonzero == 0) throw CodecError("WebP lossless prefix code without symbols");
    if (nonzero == 1) return;
    single = -1;
    int left = 1;
    for (int len = 1; len <= 15; ++len) {
      left = (left << 1) - count[len];
      if (left < 0) throw CodecError("WebP lossless prefix code over-subscribed");
    }
    if (left != 0) throw CodecError("WebP lossless prefix code incomplete");
    int offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    sorted.assign(nonzero, 0);
    for (int s = 0; s < n; ++s)
      if (lengths[s]) sorted[offs[lengths[s]]++] = s;
    fast.assign(1 << kFast, -1);
    // codes in canonical order; the table is indexed by the bits as read,
    // LSB first, so each code is bit-reversed
    int code = 0, k = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        if (len <= kFast) {
          int rev = 0;
          for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
          for (int fill = rev; fill < (1 << kFast); fill += 1 << len)
            fast[fill] = (sorted[k] << 8) | len;
        }
      }
      code <<= 1;
    }
  }

  int read(BitReaderL& br) const {
    if (single >= 0) return single;
    const uint32_t bits = br.peek(15);
    const int32_t f = fast[bits & ((1 << kFast) - 1)];
    if (f >= 0) {
      br.skip(f & 0xff);
      return f >> 8;
    }
    // longer than kFast: walk the canonical code a bit at a time
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= (bits >> (len - 1)) & 1;
      const int c = count[len];
      if (code - c < first) {
        br.skip(len);
        return sorted[index + (code - first)];
      }
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    throw CodecError("WebP lossless prefix code without a match");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};  // green+lengths, red, blue, alpha, distance

void read_code(BitReaderL& br, int alphabet, Huffman& h) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int num = br.read(1) + 1;
    const int first = br.read(br.read(1) ? 8 : 1);
    if (first >= alphabet) throw CodecError("WebP lossless symbol outside its alphabet");
    lengths[first] = 1;
    if (num == 2) {
      const int second = br.read(8);
      if (second >= alphabet) throw CodecError("WebP lossless symbol outside its alphabet");
      lengths[second] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num_codes = br.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthOrder[i]] = br.read(3);
    Huffman lens;
    lens.build(cl);
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * br.read(3);
      max_symbol = 2 + br.read(nbits);
      if (max_symbol > alphabet) throw CodecError("WebP lossless max_symbol past the alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = lens.read(br);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        const int slot = len - 16;
        const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int repeat = br.read(extra[slot]) + offset[slot];
        if (symbol + repeat > alphabet) throw CodecError("WebP lossless code lengths overrun");
        const int v = slot == 0 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = v;
      }
    }
  }
  if (br.overrun()) throw CodecError("truncated WebP lossless bitstream");
  h.build(lengths);
}

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int prefix_value(int symbol, BitReaderL& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct VP8LDecoder {
  BitReaderL br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  explicit VP8LDecoder(const uint8_t* d, size_t n) : br(d, n) {}

  // One image stream (RFC 9649 section 5): the transforms (level 0 only),
  // the colour cache, the prefix codes, then the entropy-coded pixels.
  std::vector<uint32_t> image(int xsize, int ysize, bool level0) {
    int tx = xsize;
    if (level0) {
      while (br.read(1)) {
        Transform t;
        t.type = br.read(2);
        if (seen & (1u << t.type)) throw CodecError("WebP lossless transform repeated");
        seen |= 1u << t.type;
        t.xsize = tx;
        t.ysize = ysize;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = br.read(3) + 2;
          t.data = image(sub_sample(tx, t.bits), sub_sample(ysize, t.bits), false);
        } else if (t.type == 3) {
          const int colours = br.read(8) + 1;
          t.bits = colours > 16 ? 0 : colours > 4 ? 1 : colours > 2 ? 2 : 3;
          std::vector<uint32_t> raw = image(colours, 1, false);
          t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
          for (int i = 0; i < colours; ++i) {
            uint32_t v = raw[i];
            if (i > 0) {  // each entry coded as its difference from the one before, per byte
              const uint32_t p = t.data[i - 1];
              uint32_t sum = 0;
              for (int b = 0; b < 32; b += 8) sum |= (((v >> b) + (p >> b)) & 0xff) << b;
              v = sum;
            }
            t.data[i] = v;
          }
          tx = sub_sample(tx, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) throw CodecError("WebP lossless colour cache size");
    }
    int meta_bits = 0, meta_x = 0, groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
      meta_bits = br.read(3) + 2;
      meta_x = sub_sample(tx, meta_bits);
      meta = image(meta_x, sub_sample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        groups = std::max(groups, static_cast<int>(m) + 1);
      }
    }
    // every group's codes are read; only those the meta image names are
    // kept (as libwebp maps them), so a file cannot make 65536 sets of tables
    std::vector<int> slot(groups, -1);
    int used = 0;
    if (meta.empty()) slot[0] = used++;
    for (uint32_t& m : meta) {
      if (slot[m] < 0) slot[m] = used++;
      m = static_cast<uint32_t>(slot[m]);
    }
    std::vector<Huffman> codes(static_cast<size_t>(used) * 5);
    for (int g = 0; g < groups; ++g)
      for (int j = 0; j < 5; ++j) {
        Huffman unused;
        read_code(br, kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0),
                  slot[g] >= 0 ? codes[slot[g] * 5 + j] : unused);
      }
    std::vector<uint32_t> px(static_cast<size_t>(tx) * ysize);
    decode_pixels(px, tx, codes, meta, meta_bits, meta_x, cache_bits);
    if (level0) {
      for (int i = static_cast<int>(transforms.size()) - 1; i >= 0; --i) px = inverse(transforms[i], px);
    }
    return px;
  }

  void decode_pixels(std::vector<uint32_t>& px, int w, const std::vector<Huffman>& codes,
                     const std::vector<uint32_t>& meta, int meta_bits, int meta_x,
                     int cache_bits) {
    std::vector<uint32_t> cache(cache_bits ? 1u << cache_bits : 0);
    const size_t total = px.size();
    size_t i = 0, cached = 0;
    auto insert = [&](size_t upto) {
      if (!cache_bits) return;
      for (; cached < upto; ++cached)
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    while (i < total) {
      const int x = static_cast<int>(i % w), y = static_cast<int>(i / w);
      const Huffman* g = codes.data();
      if (meta_bits) g += 5 * meta[(y >> meta_bits) * meta_x + (x >> meta_bits)];
      const int code = g[0].read(br);
      if (code < 256) {
        const int red = g[1].read(br), blue = g[2].read(br), alpha = g[3].read(br);
        px[i++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) | (code << 8) | blue;
      } else if (code < 256 + 24) {
        const int length = prefix_value(code - 256, br);
        const int dsym = g[4].read(br);
        const int dcode = prefix_value(dsym, br);
        long dist;
        if (dcode > 120) {
          dist = dcode - 120;
        } else {
          const int c = kCodeToPlane[dcode - 1];
          dist = static_cast<long>(c >> 4) * w + (8 - (c & 0xf));
          if (dist < 1) dist = 1;
        }
        if (static_cast<long>(i) < dist || total - i < static_cast<size_t>(length))
          throw CodecError("WebP lossless back-reference out of the image");
        for (int k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
      } else {
        const int key = code - 256 - 24;
        if (!cache_bits || key >= (1 << cache_bits)) throw CodecError("WebP lossless cache code");
        insert(i);
        px[i++] = cache[key];
      }
      insert(i);
      if (br.overrun()) throw CodecError("truncated WebP lossless bitstream");
    }
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
    const int d = sub3(a >> 24, b >> 24, c >> 24) +
                  sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                  sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                  sub3(a & 0xff, b & 0xff, c & 0xff);
    return d <= 0 ? a : b;
  }
  static uint32_t clamp_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
                    static_cast<int>((c2 >> s) & 0xff);
      out |= static_cast<uint32_t>(clip255(v)) << s;
    }
    return out;
  }
  static uint32_t clamp_half(uint32_t c0, uint32_t c1) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int a = (c0 >> s) & 0xff, b = (c1 >> s) & 0xff;
      out |= static_cast<uint32_t>(clip255(a + (a - b) / 2)) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, const uint32_t* cur, const uint32_t* up, int x) {
    const uint32_t L = cur[x - 1], T = up[x], TL = up[x - 1], TR = up[x + 1];
    switch (mode) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return avg2(avg2(L, TR), T);
      case 6: return avg2(L, TL);
      case 7: return avg2(L, T);
      case 8: return avg2(TL, T);
      case 9: return avg2(T, TR);
      case 10: return avg2(avg2(L, TL), avg2(T, TR));
      case 11: return select(T, L, TL);
      case 12: return clamp_full(L, T, TL);
      case 13: return clamp_half(avg2(L, T), TL);
      default: return 0xff000000u;
    }
  }

  std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {  // subtract green
      for (uint32_t& v : in) {
        const uint32_t g = (v >> 8) & 0xff;
        uint32_t rb = (v & 0x00ff00ffu) + ((g << 16) | g);
        v = (v & 0xff00ff00u) | (rb & 0x00ff00ffu);
      }
      return std::move(in);
    }
    if (t.type == 1) {  // cross colour
      const int tiles = sub_sample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t g2r = static_cast<int8_t>(m & 0xff), g2b = static_cast<int8_t>((m >> 8) & 0xff),
                       r2b = static_cast<int8_t>((m >> 16) & 0xff);
          uint32_t& v = in[static_cast<size_t>(y) * w + x];
          const int8_t green = static_cast<int8_t>((v >> 8) & 0xff);
          int red = (v >> 16) & 0xff, blue = v & 0xff;
          red = (red + ((static_cast<int>(g2r) * green) >> 5)) & 0xff;
          blue += (static_cast<int>(g2b) * green) >> 5;
          blue += (static_cast<int>(r2b) * static_cast<int8_t>(red)) >> 5;
          blue &= 0xff;
          v = (v & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
        }
      return std::move(in);
    }
    if (t.type == 0) {  // predictor
      const int tiles = sub_sample(w, t.bits);
      std::vector<uint32_t> out(in.size());
      for (int y = 0; y < h; ++y) {
        uint32_t* cur = out.data() + static_cast<size_t>(y) * w;
        const uint32_t* res = in.data() + static_cast<size_t>(y) * w;
        const uint32_t* up = cur - w;
        for (int x = 0; x < w; ++x) {
          uint32_t pred;
          if (y == 0) pred = x == 0 ? 0xff000000u : cur[x - 1];
          else if (x == 0) pred = up[0];
          else pred = predict((t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 0xf, cur, up, x);
          cur[x] = add(pred, res[x]);
        }
      }
      return out;
    }
    // colour indexing: indices packed 8 >> bits a green byte, low bits first
    const int per = 1 << t.bits, ibits = 8 >> t.bits, sub_w = sub_sample(w, t.bits);
    std::vector<uint32_t> out(static_cast<size_t>(w) * h);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = (in[static_cast<size_t>(y) * sub_w + x / per] >> 8) & 0xff;
        const uint32_t idx = (packed >> ((x % per) * ibits)) & ((1u << ibits) - 1);
        out[static_cast<size_t>(y) * w + x] = t.data[idx];
      }
    return out;
  }
};

// --- ALPH: the alpha plane of a lossy WebP ----------------------------------------------

void alpha_plane(const uint8_t* d, size_t n, int w, int h, uint8_t* out) {
  if (n < 1) throw CodecError("empty ALPH chunk");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3, pre = (d[0] >> 4) & 3, rsrv = d[0] >> 6;
  if (method > 1 || pre > 1 || rsrv) throw CodecError("ALPH header with reserved values");
  const size_t size = static_cast<size_t>(w) * h;
  std::vector<uint8_t> raw(size);
  if (method == 0) {
    if (n - 1 < size) throw CodecError("truncated raw ALPH data");
    std::memcpy(raw.data(), d + 1, size);
  } else {
    VP8LDecoder dec(d + 1, n - 1);
    std::vector<uint32_t> argb = dec.image(w, h, true);
    for (size_t i = 0; i < size; ++i) raw[i] = static_cast<uint8_t>((argb[i] >> 8) & 0xff);
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = raw.data() + static_cast<size_t>(y) * w;
    uint8_t* row = out + static_cast<size_t>(y) * w;
    const uint8_t* prev = y ? row - w : nullptr;
    if (filter == 0) {
      std::memcpy(row, in, w);
    } else if (filter == 1 || prev == nullptr) {  // horizontal (and every filter's first row)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + in[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + in[x]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        left = static_cast<uint8_t>(in[x] + clip255(left + top - top_left));
        top_left = top;
        row[x] = left;
      }
    }
  }
}

// --- WebP lossy (VP8 key frames, RFC 6386) ----------------------------------------------

struct BoolDecoder {  // RFC 6386 section 7.3; reads zeros past the end, as libwebp does
  const uint8_t* d;
  size_t n, pos = 0;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  void init(const uint8_t* data, size_t size) {
    d = data;
    n = size;
    pos = 0;
    value = 0;
    for (int i = 0; i < 2; ++i) value = (value << 8) | next_byte();
    range = 255;
    bit_count = 0;
  }
  uint32_t next_byte() { return pos < n ? d[pos++] : 0; }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint32_t big = split << 8;
    int r;
    if (value >= big) {
      r = 1;
      range -= split;
      value -= big;
    } else {
      r = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next_byte();
      }
    }
    return r;
  }
  int literal(int bits) {
    int v = 0;
    while (bits-- > 0) v = (v << 1) | bit(128);
    return v;
  }
  int signed_literal(int bits) {
    const int v = literal(bits);
    return bit(128) ? -v : v;
  }
};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
// the intra 4x4 mode tree: leaves are -mode (DC 0, TM 1, VE 2, HE 3, RD 4,
// VR 5, LD 6, VL 7, HD 8, HU 9)
const int8_t kYModesIntra4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3, DC_NOTOP = 10, DC_NOLEFT = 11, DC_NOTOPLEFT = 12 };

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct VP8Decoder {
  int width, height, mbw, mbh;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  // segment and filter headers
  int use_segment = 0, update_map = 0, absolute_delta = 0;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  int seg_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  // quantizers: [segment][y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac]
  int dq[4][6];
  uint8_t probas[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  void parse_headers(const uint8_t* d, size_t n) {
    if (n < 10) throw CodecError("truncated VP8 frame header");
    const uint32_t bits = d[0] | (d[1] << 8) | (d[2] << 16);
    const bool key = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const uint32_t part0 = bits >> 5;
    if (!key) throw CodecError("a VP8 interframe (WebP holds key frames)");
    if (profile > 3) throw CodecError("VP8 profile past 3");
    if (!((bits >> 4) & 1)) throw CodecError("a VP8 frame that is not shown");
    if (d[3] != 0x9d || d[4] != 0x01 || d[5] != 0x2a) throw CodecError("VP8 start code missing");
    width = (d[6] | (d[7] << 8)) & 0x3fff;
    height = (d[8] | (d[9] << 8)) & 0x3fff;
    mbw = (width + 15) >> 4;
    mbh = (height + 15) >> 4;
    d += 10;
    n -= 10;
    if (part0 > n) throw CodecError("truncated VP8 first partition");
    br.init(d, part0);
    br.literal(1);  // colour space
    br.literal(1);  // clamping type
    // segment header
    use_segment = br.literal(1);
    if (use_segment) {
      update_map = br.literal(1);
      if (br.literal(1)) {
        absolute_delta = br.literal(1);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.literal(1) ? br.signed_literal(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.literal(1) ? br.signed_literal(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) seg_probs[s] = br.literal(1) ? br.literal(8) : 255;
    }
    // filter header
    simple = br.literal(1);
    level = br.literal(6);
    sharpness = br.literal(3);
    use_lf_delta = br.literal(1);
    if (use_lf_delta && br.literal(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.literal(1)) ref_lf_delta[i] = br.signed_literal(6);
      for (int i = 0; i < 4; ++i)
        if (br.literal(1)) mode_lf_delta[i] = br.signed_literal(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // partitions
    const int last = (1 << br.literal(2)) - 1;
    const uint8_t* sz = d + part0;
    size_t left = n - part0;
    if (left < 3u * last) throw CodecError("truncated VP8 partition sizes");
    const uint8_t* start = sz + 3 * last;
    left -= 3 * last;
    parts.resize(last + 1);
    for (int p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > left) psize = left;
      parts[p].init(start, psize);
      start += psize;
      left -= psize;
      sz += 3;
    }
    parts[last].init(start, left);
    // quantizers
    const int base_q0 = br.literal(7);
    const int dy1_dc = br.literal(1) ? br.signed_literal(4) : 0;
    const int dy2_dc = br.literal(1) ? br.signed_literal(4) : 0;
    const int dy2_ac = br.literal(1) ? br.signed_literal(4) : 0;
    const int duv_dc = br.literal(1) ? br.signed_literal(4) : 0;
    const int duv_ac = br.literal(1) ? br.signed_literal(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = quantizer[s];
        if (!absolute_delta) q += base_q0;
      } else {
        if (s > 0) {
          std::memcpy(dq[s], dq[0], sizeof(dq[0]));
          continue;
        }
        q = base_q0;
      }
      dq[s][0] = kDcTable[clip(q + dy1_dc, 127)];
      dq[s][1] = kAcTable[clip(q, 127)];
      dq[s][2] = kDcTable[clip(q + dy2_dc, 127)] * 2;
      dq[s][3] = (kAcTable[clip(q + dy2_ac, 127)] * 101581) >> 16;
      if (dq[s][3] < 8) dq[s][3] = 8;
      dq[s][4] = kDcTable[clip(q + duv_dc, 117)];
      dq[s][5] = kAcTable[clip(q + duv_ac, 127)];
    }
    br.literal(1);  // refresh_entropy_probs: nothing follows a key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p) {
            const int i = ((t * 8 + b) * 3 + c) * 11 + p;
            probas[t][b][c][p] = static_cast<uint8_t>(
                br.bit(kCoeffsUpdateProba[i]) ? br.literal(8) : kCoeffsProba0[i]);
          }
    use_skip = br.literal(1);
    if (use_skip) skip_p = br.literal(8);
    // filter strengths per segment and intra 4x4 or not
    if (filter_type > 0) {
      for (int s = 0; s < 4; ++s) {
        int base = level;
        if (use_segment) {
          base = filter_strength[s];
          if (!absolute_delta) base += level;
        }
        for (int i4 = 0; i4 <= 1; ++i4) {
          FInfo& f = fstrengths[s][i4];
          int lv = base;
          if (use_lf_delta) {
            lv += ref_lf_delta[0];
            if (i4) lv += mode_lf_delta[0];
          }
          lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
          if (lv > 0) {
            int il = lv;
            if (sharpness > 0) {
              il >>= sharpness > 4 ? 2 : 1;
              if (il > 9 - sharpness) il = 9 - sharpness;
            }
            if (il < 1) il = 1;
            f.ilevel = il;
            f.limit = 2 * lv + il;
            f.hev = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
          } else {
            f.limit = 0;
          }
          f.inner = i4;
        }
      }
    }
  }

  void parse_modes(MBData& b, uint8_t* top, uint8_t* left) {
    b.segment = update_map ? (!br.bit(seg_probs[0]) ? br.bit(seg_probs[1])
                                                    : br.bit(seg_probs[2]) + 2)
                           : 0;
    b.skip = use_skip ? br.bit(skip_p) : 0;
    b.is_i4x4 = !br.bit(145);
    if (!b.is_i4x4) {
      const int ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED)
                                    : (br.bit(163) ? V_PRED : DC_PRED);
      b.imodes[0] = static_cast<uint8_t>(ymode);
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = b.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
          int i = kYModesIntra4[br.bit(prob[0])];
          while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
          ymode = -i;
          top[x] = static_cast<uint8_t>(ymode);
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    b.uvmode = !br.bit(142) ? DC_PRED : !br.bit(114) ? V_PRED : br.bit(183) ? TM_PRED : H_PRED;
  }

  static int large_value(BoolDecoder& t, const uint8_t* p) {
    int v;
    if (!t.bit(p[3])) {
      v = !t.bit(p[4]) ? 2 : 3 + t.bit(p[5]);
    } else if (!t.bit(p[6])) {
      if (!t.bit(p[7])) {
        v = 5 + t.bit(159);
      } else {
        v = 7 + 2 * t.bit(165);
        v += t.bit(145);
      }
    } else {
      const int bit1 = t.bit(p[8]);
      const int bit0 = t.bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + t.bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // the index past the last coefficient read (libwebp's GetCoeffs)
  int coeffs(BoolDecoder& t, int type, int ctx, int dc_q, int ac_q, int n, int16_t* out) {
    const uint8_t* p = probas[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!t.bit(p[0])) return n;
      while (!t.bit(p[1])) {
        p = probas[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!t.bit(p[2])) {
        v = 1;
        p = probas[type][kBands[n + 1]][1];
      } else {
        v = large_value(t, p);
        p = probas[type][kBands[n + 1]][2];
      }
      const int sign = t.bit(128);
      out[kZigzag[n]] = static_cast<int16_t>((sign ? -v : v) * (n > 0 ? ac_q : dc_q));
    }
    return 16;
  }

  static uint32_t nz_code(uint32_t codes, int nz, int dc_nz) {
    codes <<= 2;
    codes |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return codes;
  }

  static void wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
      const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
      const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
      tmp[0 + i] = a0 + a1;
      tmp[8 + i] = a0 - a1;
      tmp[4 + i] = a3 + a2;
      tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
      const int dc = tmp[0 + i * 4] + 3;
      const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
      const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
      out[0] = static_cast<int16_t>((a0 + a1) >> 3);
      out[16] = static_cast<int16_t>((a3 + a2) >> 3);
      out[32] = static_cast<int16_t>((a0 - a1) >> 3);
      out[48] = static_cast<int16_t>((a3 - a2) >> 3);
      out += 64;
    }
  }

  // libwebp's ParseResiduals; returns whether every coefficient is zero
  bool residuals(MBData& b, MBInfo& mb, MBInfo& left, BoolDecoder& t) {
    const int* q = dq[b.segment];
    int16_t* dst = b.coeffs;
    std::memset(dst, 0, sizeof(b.coeffs));
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    int first, ac_type;
    if (!b.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = coeffs(t, 1, ctx, q[2], q[3], 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nzc = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = coeffs(t, ac_type, ctx, q[0], q[1], first, dst);
        l = nz > first;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        nzc = nz_code(nzc, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nzc;
    }
    uint32_t out_t = tnz, out_l = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nzc = 0;
      tnz = mb.nz >> (4 + ch);
      lnz = left.nz >> (4 + ch);
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = coeffs(t, 2, ctx, q[4], q[5], 0, dst);
          l = nz > 0;
          tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
          nzc = nz_code(nzc, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nzc << (4 * ch);
      out_t |= static_cast<uint32_t>(tnz << 4) << ch;
      out_l |= static_cast<uint32_t>(lnz & 0xf0) << ch;
    }
    mb.nz = static_cast<uint8_t>(out_t);
    left.nz = static_cast<uint8_t>(out_l);
    b.non_zero_y = non_zero_y;
    b.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }
};

// --- reconstruction: predictors and inverse transforms on a padded plane -----------------

inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void idct_add(const int16_t* in, uint8_t* dst, int bps) {
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = static_cast<uint8_t>(clip255(dst[0] + ((a + d) >> 3)));
    dst[1] = static_cast<uint8_t>(clip255(dst[1] + ((b + c) >> 3)));
    dst[2] = static_cast<uint8_t>(clip255(dst[2] + ((b - c) >> 3)));
    dst[3] = static_cast<uint8_t>(clip255(dst[3] + ((a - d) >> 3)));
    ++tmp;
    dst += bps;
  }
}

void true_motion(uint8_t* dst, int bps, int size) {
  const uint8_t* top = dst - bps;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = static_cast<uint8_t>(clip255(top[x] + l - tl));
    dst += bps;
  }
}

void pred_block(uint8_t* dst, int bps, int size, int mode) {
  const uint8_t* top = dst - bps;
  const int shift = size == 16 ? 5 : 4;
  int dc = 0;
  switch (mode) {
    case DC_PRED:
      for (int i = 0; i < size; ++i) dc += top[i] + dst[-1 + i * bps];
      dc = (dc + (1 << (shift - 1))) >> shift;
      break;
    case DC_NOTOP:
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * bps];
      dc = (dc + (1 << (shift - 2))) >> (shift - 1);
      break;
    case DC_NOLEFT:
      for (int i = 0; i < size; ++i) dc += top[i];
      dc = (dc + (1 << (shift - 2))) >> (shift - 1);
      break;
    case DC_NOTOPLEFT:
      dc = 0x80;
      break;
    case TM_PRED:
      true_motion(dst, bps, size);
      return;
    case V_PRED:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * bps, top, size);
      return;
    case H_PRED:
      for (int y = 0; y < size; ++y) std::memset(dst + y * bps, dst[-1 + y * bps], size);
      return;
  }
  for (int y = 0; y < size; ++y) std::memset(dst + y * bps, dc, size);
}

void pred4(uint8_t* dst, int bps, int mode) {
  const uint8_t* top = dst - bps;
#define DST(x, y) dst[(x) + (y) * bps]
  const int I = dst[-1], J = dst[-1 + bps], K = dst[-1 + 2 * bps], L = dst[-1 + 3 * bps];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case 0: {  // DC
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * bps];
      dc >>= 3;
      for (int y = 0; y < 4; ++y) std::memset(dst + y * bps, dc, 4);
      break;
    }
    case 1:
      true_motion(dst, bps, 4);
      break;
    case 2: {  // VE
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y) std::memcpy(dst + y * bps, v, 4);
      break;
    }
    case 3:  // HE
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + bps, avg3(I, J, K), 4);
      std::memset(dst + 2 * bps, avg3(J, K, L), 4);
      std::memset(dst + 3 * bps, avg3(K, L, L), 4);
      break;
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // 9, HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
  }
#undef DST
}

// --- the loop filters (libwebp's dsp/dec.c) ----------------------------------------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = static_cast<uint8_t>(clip255(p0 + a2));
  p[0] = static_cast<uint8_t>(clip255(q0 - a1));
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = static_cast<uint8_t>(clip255(p1 + a3));
  p[-step] = static_cast<uint8_t>(clip255(p0 + a2));
  p[0] = static_cast<uint8_t>(clip255(q0 - a1));
  p[step] = static_cast<uint8_t>(clip255(q1 - a3));
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = static_cast<uint8_t>(clip255(p2 + a3));
  p[-2 * step] = static_cast<uint8_t>(clip255(p1 + a2));
  p[-step] = static_cast<uint8_t>(clip255(p0 + a1));
  p[0] = static_cast<uint8_t>(clip255(q0 - a1));
  p[step] = static_cast<uint8_t>(clip255(q1 - a2));
  p[2 * step] = static_cast<uint8_t>(clip255(q2 - a3));
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) filter2(p, hstride);
    else if (edge) filter6(p, hstride);
    else filter4(p, hstride);
  }
}

// --- YUV 4:2:0 to RGB: libwebp's fancy upsampler and yuv.h's fixed point ------------------

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255; }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234));
  rgb[1] = static_cast<uint8_t>(
      yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708));
  rgb[2] = static_cast<uint8_t>(yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685));
}

// UpsampleRgbaLinePair: one or two output rows from the chroma rows above
// (top) and below (cur) them; u and v each as in libwebp's packed pairs,
// whose halves never carry into each other
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
    yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
               top_dst + (2 * x - 1) * 4);
    yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
    if (bottom_y) {
      yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                 bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 2 * x * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
               top_dst + (len - 1) * 4);
    if (bottom_y)
      yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                 bottom_dst + (len - 1) * 4);
  }
}

// Decode a VP8 key frame into rgba (height x width x 4, alpha 255).
void vp8_decode(const uint8_t* data, size_t n, int want_w, int want_h, uint8_t* rgba) {
  VP8Decoder dec;
  dec.parse_headers(data, n);
  if (dec.width != want_w || dec.height != want_h)
    throw CodecError("the VP8 frame's size differs from its container's");
  if (want_w < 1 || want_h < 1) throw CodecError("a VP8 frame without pixels");
  const int mbw = dec.mbw, mbh = dec.mbh;
  // planes with a one-pixel border above and to the left (and room for the
  // intra 4x4 top-right pixels), at macroblock size
  const int ybps = mbw * 16 + 1 + 4, uvbps = mbw * 8 + 1;
  std::vector<uint8_t> Y(static_cast<size_t>(ybps) * (mbh * 16 + 1)),
      U(static_cast<size_t>(uvbps) * (mbh * 8 + 1)), V(U.size());
  uint8_t* y0 = Y.data() + ybps + 1;
  uint8_t* u0 = U.data() + uvbps + 1;
  uint8_t* v0 = V.data() + uvbps + 1;
  // libwebp predicts from a work block whose borders start 127 above and
  // 129 to the left; the top samples of each column it keeps unfiltered,
  // and the filter runs once the row is done, so predicting from the
  // unfiltered frame and filtering it afterwards gives its pixels
  std::vector<uint8_t> intra_t(4 * mbw, DC_PRED);
  std::vector<MBInfo> info(mbw);
  std::vector<FInfo> finfo(static_cast<size_t>(mbw) * mbh);
  std::vector<MBData> row(mbw);
  // the work block: 1 + 16 rows of BPS bytes
  const int BPS = 32;
  uint8_t ywork[BPS * 17], uwork[BPS * 9], vwork[BPS * 9];
  std::vector<uint8_t> top_y(16 * mbw), top_u(8 * mbw), top_v(8 * mbw);
  for (int mby = 0; mby < mbh; ++mby) {
    uint8_t intra_l[4] = {DC_PRED, DC_PRED, DC_PRED, DC_PRED};
    for (int mbx = 0; mbx < mbw; ++mbx) dec.parse_modes(row[mbx], &intra_t[4 * mbx], intra_l);
    BoolDecoder& tok = dec.parts[mby & (dec.parts.size() - 1)];
    MBInfo left;
    for (int mbx = 0; mbx < mbw; ++mbx) {
      MBData& b = row[mbx];
      int skip = dec.use_skip ? b.skip : 0;
      if (!skip) {
        skip = dec.residuals(b, info[mbx], left, tok);
      } else {
        left.nz = info[mbx].nz = 0;
        if (!b.is_i4x4) left.nz_dc = info[mbx].nz_dc = 0;
        b.non_zero_y = b.non_zero_uv = 0;
        std::memset(b.coeffs, 0, sizeof(b.coeffs));
      }
      if (dec.filter_type > 0) {
        FInfo f = dec.fstrengths[b.segment][b.is_i4x4];
        f.inner |= !skip;
        finfo[static_cast<size_t>(mby) * mbw + mbx] = f;
      }
    }
    // reconstruct the row (libwebp's ReconstructRow)
    uint8_t* yd = ywork + BPS + 8;
    uint8_t* ud = uwork + BPS + 8;
    uint8_t* vd = vwork + BPS + 8;
    for (int j = 0; j < 16; ++j) yd[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) ud[j * BPS - 1] = vd[j * BPS - 1] = 129;
    if (mby > 0) {
      yd[-1 - BPS] = ud[-1 - BPS] = vd[-1 - BPS] = 129;
    } else {
      std::memset(yd - BPS - 1, 127, 16 + 4 + 1);
      std::memset(ud - BPS - 1, 127, 8 + 1);
      std::memset(vd - BPS - 1, 127, 8 + 1);
    }
    for (int mbx = 0; mbx < mbw; ++mbx) {
      const MBData& b = row[mbx];
      if (mbx > 0) {
        for (int j = -1; j < 16; ++j) std::memcpy(yd + j * BPS - 4, yd + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(ud + j * BPS - 4, ud + j * BPS + 4, 4);
          std::memcpy(vd + j * BPS - 4, vd + j * BPS + 4, 4);
        }
      }
      if (mby > 0) {
        std::memcpy(yd - BPS, &top_y[16 * mbx], 16);
        std::memcpy(ud - BPS, &top_u[8 * mbx], 8);
        std::memcpy(vd - BPS, &top_v[8 * mbx], 8);
      }
      if (b.is_i4x4) {
        uint8_t* top_right = yd - BPS + 16;
        if (mby > 0) {
          if (mbx >= mbw - 1) std::memset(top_right, top_y[16 * mbx + 15], 4);
          else std::memcpy(top_right, &top_y[16 * (mbx + 1)], 4);
        }
        for (int r = 1; r <= 3; ++r) std::memcpy(top_right + r * 4 * BPS, top_right, 4);
        for (int k = 0; k < 16; ++k) {
          uint8_t* dst = yd + (k & 3) * 4 + (k >> 2) * 4 * BPS;
          pred4(dst, BPS, b.imodes[k]);
          idct_add(b.coeffs + k * 16, dst, BPS);
        }
      } else {
        int mode = b.imodes[0];
        if (mode == DC_PRED) mode = mbx == 0 ? (mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                             : (mby == 0 ? DC_NOTOP : DC_PRED);
        pred_block(yd, BPS, 16, mode);
        for (int k = 0; k < 16; ++k)
          idct_add(b.coeffs + k * 16, yd + (k & 3) * 4 + (k >> 2) * 4 * BPS, BPS);
      }
      int uvmode = b.uvmode;
      if (uvmode == DC_PRED) uvmode = mbx == 0 ? (mby == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                                               : (mby == 0 ? DC_NOTOP : DC_PRED);
      pred_block(ud, BPS, 8, uvmode);
      pred_block(vd, BPS, 8, uvmode);
      for (int k = 0; k < 4; ++k) {
        idct_add(b.coeffs + 256 + k * 16, ud + (k & 1) * 4 + (k >> 1) * 4 * BPS, BPS);
        idct_add(b.coeffs + 320 + k * 16, vd + (k & 1) * 4 + (k >> 1) * 4 * BPS, BPS);
      }
      if (mby < mbh - 1) {
        std::memcpy(&top_y[16 * mbx], yd + 15 * BPS, 16);
        std::memcpy(&top_u[8 * mbx], ud + 7 * BPS, 8);
        std::memcpy(&top_v[8 * mbx], vd + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(y0 + static_cast<size_t>(mby * 16 + j) * ybps + mbx * 16, yd + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        std::memcpy(u0 + static_cast<size_t>(mby * 8 + j) * uvbps + mbx * 8, ud + j * BPS, 8);
        std::memcpy(v0 + static_cast<size_t>(mby * 8 + j) * uvbps + mbx * 8, vd + j * BPS, 8);
      }
    }
    // the loop filter of the row's macroblocks, left to right
    if (dec.filter_type > 0) {
      for (int mbx = 0; mbx < mbw; ++mbx) {
        const FInfo& f = finfo[static_cast<size_t>(mby) * mbw + mbx];
        if (f.limit == 0) continue;
        uint8_t* yp = y0 + static_cast<size_t>(mby * 16) * ybps + mbx * 16;
        const int limit = f.limit, il = f.ilevel;
        if (dec.filter_type == 1) {
          if (mbx > 0) simple_filter(yp, 1, ybps, 16, limit + 4);
          if (f.inner)
            for (int k = 1; k < 4; ++k) simple_filter(yp + 4 * k, 1, ybps, 16, limit);
          if (mby > 0) simple_filter(yp, ybps, 1, 16, limit + 4);
          if (f.inner)
            for (int k = 1; k < 4; ++k) simple_filter(yp + 4 * k * ybps, ybps, 1, 16, limit);
        } else {
          uint8_t* up = u0 + static_cast<size_t>(mby * 8) * uvbps + mbx * 8;
          uint8_t* vp = v0 + static_cast<size_t>(mby * 8) * uvbps + mbx * 8;
          const int hv = f.hev;
          if (mbx > 0) {
            filter_loop(yp, 1, ybps, 16, limit + 4, il, hv, true);
            filter_loop(up, 1, uvbps, 8, limit + 4, il, hv, true);
            filter_loop(vp, 1, uvbps, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k < 4; ++k) filter_loop(yp + 4 * k, 1, ybps, 16, limit, il, hv, false);
            filter_loop(up + 4, 1, uvbps, 8, limit, il, hv, false);
            filter_loop(vp + 4, 1, uvbps, 8, limit, il, hv, false);
          }
          if (mby > 0) {
            filter_loop(yp, ybps, 1, 16, limit + 4, il, hv, true);
            filter_loop(up, uvbps, 1, 8, limit + 4, il, hv, true);
            filter_loop(vp, uvbps, 1, 8, limit + 4, il, hv, true);
          }
          if (f.inner) {
            for (int k = 1; k < 4; ++k)
              filter_loop(yp + 4 * k * ybps, ybps, 1, 16, limit, il, hv, false);
            filter_loop(up + 4 * uvbps, uvbps, 1, 8, limit, il, hv, false);
            filter_loop(vp + 4 * uvbps, uvbps, 1, 8, limit, il, hv, false);
          }
        }
      }
    }
  }
  // EmitFancyRGB over the whole frame: row 0 from chroma row 0 alone, rows
  // 2k - 1 and 2k from chroma rows k - 1 and k, an even height's last row
  // from the last chroma row alone
  const int w = want_w, h = want_h;
  const size_t stride = static_cast<size_t>(w) * 4;
  auto yrow = [&](int r) { return y0 + static_cast<size_t>(r) * ybps; };
  auto urow = [&](int r) { return u0 + static_cast<size_t>(r) * uvbps; };
  auto vrow = [&](int r) { return v0 + static_cast<size_t>(r) * uvbps; };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), rgba, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const int k = y / 2;
    upsample_pair(yrow(y + 1), yrow(y + 2), urow(k), vrow(k), urow(k + 1), vrow(k + 1),
                  rgba + (y + 1) * stride, rgba + (y + 2) * stride, w);
  }
  if (!(h & 1)) {
    const int k = (h - 1) / 2;
    upsample_pair(yrow(h - 1), nullptr, urow(k), vrow(k), urow(k), vrow(k),
                  rgba + (h - 1) * stride, nullptr, w);
  }
  for (size_t i = 3; i < static_cast<size_t>(w) * h * 4; i += 4) rgba[i] = 255;
}

}  // namespace

extern "C" {

long ic_gif_lzw(const uint8_t* data, size_t n, int min_bits, uint8_t* out, long npix, char* err,
                int errlen) {
  try {
    return gif_lzw(data, n, min_bits, out, npix);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

long ic_tiff_lzw(const uint8_t* data, size_t n, uint8_t* out, size_t cap, char* err, int errlen) {
  try {
    return tiff_lzw(data, n, out, cap);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

long ic_packbits(const uint8_t* data, size_t n, uint8_t* out, size_t cap) {
  return packbits(data, n, out, cap);
}

// a VP8L image: with its 5-byte header (headerless = 0) or, for an ALPH
// chunk, without one; argb holds width x height pixels
int ic_vp8l(const uint8_t* data, size_t n, int width, int height, uint32_t* argb, char* err,
            int errlen) {
  try {
    if (n < 5 || data[0] != 0x2f) throw CodecError("not a VP8L bitstream (signature 0x2f)");
    VP8LDecoder dec(data + 1, n - 1);
    const int w = dec.br.read(14) + 1, h = dec.br.read(14) + 1;
    dec.br.read(1);  // alpha_is_used: a hint
    if (dec.br.read(3) != 0) throw CodecError("VP8L version other than 0");
    if (w != width || h != height) throw CodecError("the VP8L image's size differs from its container's");
    std::vector<uint32_t> px = dec.image(w, h, true);
    std::memcpy(argb, px.data(), px.size() * 4);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

int ic_alpha(const uint8_t* data, size_t n, int width, int height, uint8_t* out, char* err,
             int errlen) {
  try {
    alpha_plane(data, n, width, height, out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

int ic_vp8(const uint8_t* data, size_t n, int width, int height, uint8_t* rgba, char* err,
           int errlen) {
  try {
    vp8_decode(data, n, width, height, rgba);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

}  // extern "C"
