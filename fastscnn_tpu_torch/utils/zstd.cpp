// Zstandard (RFC 8878) decoder, a raw-block encoder, CRC-32C and XXH64:
// the codecs of an Orbax checkpoint (OCDBT nodes and zarr chunks), with a
// plain C interface for ctypes (utils/zstd.py).
//
// The decoder reads every frame a conforming encoder writes without a
// dictionary: skippable frames; raw, RLE and compressed blocks; literals
// raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the previous
// block's table); sequences whose three codes are predefined, RLE,
// FSE-coded or repeated, with the three repeat offsets; any window size up
// to 2 GiB, a frame content size present or absent, and the XXH64 content
// checksum where the frame carries one. Whatever it cannot read raises
// with the reason: a dictionary ID, a reserved field, a truncated or
// corrupt frame, a bad checksum. The encoder writes raw blocks only: a
// valid frame that every decoder reads, not a smaller one.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Error(what); }

int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

// ---------------------------------------------------------------- CRC-32C

struct CrcTables {
    uint32_t t[8][256];
    CrcTables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};

const CrcTables kCrc;

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
    crc = ~crc;
    while (n >= 8) {  // slicing by 8
        uint64_t v;
        std::memcpy(&v, p, 8);
        v ^= crc;
        crc = kCrc.t[7][v & 0xFF] ^ kCrc.t[6][(v >> 8) & 0xFF] ^ kCrc.t[5][(v >> 16) & 0xFF] ^
              kCrc.t[4][(v >> 24) & 0xFF] ^ kCrc.t[3][(v >> 32) & 0xFF] ^
              kCrc.t[2][(v >> 40) & 0xFF] ^ kCrc.t[1][(v >> 48) & 0xFF] ^ kCrc.t[0][v >> 56];
        p += 8;
        n -= 8;
    }
    while (n--) crc = (crc >> 8) ^ kCrc.t[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

// ------------------------------------------------------------------ XXH64

const uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full,
               P3 = 0x165667B19E3779F9ull, P4 = 0x85EBCA77C2B2AE63ull,
               P5 = 0x27D4EB2F165667C5ull;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xround(v1, rd64(p));
            v2 = xround(v2, rd64(p + 8));
            v3 = xround(v3, rd64(p + 16));
            v4 = xround(v4, rd64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
    } else {
        h = seed + P5;
    }
    h += n;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    return h ^ (h >> 32);
}

// ------------------------------------------------------------ bit readers

uint64_t load_le(const uint8_t* p, size_t n, int64_t byte) {
    // the 8 bytes from `byte` on, little-endian, zero past the end
    if (byte + 8 <= int64_t(n)) return rd64(p + byte);
    uint64_t v = 0;
    for (int i = 0; i < 8 && byte + i < int64_t(n); ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return v;
}

uint64_t bits_at(const uint8_t* p, size_t n, int64_t start, int nb) {
    // bits [start, start + nb) of the little-endian stream, zero below 0
    if (nb == 0) return 0;
    if (start < 0) {
        if (start + nb <= 0) return 0;
        return bits_at(p, n, 0, int(start + nb)) << (-start);
    }
    uint64_t v = load_le(p, n, start >> 3) >> (start & 7);
    return v & ((uint64_t(1) << nb) - 1);
}

// Forward: FSE table descriptions.
struct FwdBits {
    const uint8_t* p;
    size_t n;
    int64_t pos = 0;
    uint32_t peek(int nb) const { return uint32_t(bits_at(p, n, pos, nb)); }
    uint32_t read(int nb) {
        uint32_t v = peek(nb);
        pos += nb;
        return v;
    }
};

// Backward: Huffman streams, FSE-coded weights and sequences. `pos` counts
// the bits not yet read; below 0 the reader has gone past the start.
struct BackBits {
    const uint8_t* p;
    size_t n;
    int64_t pos;
    BackBits(const uint8_t* src, size_t size, const char* what) : p(src), n(size) {
        if (size == 0) fail(std::string("empty ") + what + " bitstream");
        uint8_t last = src[size - 1];
        if (last == 0) fail(std::string(what) + " bitstream has no end marker");
        pos = int64_t(size - 1) * 8 + highbit(last);
    }
    uint64_t peek(int nb) const { return bits_at(p, n, pos - nb, nb); }
    uint64_t read(int nb) {
        pos -= nb;
        return bits_at(p, n, pos, nb);
    }
};

// -------------------------------------------------------------------- FSE

struct FseEntry {
    uint32_t baseline;
    uint8_t nb;
    uint8_t symbol;
};

struct Fse {
    int al = 0;
    std::vector<FseEntry> t;
};

// An FSE table description (RFC 8878 4.1.1); returns the bytes it takes.
size_t read_ncount(const uint8_t* p, size_t avail, int max_al, int max_sym,
                   std::vector<int16_t>& norm, int& al) {
    if (avail == 0) fail("truncated FSE table description");
    FwdBits br{p, avail};
    al = int(br.read(4)) + 5;
    if (al > max_al) fail("FSE accuracy log " + std::to_string(al) + " above " +
                          std::to_string(max_al));
    norm.assign(max_sym + 1, 0);
    int remaining = (1 << al) + 1, threshold = 1 << al, nbits = al + 1, sym = 0;
    bool prev0 = false;
    while (remaining > 1 && sym <= max_sym) {
        if (prev0) {
            int n0 = sym;
            for (;;) {
                int r = int(br.read(2));
                n0 += r;
                if (r != 3) break;
            }
            if (n0 > max_sym) fail("FSE table description runs past the last symbol");
            while (sym < n0) norm[sym++] = 0;
        }
        int max = (2 * threshold - 1) - remaining, count;
        uint32_t bits = br.peek(nbits);
        if (int(bits & (threshold - 1)) < max) {
            count = int(bits & (threshold - 1));
            br.pos += nbits - 1;
        } else {
            count = int(bits & (2 * threshold - 1));
            if (count >= threshold) count -= max;
            br.pos += nbits;
        }
        --count;
        remaining -= count < 0 ? -count : count;
        norm[sym++] = int16_t(count);
        prev0 = count == 0;
        while (remaining < threshold) {
            --nbits;
            threshold >>= 1;
        }
    }
    if (remaining != 1) fail("FSE probabilities do not sum to the table size");
    size_t used = size_t((br.pos + 7) >> 3);
    if (used > avail) fail("truncated FSE table description");
    return used;
}

void build_fse(const std::vector<int16_t>& norm, int al, Fse& f) {
    const int size = 1 << al;
    f.al = al;
    f.t.assign(size, FseEntry{0, 0, 0});
    int high = size - 1;
    std::vector<uint32_t> next(norm.size());
    for (size_t s = 0; s < norm.size(); ++s) {
        if (norm[s] == -1) {
            f.t[high--].symbol = uint8_t(s);
            next[s] = 1;
        } else {
            next[s] = uint32_t(norm[s]);
        }
    }
    const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    int pos = 0;
    for (size_t s = 0; s < norm.size(); ++s) {
        for (int i = 0; i < norm[s]; ++i) {
            f.t[pos].symbol = uint8_t(s);
            do pos = (pos + step) & mask;
            while (pos > high);
        }
    }
    if (pos != 0) fail("FSE table spread does not close");
    for (int i = 0; i < size; ++i) {
        uint32_t ns = next[f.t[i].symbol]++;
        int nb = al - highbit(ns);
        f.t[i].nb = uint8_t(nb);
        f.t[i].baseline = (ns << nb) - uint32_t(size);
    }
}

void rle_fse(uint8_t symbol, Fse& f) {
    f.al = 0;
    f.t.assign(1, FseEntry{0, 0, symbol});
}

// ---------------------------------------------------------------- Huffman

struct Huf {
    int max_bits = 0;
    std::vector<uint16_t> t;  // symbol | bits << 8, indexed by the next max_bits bits
};

// Stats slots (zs_decompress's `stats`, which utils/zstd.py names).
enum {
    S_FRAMES, S_SKIPPABLE, S_RAW, S_RLE, S_COMPRESSED, S_MULTIBLOCK, S_LIT_RAW, S_LIT_RLE,
    S_HUF1, S_HUF4, S_TREELESS, S_WEIGHTS_FSE, S_WEIGHTS_DIRECT, S_SEQ_PREDEFINED, S_SEQ_RLE,
    S_SEQ_FSE, S_SEQ_REPEAT, S_CHECKSUMS, S_SEQUENCES, S_NO_SIZE, S_COUNT
};

size_t read_huffman_tree(const uint8_t* p, size_t avail, Huf& h, int64_t* stats) {
    if (avail == 0) fail("truncated Huffman tree description");
    std::vector<uint8_t> w;
    size_t used;
    const int hb = p[0];
    if (hb >= 128) {
        const int ns = hb - 127;
        used = 1 + size_t((ns + 1) / 2);
        if (used > avail) fail("truncated Huffman weights");
        for (int i = 0; i < ns; ++i)
            w.push_back(i % 2 == 0 ? p[1 + i / 2] >> 4 : p[1 + i / 2] & 15);
        stats[S_WEIGHTS_DIRECT]++;
    } else {
        used = 1 + size_t(hb);
        if (used > avail || hb == 0) fail("truncated FSE-coded Huffman weights");
        std::vector<int16_t> norm;
        int al;
        size_t hdr = read_ncount(p + 1, size_t(hb), 6, 255, norm, al);
        Fse f;
        build_fse(norm, al, f);
        BackBits br(p + 1 + hdr, size_t(hb) - hdr, "Huffman weights");
        uint32_t s1 = uint32_t(br.read(al)), s2 = uint32_t(br.read(al));
        // two interleaved states, as zstd's decoder reads them: when an
        // update runs past the start, the other state's symbol is the last
        for (;;) {
            if (w.size() >= 255) fail("more than 255 Huffman weights");
            const FseEntry& e1 = f.t[s1];
            w.push_back(e1.symbol);
            s1 = e1.baseline + uint32_t(br.read(e1.nb));
            if (br.pos < 0) {
                w.push_back(f.t[s2].symbol);
                break;
            }
            if (w.size() >= 255) fail("more than 255 Huffman weights");
            const FseEntry& e2 = f.t[s2];
            w.push_back(e2.symbol);
            s2 = e2.baseline + uint32_t(br.read(e2.nb));
            if (br.pos < 0) {
                w.push_back(f.t[s1].symbol);
                break;
            }
        }
        stats[S_WEIGHTS_FSE]++;
    }
    uint32_t sum = 0;
    for (uint8_t x : w) {
        if (x > 11) fail("Huffman weight above 11");
        if (x) sum += 1u << (x - 1);
    }
    if (sum == 0) fail("Huffman weights all zero");
    const int max_bits = highbit(sum) + 1;
    const uint32_t rest = (1u << max_bits) - sum;
    if (rest & (rest - 1)) fail("Huffman weights leave no power of two for the last symbol");
    w.push_back(uint8_t(highbit(rest) + 1));
    if (max_bits > 11 || w.size() > 256) fail("Huffman table too large");
    uint32_t count[13] = {0}, start[13] = {0};
    for (uint8_t x : w) count[x]++;
    uint32_t next = 0;
    for (int x = 1; x <= max_bits; ++x) {
        start[x] = next;
        next += count[x] << (x - 1);
    }
    h.max_bits = max_bits;
    h.t.assign(size_t(1) << max_bits, 0);
    for (size_t s = 0; s < w.size(); ++s) {
        const int x = w[s];
        if (!x) continue;
        const uint32_t len = 1u << (x - 1);
        const uint16_t e = uint16_t(s | ((max_bits + 1 - x) << 8));
        for (uint32_t i = 0; i < len; ++i) h.t[start[x] + i] = e;
        start[x] += len;
    }
    return used;
}

void huffman_stream(const Huf& h, const uint8_t* src, size_t size, uint8_t* out, size_t count) {
    BackBits br(src, size, "Huffman");
    for (size_t i = 0; i < count; ++i) {
        uint16_t e = h.t[br.peek(h.max_bits)];
        out[i] = uint8_t(e & 0xFF);
        br.pos -= e >> 8;
    }
    if (br.pos != 0) fail("Huffman stream not consumed exactly");
}

// ------------------------------------------------------------- sequences

const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,   4,   5,    6,    7,    8,    9,     10,    11,   12,  13,
                              14,  15,  16,   17,   18,   19,   20,    21,    22,   23,  24,
                              25,  26,  27,   28,   29,   30,   31,    32,    33,   34,  35,
                              37,  39,  41,   43,   47,   51,   59,    67,    83,   99,  131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t LL_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                             2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_NORM[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_NORM[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
    Huf huf;
    bool have_huf = false;
    Fse ll, of, ml;
    bool have_ll = false, have_of = false, have_ml = false;
    uint64_t rep[3] = {1, 4, 8};
    size_t start = 0;  // of this frame's content in the output
    uint64_t window = 0;
    size_t block_max = 0;
};

size_t sequence_table(const char* name, int mode, const uint8_t* p, size_t avail, int max_al,
                      int max_sym, const int16_t* pre, int pre_n, int pre_al, Fse& f, bool& have,
                      int64_t* stats) {
    switch (mode) {
        case 0: {
            build_fse(std::vector<int16_t>(pre, pre + pre_n), pre_al, f);
            have = true;
            stats[S_SEQ_PREDEFINED]++;
            return 0;
        }
        case 1: {
            if (avail < 1) fail(std::string("truncated RLE ") + name + " code");
            if (p[0] > max_sym) fail(std::string(name) + " RLE code out of range");
            rle_fse(p[0], f);
            have = true;
            stats[S_SEQ_RLE]++;
            return 1;
        }
        case 2: {
            std::vector<int16_t> norm;
            int al;
            size_t used = read_ncount(p, avail, max_al, max_sym, norm, al);
            build_fse(norm, al, f);
            have = true;
            stats[S_SEQ_FSE]++;
            return used;
        }
        default:
            if (!have) fail(std::string("repeat mode for ") + name + " with no previous table");
            stats[S_SEQ_REPEAT]++;
            return 0;
    }
}

void compressed_block(const uint8_t* p, size_t n, std::vector<uint8_t>& out, Frame& fr,
                      int64_t* stats) {
    // literals section
    if (n < 1) fail("empty compressed block");
    const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
    size_t hdr, regen, csize = 0;
    std::vector<uint8_t> lits;
    if (ltype < 2) {
        if (sf == 0 || sf == 2) {
            hdr = 1;
            regen = p[0] >> 3;
        } else if (sf == 1) {
            hdr = 2;
            if (n < 2) fail("truncated literals header");
            regen = (p[0] >> 4) | (size_t(p[1]) << 4);
        } else {
            hdr = 3;
            if (n < 3) fail("truncated literals header");
            regen = (p[0] >> 4) | (size_t(p[1]) << 4) | (size_t(p[2]) << 12);
        }
        if (regen > fr.block_max) fail("literals larger than the block maximum");
        if (ltype == 0) {
            if (hdr + regen > n) fail("truncated raw literals");
            lits.assign(p + hdr, p + hdr + regen);
            hdr += regen;
            stats[S_LIT_RAW]++;
        } else {
            if (hdr + 1 > n) fail("truncated RLE literals");
            lits.assign(regen, p[hdr]);
            hdr += 1;
            stats[S_LIT_RLE]++;
        }
    } else {
        const int streams = sf == 0 ? 1 : 4;
        hdr = sf < 2 ? 3 : sf == 2 ? 4 : 5;
        if (n < hdr) fail("truncated literals header");
        if (hdr == 3) {
            regen = (p[0] >> 4) | (size_t(p[1] & 0x3F) << 4);
            csize = (p[1] >> 6) | (size_t(p[2]) << 2);
        } else if (hdr == 4) {
            regen = (p[0] >> 4) | (size_t(p[1]) << 4) | (size_t(p[2] & 3) << 12);
            csize = (p[2] >> 2) | (size_t(p[3]) << 6);
        } else {
            regen = (p[0] >> 4) | (size_t(p[1]) << 4) | (size_t(p[2] & 0x3F) << 12);
            csize = (p[2] >> 6) | (size_t(p[3]) << 2) | (size_t(p[4]) << 10);
        }
        if (regen > fr.block_max) fail("literals larger than the block maximum");
        if (hdr + csize > n) fail("truncated Huffman literals");
        const uint8_t* q = p + hdr;
        size_t qn = csize;
        if (ltype == 2) {
            size_t used = read_huffman_tree(q, qn, fr.huf, stats);
            fr.have_huf = true;
            q += used;
            qn -= used;
        } else {
            if (!fr.have_huf) fail("treeless literals with no previous Huffman table");
            stats[S_TREELESS]++;
        }
        lits.resize(regen);
        if (streams == 1) {
            huffman_stream(fr.huf, q, qn, lits.data(), regen);
            if (ltype == 2) stats[S_HUF1]++;
        } else {
            if (qn < 6) fail("truncated Huffman jump table");
            size_t s[4] = {size_t(q[0] | (q[1] << 8)), size_t(q[2] | (q[3] << 8)),
                           size_t(q[4] | (q[5] << 8)), 0};
            if (6 + s[0] + s[1] + s[2] > qn) fail("Huffman jump table past the literals");
            s[3] = qn - 6 - s[0] - s[1] - s[2];
            const size_t seg = (regen + 3) / 4;
            if (3 * seg > regen) fail("too few literals for four streams");
            const uint8_t* r = q + 6;
            for (int i = 0; i < 4; ++i) {
                huffman_stream(fr.huf, r, s[i], lits.data() + i * seg,
                               i < 3 ? seg : regen - 3 * seg);
                r += s[i];
            }
            if (ltype == 2) stats[S_HUF4]++;
        }
        hdr += csize;
    }
    p += hdr;
    n -= hdr;

    // sequences section
    if (n < 1) fail("truncated sequences section");
    size_t nseq;
    if (p[0] == 0) {
        if (n != 1) fail("bytes after an empty sequences section");
        out.insert(out.end(), lits.begin(), lits.end());
        return;
    } else if (p[0] < 128) {
        nseq = p[0];
        p += 1;
        n -= 1;
    } else if (p[0] < 255) {
        if (n < 2) fail("truncated sequence count");
        nseq = (size_t(p[0] - 128) << 8) + p[1];
        p += 2;
        n -= 2;
    } else {
        if (n < 3) fail("truncated sequence count");
        nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
        p += 3;
        n -= 3;
    }
    if (n < 1) fail("truncated sequence modes");
    const int modes = p[0];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    p += 1;
    n -= 1;
    size_t u = sequence_table("literal length", modes >> 6, p, n, 9, 35, LL_NORM, 36, 6, fr.ll,
                              fr.have_ll, stats);
    p += u;
    n -= u;
    u = sequence_table("offset", (modes >> 4) & 3, p, n, 8, 31, OF_NORM, 29, 5, fr.of, fr.have_of,
                       stats);
    p += u;
    n -= u;
    u = sequence_table("match length", (modes >> 2) & 3, p, n, 9, 52, ML_NORM, 53, 6, fr.ml,
                       fr.have_ml, stats);
    p += u;
    n -= u;
    for (const FseEntry& e : fr.ll.t) if (e.symbol > 35) fail("literal length code out of range");
    for (const FseEntry& e : fr.ml.t) if (e.symbol > 52) fail("match length code out of range");
    for (const FseEntry& e : fr.of.t) if (e.symbol > 31) fail("offset code out of range");

    BackBits br(p, n, "sequences");
    uint32_t sll = uint32_t(br.read(fr.ll.al)), sof = uint32_t(br.read(fr.of.al)),
             sml = uint32_t(br.read(fr.ml.al));
    size_t lit_pos = 0;
    const size_t block_start = out.size();
    for (size_t i = 0; i < nseq; ++i) {
        const FseEntry &ell = fr.ll.t[sll], &eof = fr.of.t[sof], &eml = fr.ml.t[sml];
        const int ofc = eof.symbol;
        const uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
        const uint64_t ml = ML_BASE[eml.symbol] + br.read(ML_BITS[eml.symbol]);
        const uint64_t ll = LL_BASE[ell.symbol] + br.read(LL_BITS[ell.symbol]);
        uint64_t offset;
        if (ofv > 3) {
            offset = ofv - 3;
            fr.rep[2] = fr.rep[1];
            fr.rep[1] = fr.rep[0];
            fr.rep[0] = offset;
        } else {
            const int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
            if (idx == 0) {
                offset = fr.rep[0];
            } else {
                offset = idx == 3 ? fr.rep[0] - 1 : fr.rep[idx];
                if (idx > 1) fr.rep[2] = fr.rep[1];
                fr.rep[1] = fr.rep[0];
                fr.rep[0] = offset;
            }
        }
        if (i + 1 < nseq) {
            sll = ell.baseline + uint32_t(br.read(ell.nb));
            sml = eml.baseline + uint32_t(br.read(eml.nb));
            sof = eof.baseline + uint32_t(br.read(eof.nb));
        }
        if (br.pos < 0) fail("sequences bitstream overread");
        if (ll > lits.size() - lit_pos) fail("sequence takes more literals than the block has");
        out.insert(out.end(), lits.begin() + lit_pos, lits.begin() + lit_pos + ll);
        lit_pos += ll;
        const size_t have = out.size() - fr.start;
        if (offset == 0 || offset > have || offset > fr.window)
            fail("match offset " + std::to_string(offset) + " outside the window");
        if (out.size() - block_start + ml > fr.block_max) fail("block larger than its maximum");
        const size_t from = out.size() - offset, at = out.size();
        out.resize(at + ml);
        uint8_t* o = out.data();
        if (offset >= ml) {
            std::memcpy(o + at, o + from, ml);
        } else {
            for (size_t k = 0; k < ml; ++k) o[at + k] = o[from + k];
        }
    }
    if (br.pos != 0) fail("sequences bitstream not consumed exactly");
    stats[S_SEQUENCES] += int64_t(nseq);
    out.insert(out.end(), lits.begin() + lit_pos, lits.end());
    if (out.size() - block_start > fr.block_max) fail("block larger than its maximum");
}

size_t frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out, int64_t* stats) {
    // returns the bytes the frame takes; p points at its magic number
    size_t i = 4;
    if (n < 5) fail("truncated frame header");
    const int fhd = p[i++];
    const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
              did_flag = fhd & 3;
    if (fhd & 8) fail("reserved bit set in the frame header");
    Frame fr;
    uint64_t window = 0;
    if (!single) {
        if (i >= n) fail("truncated frame header");
        const int wd = p[i++];
        const int wlog = 10 + (wd >> 3);
        if (wlog > 31) fail("window size above 2 GiB");
        const uint64_t base = uint64_t(1) << wlog;
        window = base + (base / 8) * (wd & 7);
    }
    const int did_bytes[4] = {0, 1, 2, 4};
    if (i + did_bytes[did_flag] > n) fail("truncated frame header");
    uint64_t did = 0;
    for (int k = 0; k < did_bytes[did_flag]; ++k) did |= uint64_t(p[i + k]) << (8 * k);
    i += did_bytes[did_flag];
    if (did) fail("frame needs dictionary " + std::to_string(did) + ": dictionaries are not read");
    const int fcs_bytes[4] = {single ? 1 : 0, 2, 4, 8};
    const int fb = fcs_bytes[fcs_flag];
    bool has_size = fb > 0;
    uint64_t fcs = 0;
    if (i + fb > n) fail("truncated frame header");
    for (int k = 0; k < fb; ++k) fcs |= uint64_t(p[i + k]) << (8 * k);
    if (fb == 2) fcs += 256;
    i += fb;
    if (single) window = fcs;
    if (!has_size) stats[S_NO_SIZE]++;
    fr.window = window;
    fr.block_max = size_t(window < 131072 ? window : 131072);
    fr.start = out.size();
    if (has_size) {
        if (fcs > (uint64_t(1) << 40)) fail("frame content size too large");
        out.reserve(out.size() + fcs);
    }
    int blocks = 0;
    for (;;) {
        if (i + 3 > n) fail("truncated block header");
        const uint32_t bh = p[i] | (p[i + 1] << 8) | (uint32_t(p[i + 2]) << 16);
        i += 3;
        const int last = bh & 1, type = (bh >> 1) & 3;
        const size_t size = bh >> 3;
        ++blocks;
        if (type == 3) fail("reserved block type");
        if (size > fr.block_max) fail("block larger than its maximum");
        if (type == 1) {
            if (i + 1 > n) fail("truncated RLE block");
            out.insert(out.end(), size, p[i]);
            i += 1;
            stats[S_RLE]++;
        } else {
            if (i + size > n) fail("truncated block");
            if (type == 0) {
                out.insert(out.end(), p + i, p + i + size);
                stats[S_RAW]++;
            } else {
                compressed_block(p + i, size, out, fr, stats);
                stats[S_COMPRESSED]++;
            }
            i += size;
        }
        if (last) break;
    }
    if (blocks > 1) stats[S_MULTIBLOCK]++;
    const size_t got = out.size() - fr.start;
    if (has_size && got != fcs)
        fail("frame content size " + std::to_string(fcs) + " but " + std::to_string(got) +
             " bytes decoded");
    if (checksum) {
        if (i + 4 > n) fail("truncated content checksum");
        const uint32_t want = rd32(p + i);
        if (uint32_t(xxh64(out.data() + fr.start, got, 0)) != want)
            fail("content checksum mismatch");
        i += 4;
        stats[S_CHECKSUMS]++;
    }
    stats[S_FRAMES]++;
    return i;
}

void set_err(char* err, int errlen, const char* what) {
    if (err && errlen > 0) {
        std::strncpy(err, what, size_t(errlen) - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

uint32_t zs_crc32c(const uint8_t* p, size_t n, uint32_t crc) { return crc32c(p, n, crc); }

uint64_t zs_xxh64(const uint8_t* p, size_t n, uint64_t seed) { return xxh64(p, n, seed); }

int zs_stat_count() { return S_COUNT; }

void zs_free(void* p) { std::free(p); }

// Decode every frame of src into a buffer malloc'ed at *out (zs_free it);
// returns its length, or -1 with the reason in err. stats (zs_stat_count
// slots, or null) gains what the frames held.
int64_t zs_decompress(const uint8_t* src, size_t n, uint8_t** out, int64_t* stats, char* err,
                      int errlen) {
    int64_t local[S_COUNT] = {0};
    if (!stats) stats = local;
    *out = nullptr;
    try {
        std::vector<uint8_t> buf;
        size_t i = 0;
        if (n == 0) fail("no frame");
        while (i < n) {
            if (n - i < 4) fail("truncated magic number");
            const uint32_t magic = rd32(src + i);
            if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
                if (n - i < 8) fail("truncated skippable frame");
                const size_t size = rd32(src + i + 4);
                if (size > n - i - 8) fail("truncated skippable frame");
                i += 8 + size;
                stats[S_SKIPPABLE]++;
            } else if (magic == 0xFD2FB528u) {
                i += frame(src + i, n - i, buf, stats);
            } else {
                fail("not a zstd frame (magic number)");
            }
        }
        uint8_t* o = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
        if (!o) fail("out of memory");
        if (!buf.empty()) std::memcpy(o, buf.data(), buf.size());
        *out = o;
        return int64_t(buf.size());
    } catch (const std::exception& e) {
        set_err(err, errlen, e.what());
        return -1;
    }
}

size_t zs_compress_bound(size_t n) { return 4 + 1 + 8 + 3 * (n / 131072 + 1) + n + 4; }

// One frame of raw blocks (at most 128 KiB each), the content size in the
// header, and the XXH64 checksum when `checksum`; returns its length, or
// -1 when cap is below zs_compress_bound(n).
int64_t zs_compress_raw(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, int checksum) {
    if (cap < zs_compress_bound(n)) return -1;
    uint8_t* o = dst;
    const uint32_t magic = 0xFD2FB528u;
    std::memcpy(o, &magic, 4);
    o += 4;
    int flag, fb;
    uint64_t fcs = n;
    if (n < 256) {
        flag = 0, fb = 1;
    } else if (n < 65536 + 256) {
        flag = 1, fb = 2, fcs -= 256;
    } else if (n <= 0xFFFFFFFFull) {
        flag = 2, fb = 4;
    } else {
        flag = 3, fb = 8;
    }
    *o++ = uint8_t((flag << 6) | (1 << 5) | (checksum ? 4 : 0));
    for (int k = 0; k < fb; ++k) *o++ = uint8_t(fcs >> (8 * k));
    size_t i = 0;
    do {
        const size_t size = n - i < 131072 ? n - i : 131072;
        const uint32_t last = i + size == n ? 1 : 0, bh = last | uint32_t(size << 3);
        *o++ = uint8_t(bh);
        *o++ = uint8_t(bh >> 8);
        *o++ = uint8_t(bh >> 16);
        if (size) std::memcpy(o, src + i, size);
        o += size;
        i += size;
    } while (i < n);
    if (checksum) {
        const uint32_t h = uint32_t(xxh64(src, n, 0));
        std::memcpy(o, &h, 4);
        o += 4;
    }
    return int64_t(o - dst);
}

}  // extern "C"
