"""JPEG writers from ITU-T T.81, for the fixtures Pillow cannot write.

Pillow's encoder writes baseline and progressive Huffman files at 4:4:4,
4:2:2 and 4:2:0, and CMYK. The variants below, which libjpeg-turbo (and so
Pillow) decodes, are written here with numpy alone:

- :func:`dct_jpeg`: sequential Huffman (SOF1), sequential arithmetic
  (SOF9) or progressive arithmetic (SOF10) files of 1, 3 or 4 components
  at any integral sampling factors 1-4 (4:1:1, 4:4:0, 4:1:0, mixed
  factors), interleaved or one scan a component, with an Adobe APP14
  marker (CMYK or YCCK) or component ids that name the colour space,
  restart intervals, and DAC conditioning for the arithmetic coder;
- :func:`lossless_jpeg`: lossless Huffman (SOF3) files, predictors 1-7,
  point transform, restart intervals.

The arithmetic coder is the QM coder of T.81 Annex D with the statistics
model of Annex F.1.4 (sequential) and G.1.3 (progressive), as libjpeg's
``jcarith.c`` lays it out. The files are fixtures: Pillow's decode of
each sets its digest, so a wrong writer shows as a file Pillow refuses.
"""

from __future__ import annotations

import struct

import numpy as np

# T.81 Annex K.1 quantization tables, natural order
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
# T.81 Annex K.3 Huffman tables: code counts by length 1..16, then values
DC_BITS = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
           [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
DC_VALS = list(range(12))
AC_BITS = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
           [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
AC_VALS = (bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"),
    bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f117"
    "18191a262728292a35363738393a434445464748494a535455565758595a636465666768696a737475767778"
    "797a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))
# T.81 Table D.2: Qe, next index after LPS, next index after MPS, MPS switch;
# entry 113 is the fixed 0.5 estimate libjpeg keeps for signs and refinements
QE_TABLE = [
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0)]
FIXED = 113


def zigzag() -> np.ndarray:
    """natural index of the k-th coefficient in zigzag order"""
    order = sorted(((r + c, (r if (r + c) % 2 else c), r * 8 + c)
                    for r in range(8) for c in range(8)))
    return np.array([n for _, _, n in order])


ZIGZAG = zigzag()


def scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _marker(code: int, body: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(body) + 2) + body


class BitWriter:
    """Huffman-coded data: bits MSB first, 0xFF stuffed with 0x00."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        while self.n:
            self.put(1, 1)  # pad with 1-bits
        data, self.out = bytes(self.out), bytearray()
        return data


def huff_codes(bits, vals) -> dict:
    """symbol -> (code, length) of a T.81 Annex C table"""
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _category(v: int) -> int:
    return int(abs(v)).bit_length()


def _put_value(bw: BitWriter, codes: dict, sym: int, v: int, s: int):
    code, length = codes[sym]
    bw.put(code, length)
    if s:
        bw.put(v if v >= 0 else v + (1 << s) - 1, s)


class QMEncoder:
    """The QM arithmetic encoder of T.81 Annex D (libjpeg's jcarith.c)."""

    def __init__(self):
        self.out = bytearray()
        self.a, self.c, self.ct, self.buffer, self.sc, self.zc = 0x10000, 0, 11, -1, 0, 0

    def _emit(self, b: int):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: np.ndarray, i: int, val: int):
        sv = int(st[i])
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ ((switch << 7) | nlps)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nmps
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)
        data = bytes(self.out)
        self.__init__()
        return data


class ArithModel:
    """Statistics bins and the coding of one value (T.81 F.1.4.1-4),
    shared by the DC and AC procedures of the sequential and progressive
    modes, as jcarith.c codes them."""

    def __init__(self, enc: QMEncoder, dc_l: int = 0, dc_u: int = 1, ac_k: int = 5):
        self.enc, self.L, self.U, self.K = enc, dc_l, dc_u, ac_k
        self.fixed = np.array([FIXED], np.int64)
        self.reset()

    def reset(self):
        self.dc = np.zeros(64, np.int64)
        self.ac = np.zeros(256, np.int64)
        self.context, self.last = {}, {}

    def dc_value(self, ci: int, value: int):
        """F.1.4.1: the DC difference from the component's last value"""
        enc, st = self.enc, self.context.get(ci, 0)
        v = value - self.last.get(ci, 0)
        if v == 0:
            enc.encode(self.dc, st, 0)
            self.context[ci] = 0
            return
        self.last[ci] = value
        enc.encode(self.dc, st, 1)
        if v > 0:
            enc.encode(self.dc, st + 1, 0)
            st += 2
            self.context[ci] = 4
        else:
            v = -v
            enc.encode(self.dc, st + 1, 1)
            st += 3
            self.context[ci] = 8
        m = 0
        v -= 1
        if v:
            enc.encode(self.dc, st, 1)
            m = 1
            v2 = v
            st = 20
            while v2 >> 1:
                v2 >>= 1
                enc.encode(self.dc, st, 1)
                m <<= 1
                st += 1
        enc.encode(self.dc, st, 0)
        if m < (1 << self.L) >> 1:
            self.context[ci] = 0
        elif m > (1 << self.U) >> 1:
            self.context[ci] += 8
        st += 14
        while m >> 1:
            m >>= 1
            enc.encode(self.dc, st, 1 if (m & v) else 0)

    def ac_magnitude(self, st: int, k: int, v: int):
        """F.1.4.3: the magnitude of a nonzero AC value at index k (bin st)"""
        enc = self.enc
        m = 0
        v -= 1
        if v:
            enc.encode(self.ac, st, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc.encode(self.ac, st, 1)
                m <<= 1
                st = 189 if k <= self.K else 217
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(self.ac, st, 1)
                    m <<= 1
                    st += 1
        enc.encode(self.ac, st, 0)
        st += 14
        while m >> 1:
            m >>= 1
            enc.encode(self.ac, st, 1 if (m & v) else 0)

    def ac_first(self, zz: np.ndarray, ss: int, se: int, al: int):
        """F.1.4.2 / G.1.3.2: the AC values ss..se of one block, >> al"""
        enc = self.enc
        shifted = [(abs(int(x)) >> al) * (1 if x >= 0 else -1) for x in zz]
        ke = se
        while ke > 0 and shifted[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(self.ac, st, 0)
            while shifted[k] == 0:
                enc.encode(self.ac, st + 1, 0)
                st += 3
                k += 1
            enc.encode(self.ac, st + 1, 1)
            v = shifted[k]
            enc.encode(self.fixed, 0, 0 if v > 0 else 1)
            self.ac_magnitude(st + 2, k, abs(v))
            k += 1
        if k <= se:
            enc.encode(self.ac, 3 * (k - 1), 1)

    def ac_refine(self, zz: np.ndarray, ss: int, se: int, ah: int, al: int):
        """G.1.3.3: the next bit (al) of the AC values ss..se of one block"""
        enc = self.enc
        mag = [abs(int(x)) for x in zz]
        ke = se
        while ke > 0 and (mag[ke] >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (mag[kex] >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(self.ac, st, 0)
            while True:
                v = mag[k] >> al
                if v:
                    if v >> 1:
                        enc.encode(self.ac, st + 2, v & 1)
                    else:
                        enc.encode(self.ac, st + 1, 1)
                        enc.encode(self.fixed, 0, 0 if zz[k] > 0 else 1)
                    break
                enc.encode(self.ac, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(self.ac, 3 * (k - 1), 1)


def _fdct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    d = np.cos((2 * x + 1) * u * np.pi / 16) / 2
    d[0] /= np.sqrt(2)
    return d


_D = _fdct_matrix()


def component_blocks(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int, q: np.ndarray):
    """The quantized coefficient blocks (rows, cols, 64), zigzag order, of
    a full-resolution plane sampled at (h, v) of (hmax, vmax): edge
    replicated to whole MCUs, box-averaged, forward DCT, rounded."""
    height, width = plane.shape
    mh, mw = 8 * vmax, 8 * hmax
    ph, pw = -(-height // mh) * mh, -(-width // mw) * mw
    padded = np.pad(plane.astype(np.float64), ((0, ph - height), (0, pw - width)), mode="edge")
    fy, fx = vmax // v, hmax // h
    small = padded.reshape(ph // fy, fy, pw // fx, fx).mean(axis=(1, 3)) - 128
    rows, cols = small.shape[0] // 8, small.shape[1] // 8
    blocks = small.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    coef = np.einsum("ux,rcxy,vy->rcuv", _D, blocks, _D).reshape(rows, cols, 64)
    return np.rint(coef / q).astype(np.int64)[..., ZIGZAG]


def _frame(marker: int, width: int, height: int, comps, precision: int = 8) -> bytes:
    body = struct.pack(">BHHB", precision, height, width, len(comps))
    for cid, h, v, tq in comps:
        body += bytes([cid, (h << 4) | v, tq])
    return _marker(marker, body)


def _dht(tables) -> bytes:
    body = b""
    for tc, th, bits, vals in tables:
        body += bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals)
    return _marker(0xC4, body)


def _sos(comps, ss: int, se: int, ah: int, al: int) -> bytes:
    body = bytes([len(comps)])
    for cid, td, ta in comps:
        body += bytes([cid, (td << 4) | ta])
    return _marker(0xDA, body + bytes([ss, se, (ah << 4) | al]))


def _headers(ids, adobe, jfif) -> bytes:
    out = b"\xff\xd8"
    if jfif:
        out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _marker(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe))
    return out


def dct_jpeg(planes, factors, *, quality: int = 80, coding: str = "huffman", ids=None,
             adobe=None, jfif=False, restart: int = 0, dac=None, interleave: bool = True) -> bytes:
    """A DCT JPEG of ``planes`` (full-resolution uint8 (H, W) planes, in
    the colour space they are stored in) at sampling ``factors`` ((h, v)
    a component). ``coding``: ``"huffman"`` (SOF1), ``"arith"`` (SOF9) or
    ``"arith-progressive"`` (SOF10, a spectral-selection and
    successive-approximation script); ``restart`` MCUs a restart interval;
    ``dac``: (L, U, Kx) conditioning written in a DAC marker."""
    n = len(planes)
    height, width = planes[0].shape
    ids = ids or list(range(1, n + 1))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    qt = [scaled_table(LUMA_Q, quality), scaled_table(CHROMA_Q, quality)]
    tq = [0 if c == 0 or c == 3 else 1 for c in range(n)]
    tbl = [0 if c == 0 or c == 3 else 1 for c in range(n)]
    coefs = [component_blocks(p, h, v, hmax, vmax, qt[tq[c]])
             for c, (p, (h, v)) in enumerate(zip(planes, factors))]
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    marker = {"huffman": 0xC1, "arith": 0xC9, "arith-progressive": 0xCA}[coding]
    out = _headers(ids, adobe, False if adobe is not None else jfif)
    out += _marker(0xDB, b"".join(bytes([t]) + bytes(qt[t][ZIGZAG].tolist()) for t in range(2)))
    out += _frame(marker, width, height, [(ids[c], *factors[c], tq[c]) for c in range(n)])
    if coding == "huffman":
        out += _dht([(0, t, DC_BITS[t], DC_VALS) for t in range(2)]
                    + [(1, t, AC_BITS[t], AC_VALS[t]) for t in range(2)])
    elif dac is not None:
        l_, u_, k_ = dac
        out += _marker(0xCC, b"".join(bytes([t, (u_ << 4) | l_, 0x10 | t, k_]) for t in range(2)))
    if restart:
        out += _marker(0xDD, struct.pack(">H", restart))

    def blocks_of(comp_list):
        """(component, row, col) of each block of a scan, in coding order,
        and the MCU each starts"""
        if len(comp_list) == 1:
            c = comp_list[0]
            h, v = factors[c]
            rows = _ceil(_ceil(height * v, vmax), 8)
            cols = _ceil(_ceil(width * h, hmax), 8)
            return [[(c, r, q)] for r in range(rows) for q in range(cols)]
        mcus = []
        for my in range(mcuy):
            for mx in range(mcux):
                mcus.append([(c, my * factors[c][1] + y, mx * factors[c][0] + x)
                             for c in comp_list for y in range(factors[c][1])
                             for x in range(factors[c][0])])
        return mcus

    def scan(comp_list, ss, se, ah, al):
        nonlocal out
        out += _sos([(ids[c], tbl[c], tbl[c]) for c in comp_list], ss, se, ah, al)
        mcus = blocks_of(comp_list)
        if coding == "huffman":
            bw = BitWriter()
            dcc = [huff_codes(DC_BITS[t], DC_VALS) for t in range(2)]
            acc = [huff_codes(AC_BITS[t], AC_VALS[t]) for t in range(2)]
            last = {}
            for m, mcu in enumerate(mcus):
                if restart and m and m % restart == 0:
                    out += bw.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                    last = {}
                for c, r, q in mcu:
                    zz = coefs[c][r, q]
                    diff = int(zz[0]) - last.get(c, 0)
                    last[c] = int(zz[0])
                    s = _category(diff)
                    _put_value(bw, dcc[tbl[c]], s, diff, s)
                    run = 0
                    for k in range(1, 64):
                        val = int(zz[k])
                        if val == 0:
                            run += 1
                            continue
                        while run > 15:
                            _put_value(bw, acc[tbl[c]], 0xF0, 0, 0)
                            run -= 16
                        s = _category(val)
                        _put_value(bw, acc[tbl[c]], (run << 4) | s, val, s)
                        run = 0
                    if run:
                        _put_value(bw, acc[tbl[c]], 0, 0, 0)
            out += bw.flush()
            return
        enc = QMEncoder()
        models = {}

        def model(c):
            t = tbl[c]
            if t not in models:
                models[t] = ArithModel(enc, *(dac or (0, 1, 5)))
            return models[t]

        for m, mcu in enumerate(mcus):
            if restart and m and m % restart == 0:
                out += enc.finish() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                for md in models.values():
                    md.reset()
            for c, r, q in mcu:
                zz = coefs[c][r, q]
                md = model(c)
                if coding == "arith":
                    md.dc_value(c, int(zz[0]))
                    md.ac_first(zz, 1, 63, 0)
                elif ss == 0 and ah == 0:
                    md.dc_value(c, int(zz[0]) >> al)
                elif ss == 0:
                    enc.encode(md.fixed, 0, (int(zz[0]) >> al) & 1)
                elif ah == 0:
                    md.ac_first(zz, ss, se, al)
                else:
                    md.ac_refine(zz, ss, se, ah, al)
        out += enc.finish()

    everyone = list(range(n))
    if coding != "arith-progressive":
        if interleave:
            scan(everyone, 0, 63, 0, 0)
        else:
            for c in everyone:
                scan([c], 0, 63, 0, 0)
    else:
        scan(everyone, 0, 0, 0, 1)
        for c in everyone:
            scan([c], 1, 5, 0, 2) if c == 0 else scan([c], 1, 63, 0, 1)
        scan([0], 6, 63, 0, 2)
        scan([0], 1, 63, 2, 1)
        scan(everyone, 0, 0, 1, 0)
        for c in everyone:
            scan([c], 1, 63, 1, 0)
    return out + b"\xff\xd9"


def lossless_jpeg(planes, *, predictor: int = 1, pt: int = 0, ids=None, restart_rows: int = 0,
                  jfif: bool = False) -> bytes:
    """A lossless Huffman JPEG (SOF3) of uint8 ``planes`` (H, W), all
    sampled 1x1 and interleaved, with predictor 1-7 and point transform
    ``pt``; a restart interval of ``restart_rows`` rows of MCUs."""
    n = len(planes)
    height, width = planes[0].shape
    ids = ids or list(range(1, n + 1))
    x = np.stack([p.astype(np.int64) >> pt for p in planes])
    pred = np.empty_like(x)
    for r in range(height):
        first = restart_rows and r % restart_rows == 0
        if r == 0 or first:
            pred[:, r, 0] = 1 << (8 - pt - 1)
            pred[:, r, 1:] = x[:, r, :-1]
            continue
        ra, rb = x[:, r, :-1], x[:, r - 1, 1:]
        rc = x[:, r - 1, :-1]
        pred[:, r, 0] = x[:, r - 1, 0]
        pred[:, r, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                          6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
    diff = (x - pred) & 0xFFFF
    diff = np.where(diff >= 0x8000, diff - 0x10000, diff)
    out = _headers(ids, None, jfif)
    out += _frame(0xC3, width, height, [(ids[c], 1, 1, 0) for c in range(n)])
    out += _dht([(0, 0, DC_BITS[0], DC_VALS)])
    if restart_rows:
        out += _marker(0xDD, struct.pack(">H", restart_rows * width))
    out += _sos([(ids[c], 0, 0) for c in range(n)], predictor, 0, 0, pt)
    bw = BitWriter()
    codes = huff_codes(DC_BITS[0], DC_VALS)
    for r in range(height):
        if restart_rows and r and r % restart_rows == 0:
            out += bw.flush() + bytes([0xFF, 0xD0 + (r // restart_rows - 1) % 8])
        for col in range(width):
            for c in range(n):
                d = int(diff[c, r, col])
                s = _category(d)
                _put_value(bw, codes, s, d, s)
    out += bw.flush()
    return out + b"\xff\xd9"
