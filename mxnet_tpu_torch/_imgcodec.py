"""The port's image codec: baseline JPEG and Pillow's ``BILINEAR``
resample, exact to the pixels PIL gives.

The card's machine has neither PIL nor OpenCV, and the JAX package
decodes and encodes with PIL (libjpeg-turbo) and resizes its worker
pipeline with Pillow. So the port carries its own, in two versions of
the same arithmetic:

* the plain version here, in numpy (and a Python Huffman coder), which
  tests and CPU contexts use;
* the host library ``ops/csrc/imgcodec.cc``, the same three functions
  in C++ behind ``extern "C"``, built at first use by ``ops/_build`` and
  called through ``ctypes`` (which releases the GIL, so threads and
  worker processes scale).

:func:`decode`, :func:`encode` and :func:`resize_bilinear` pick the
library where the context is the card and the plain version under
``mx.cpu()``, as every kernel of the port does; on the card a failed
build or call raises (no fallback). Each library call adds one to
:data:`LIB_CALLS`.

What is reproduced, bit for bit:

* decoding: baseline (SOF0/SOF1) 8-bit Huffman streams of 1 or 3
  components, any integer sampling (4:4:4, 4:2:2, 4:2:0 and 4:4:0 with
  libjpeg's fancy upsampling, ``jdsample.c``; other integer ratios by
  replication), 8- and 16-bit quantization tables, restart intervals;
  libjpeg's ISLOW IDCT (``jidctint.c``) with its range-limit table, and
  the fixed-point YCbCr to RGB tables of ``jdcolor.c``. The colour space
  follows libjpeg's guess (JFIF, Adobe transform, component ids).
  Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
  4-component (CMYK/YCCK) streams raise and name the mode;
* encoding: ``jcparam.c``'s quality scaling of the Annex K tables
  (baseline-clamped), the RGB to YCbCr tables of ``jccolor.c``,
  ``jcsample.c``'s downsampling (h2v2 with the alternating 1/2 bias),
  the ISLOW FDCT (``jfdctint.c``), libjpeg-turbo's reciprocal
  quantization, the Annex K Huffman tables, libjpeg's dummy blocks at
  the MCU edges and a JFIF APP0: the bytes PIL writes for the same
  array, quality and sampling;
* resampling: Pillow's ``ImagingResample`` for 8-bit images with the
  bilinear filter: support scaled by the downscale factor, coefficients
  normalized then rounded to 22 fractional bits, horizontal pass first,
  a clip to 8 bits between the passes.
"""
from __future__ import annotations

import ctypes
import math
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .base import MXNetError

__all__ = ["decode", "encode", "resize_bilinear", "decode_plain",
           "encode_plain", "resize_plain", "library", "use_library",
           "LIB_CALLS", "SAMPLINGS"]

# libjpeg's zigzag: NATURAL[k] is the row-major index of the k-th
# coefficient of the stream; 16 extra entries of 63 absorb a corrupt run
# as ``jpeg_natural_order`` does
_ZZ = []
for _s in range(15):
    _cells = [(i, _s - i) for i in range(8) if 0 <= _s - i < 8]
    _ZZ += _cells[::-1] if _s % 2 == 0 else _cells
NATURAL = [i * 8 + j for i, j in _ZZ] + [63] * 16
del _s, _cells, _ZZ

# Annex K.1 base quantization tables, in zigzag order (as DQT stores them)
_BASE_QUANT = (
    [16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24,
     22, 22, 24, 49, 35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72,
     92, 78, 64, 68, 87, 69, 55, 56, 80, 109, 81, 87, 95, 98, 103, 104, 103,
     62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99],
    [17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99]
    + [99] * 49,
)

# Annex K.3 Huffman tables: (code-length counts 1..16, symbols)
_AC_LUMA_VALS = [
    1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50,
    129, 145, 161, 8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114,
    130, 9, 10, 22, 23, 24, 25, 26, 37, 38, 39, 40, 41, 42, 52, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149,
    150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170,
    178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198,
    199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218, 225,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 241, 242, 243, 244, 245,
    246, 247, 248, 249, 250]
_AC_CHROMA_VALS = [
    0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129,
    8, 20, 66, 145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10,
    22, 36, 52, 225, 37, 241, 23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55,
    56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83, 84, 85, 86, 87, 88, 89,
    90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118, 119, 120,
    121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148,
    149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169,
    170, 178, 179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197,
    198, 199, 200, 201, 202, 210, 211, 212, 213, 214, 215, 216, 217, 218,
    226, 227, 228, 229, 230, 231, 232, 233, 234, 242, 243, 244, 245, 246,
    247, 248, 249, 250]
STD_HUFF = {
    (0, 0): ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    (1, 0): ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125],
             _AC_LUMA_VALS),
    (0, 1): ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    (1, 1): ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119],
             _AC_CHROMA_VALS),
}

# (Y's horizontal, vertical sampling factor); chroma is 1 x 1
SAMPLINGS = {"444": (1, 1), "422": (2, 1), "420": (2, 2), "440": (1, 2)}

_SOF_MODES = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "hierarchical (SOF5)", 0xC6: "hierarchical progressive (SOF6)",
    0xC7: "hierarchical lossless (SOF7)",
    0xC9: "arithmetic-coded (SOF9)", 0xCA: "arithmetic-coded progressive "
    "(SOF10)", 0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded hierarchical (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless (SOF15)",
}

LIB_CALLS: Dict[str, int] = {"decode": 0, "encode": 0, "resize": 0}


def _unsupported(what):
    raise MXNetError("JPEG: %s streams are not supported (baseline "
                     "Huffman 8-bit, 1 or 3 components only)" % what)


# ---------------------------------------------------------------------------
# fixed-point tables
# ---------------------------------------------------------------------------


def _fix(x):
    return int(x * 65536 + 0.5)


_I = np.arange(256, dtype=np.int64)
_X = _I - 128
# jdcolor.c build_ycc_rgb_table
_CR_R = (_fix(1.40200) * _X + 32768) >> 16
_CB_B = (_fix(1.77200) * _X + 32768) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + 32768
# jccolor.c rgb_ycc_start
_Y_R, _Y_G, _Y_B = _fix(0.299) * _I, _fix(0.587) * _I, _fix(0.114) * _I + 32768
_CB_R, _CB_G2 = -_fix(0.16874) * _I, -_fix(0.33126) * _I
_HALF_B = _fix(0.5) * _I + (128 << 16) + 32768 - 1
_CR_G2, _CR_B = -_fix(0.41869) * _I, -_fix(0.08131) * _I
del _I, _X


def _idct_range_table():
    """libjpeg's ``prepare_range_limit_table``, from the IDCT's origin:
    ``out = table[x & 1023]``."""
    t = np.zeros(5 * 256 + 128, np.uint8)
    base = 256
    t[base:base + 256] = np.arange(256)
    post = base + 128
    t[post + 128:post + 512] = 255
    t[post + 1024 - 128:post + 1024] = t[base:base + 128]
    return t[post:post + 1024]


_IDCT_LIMIT = _idct_range_table()


# ---------------------------------------------------------------------------
# ISLOW IDCT / FDCT (jidctint.c, jfdctint.c), vectorized over blocks
# ---------------------------------------------------------------------------


def _idct_pass(z, n):
    """One 1-D pass of ``jpeg_idct_islow`` on the 8 inputs ``z`` (arrays),
    descaled by ``n`` bits: the 8 outputs."""
    z1 = (z[2] + z[6]) * 4433
    tmp2 = z1 + z[6] * -15137
    tmp3 = z1 + z[2] * 6270
    tmp0 = (z[0] + z[4]) << 13
    tmp1 = (z[0] - z[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = z[7], z[5], z[3], z[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633
    t0, t1, t2, t3 = t0 * 2446, t1 * 16819, t2 * 25172, t3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (n - 1)
    return [(tmp10 + t3 + r) >> n, (tmp11 + t2 + r) >> n,
            (tmp12 + t1 + r) >> n, (tmp13 + t0 + r) >> n,
            (tmp13 - t0 + r) >> n, (tmp12 - t1 + r) >> n,
            (tmp11 - t2 + r) >> n, (tmp10 - t3 + r) >> n]


def _idct(blocks):
    """(N, 8, 8) dequantized coefficients (int64, row-major) -> (N, 8, 8)
    uint8 samples."""
    cols = _idct_pass([blocks[:, k, :] for k in range(8)], 11)
    ws = np.stack(cols, axis=1)
    rows = _idct_pass([ws[:, :, k] for k in range(8)], 18)
    return _IDCT_LIMIT[np.stack(rows, axis=2) & 1023]


def _fdct_pass(d, first):
    """One 1-D pass of ``jpeg_fdct_islow`` on the 8 inputs ``d``."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    n = 11 if first else 15
    r = 1 << (n - 1)
    out = [None] * 8
    if first:
        out[0] = (tmp10 + tmp11) << 2
        out[4] = (tmp10 - tmp11) << 2
    else:
        out[0] = (tmp10 + tmp11 + 2) >> 2
        out[4] = (tmp10 - tmp11 + 2) >> 2
    z1 = (tmp12 + tmp13) * 4433
    out[2] = (z1 + tmp13 * 6270 + r) >> n
    out[6] = (z1 + tmp12 * -15137 + r) >> n
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633
    tmp4, tmp5 = tmp4 * 2446, tmp5 * 16819
    tmp6, tmp7 = tmp6 * 25172, tmp7 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5
    out[7] = (tmp4 + z1 + z3 + r) >> n
    out[5] = (tmp5 + z2 + z4 + r) >> n
    out[3] = (tmp6 + z2 + z3 + r) >> n
    out[1] = (tmp7 + z1 + z4 + r) >> n
    return out


def _fdct(blocks):
    """(N, 8, 8) samples minus 128 (int64) -> the FDCT, scaled by 8."""
    rows = _fdct_pass([blocks[:, :, k] for k in range(8)], True)
    ws = np.stack(rows, axis=2)
    cols = _fdct_pass([ws[:, k, :] for k in range(8)], False)
    return np.stack(cols, axis=1)


def _reciprocal(divisor):
    """libjpeg-turbo's ``compute_reciprocal`` for a 16-bit DCTELEM:
    (reciprocal, correction, shift) with ``q = ((x + c) * r) >> s``."""
    b = divisor.bit_length() - 1
    r = 16 + b
    fq, fr = divmod(1 << r, divisor)
    c = divisor // 2
    if fr == 0:
        fq >>= 1
        r -= 1
    elif fr <= divisor // 2:
        c += 1
    else:
        fq += 1
    return fq, c, r


def _quantize(coef, qtable_natural):
    """Quantize FDCT output (N, 64) as libjpeg-turbo does: the divisor is
    the table entry times 8."""
    recip = np.empty(64, np.int64)
    corr = np.empty(64, np.int64)
    shift = np.empty(64, np.int64)
    for i, q in enumerate(qtable_natural):
        recip[i], corr[i], shift[i] = _reciprocal(int(q) << 3)
    mag = np.abs(coef)
    q = ((mag + corr) * recip) >> shift
    return np.where(coef < 0, -q, q)


# ---------------------------------------------------------------------------
# marker parsing
# ---------------------------------------------------------------------------

_ECS_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]", re.S)
_RST = re.compile(rb"\xff+[\xd0-\xd7]", re.S)


class _Frame:
    def __init__(self):
        self.h = self.w = 0
        self.comps: List[dict] = []
        self.qt: Dict[int, np.ndarray] = {}
        self.huff: Dict[Tuple[int, int], Tuple[list, list]] = {}
        self.restart = 0
        self.jfif = False
        self.adobe: Optional[int] = None
        self.scans: List[tuple] = []


def _segments(buf: bytes):
    """Walk the markers of ``buf``: yields (marker, payload, pos after)."""
    n = len(buf)
    if n < 4 or buf[0] != 0xFF or buf[1] != 0xD8:
        raise MXNetError("imdecode: not a JPEG stream (no SOI marker)")
    pos = 2
    while pos < n:
        if buf[pos] != 0xFF:
            raise MXNetError("imdecode: corrupt JPEG (byte 0x%02x where a "
                             "marker belongs, offset %d)" % (buf[pos], pos))
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = buf[pos]
        pos += 1
        if marker == 0xD9:
            return
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            break
        length = (buf[pos] << 8) | buf[pos + 1]
        if length < 2 or pos + length > n:
            raise MXNetError("imdecode: corrupt JPEG (marker 0x%02x of "
                             "length %d)" % (marker, length))
        payload = buf[pos + 2:pos + length]
        pos += length
        if marker == 0xDA:
            m = _ECS_END.search(buf, pos)
            end = m.start() if m else n
            yield marker, payload, buf[pos:end]
            pos = end
        else:
            yield marker, payload, None
    raise MXNetError("imdecode: truncated JPEG (no EOI marker)")


def _parse(buf: bytes) -> _Frame:
    fr = _Frame()
    seen_sof = False
    for marker, p, ecs in _segments(buf):
        if marker in (0xC0, 0xC1):
            if p[0] != 8:
                _unsupported("%d-bit" % p[0])
            fr.h = (p[1] << 8) | p[2]
            fr.w = (p[3] << 8) | p[4]
            nc = p[5]
            if nc == 4:
                _unsupported("4-component (CMYK/YCCK)")
            if nc not in (1, 3):
                _unsupported("%d-component" % nc)
            if fr.h == 0 or fr.w == 0:
                raise MXNetError("imdecode: JPEG of size %dx%d"
                                 % (fr.w, fr.h))
            for i in range(nc):
                cid, hv, tq = p[6 + 3 * i:9 + 3 * i]
                hs, vs = hv >> 4, hv & 15
                if not (1 <= hs <= 4 and 1 <= vs <= 4):
                    raise MXNetError("imdecode: corrupt JPEG (sampling "
                                     "%dx%d)" % (hs, vs))
                fr.comps.append({"id": cid, "h": hs, "v": vs, "tq": tq})
            seen_sof = True
        elif marker in _SOF_MODES:
            _unsupported(_SOF_MODES[marker])
        elif marker == 0xCC:
            _unsupported("arithmetic-coded")
        elif marker == 0xC4:
            i = 0
            while i < len(p):
                tc, th = p[i] >> 4, p[i] & 15
                bits = list(p[i + 1:i + 17])
                total = sum(bits)
                vals = list(p[i + 17:i + 17 + total])
                if len(bits) < 16 or len(vals) < total or tc > 1:
                    raise MXNetError("imdecode: corrupt JPEG (DHT)")
                fr.huff[(tc, th)] = (bits, vals)
                i += 17 + total
        elif marker == 0xDB:
            i = 0
            while i < len(p):
                pq, tq = p[i] >> 4, p[i] & 15
                if pq == 0:
                    zz = np.frombuffer(p[i + 1:i + 65], np.uint8)
                    i += 65
                else:
                    zz = np.frombuffer(p[i + 1:i + 129], ">u2")
                    i += 129
                if zz.size != 64:
                    raise MXNetError("imdecode: corrupt JPEG (DQT)")
                nat = np.zeros(64, np.int64)
                nat[NATURAL[:64]] = zz
                fr.qt[tq] = nat
        elif marker == 0xDD:
            fr.restart = (p[0] << 8) | p[1]
        elif marker == 0xE0:
            if p[:5] == b"JFIF\x00":
                fr.jfif = True
        elif marker == 0xEE:
            if p[:5] == b"Adobe" and len(p) >= 12:
                fr.adobe = p[11]
        elif marker == 0xDA:
            if not seen_sof:
                raise MXNetError("imdecode: corrupt JPEG (SOS before SOF)")
            ns = p[0]
            sc = []
            for i in range(ns):
                cid, tbl = p[1 + 2 * i], p[2 + 2 * i]
                idx = [k for k, c in enumerate(fr.comps) if c["id"] == cid]
                if not idx:
                    raise MXNetError("imdecode: corrupt JPEG (scan of "
                                     "unknown component %d)" % cid)
                sc.append((idx[0], tbl >> 4, tbl & 15))
            ss, se, ahal = p[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahal != 0:
                _unsupported("progressive (spectral selection)")
            # the tables and the restart interval in force for this scan
            fr.scans.append((sc, dict(fr.huff), fr.restart, ecs,
                             dict(fr.qt)))
        elif marker == 0xDC:
            _unsupported("DNL-sized")
    if not seen_sof:
        raise MXNetError("imdecode: JPEG without a frame header")
    if not fr.scans:
        raise MXNetError("imdecode: JPEG without a scan")
    return fr


# ---------------------------------------------------------------------------
# Huffman decoding
# ---------------------------------------------------------------------------


def _lookup(bits, vals):
    """A 65536-entry table: the next 16 bits of the stream -> (code length
    << 8) | symbol, 0 where no code matches."""
    look = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            look[lo:lo + (1 << (16 - length))] = (length << 8) | vals[k]
            code += 1
            k += 1
        code <<= 1
    return look.tolist()


def _windows(seg: bytes):
    """32-bit big-endian windows at every byte of the unstuffed segment."""
    data = np.frombuffer(seg.replace(b"\xff\x00", b"\xff") + bytes(8),
                         np.uint8).astype(np.int64)
    return ((data[:-3] << 24) | (data[1:-2] << 16) | (data[2:-1] << 8)
            | data[3:]).tolist()


def _decode_scan(fr: _Frame, scan, coefs, grids):
    comps, huff, restart, ecs, _qt = scan
    looks = {}
    for ci, td, ta in comps:
        for key in ((0, td), (1, ta)):
            if key not in huff:
                raise MXNetError("imdecode: corrupt JPEG (Huffman table "
                                 "%s undefined)" % (key,))
            if key not in looks:
                looks[key] = _lookup(*huff[key])
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    # the blocks of each MCU, in stream order: (comp, block row, block col)
    if len(comps) == 1:
        ci = comps[0][0]
        c = fr.comps[ci]
        bw = -(-(-(-fr.w * c["h"] // hmax)) // 8)
        bh = -(-(-(-fr.h * c["v"] // vmax)) // 8)
        units = [[(0, by, bx)] for by in range(bh) for bx in range(bw)]
    else:
        mx_ = -(-fr.w // (8 * hmax))
        my_ = -(-fr.h // (8 * vmax))
        units = []
        for my in range(my_):
            for mxx in range(mx_):
                u = []
                for k, (ci, _, _) in enumerate(comps):
                    c = fr.comps[ci]
                    for v in range(c["v"]):
                        for h in range(c["h"]):
                            u.append((k, my * c["v"] + v, mxx * c["h"] + h))
                units.append(u)
    segs = _RST.split(ecs) if restart else [ecs]
    per = restart if restart else len(units)
    nat = NATURAL
    tabs = [(coefs[ci], grids[ci][1], looks[(0, td)], looks[(1, ta)])
            for ci, td, ta in comps]
    for s in range(-(-len(units) // per)):
        seg = segs[s] if s < len(segs) else b""
        win = _windows(seg)
        p = 0
        pred = [0] * len(comps)
        try:
            for unit in units[s * per:(s + 1) * per]:
                for k, by, bx in unit:
                    out, gw, dc_look, ac_look = tabs[k]
                    base = (by * gw + bx) * 64
                    e = dc_look[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise MXNetError("imdecode: corrupt JPEG (bad "
                                         "Huffman code)")
                    p += e >> 8
                    t = e & 255
                    if t:
                        v = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - t)
                        p += t
                        if v < (1 << (t - 1)):
                            v -= (1 << t) - 1
                        pred[k] += v
                    out[base] = pred[k]
                    i = 1
                    while i < 64:
                        e = ac_look[(win[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise MXNetError("imdecode: corrupt JPEG (bad "
                                             "Huffman code)")
                        p += e >> 8
                        t = e & 15
                        r = (e >> 4) & 15
                        if t:
                            i += r
                            v = ((win[p >> 3] << (p & 7)) & 0xFFFFFFFF) \
                                >> (32 - t)
                            p += t
                            if v < (1 << (t - 1)):
                                v -= (1 << t) - 1
                            out[base + nat[i]] = v
                            i += 1
                        elif r == 15:
                            i += 16
                        else:
                            break
        except IndexError:
            raise MXNetError("imdecode: truncated JPEG (entropy-coded data "
                             "ends inside a block)") from None


# ---------------------------------------------------------------------------
# upsampling and colour
# ---------------------------------------------------------------------------


def _pad_edge(a, axis):
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    return np.concatenate([first, a, last], axis=axis)


def _upsample(plane, hf, vf, out_h, out_w):
    """libjpeg's upsampling of one component plane (its real size) by
    integer factors (hf, vf): the fancy triangle filters of ``jdsample.c``
    for h2v1, h1v2 and h2v2 (h2 ones only where the plane is wider than
    2), replication otherwise; cropped to (out_h, out_w)."""
    p = plane.astype(np.int64)
    dw = p.shape[1]
    if (hf, vf) == (2, 1) and dw > 2:
        q = _pad_edge(p, 1)
        mid = 3 * q[:, 1:-1]
        out = np.empty((p.shape[0], 2 * dw), np.int64)
        out[:, 0::2] = (mid + q[:, :-2] + 1) >> 2
        out[:, 1::2] = (mid + q[:, 2:] + 2) >> 2
    elif (hf, vf) == (1, 2):
        q = _pad_edge(p, 0)
        mid = 3 * q[1:-1]
        out = np.empty((2 * p.shape[0], dw), np.int64)
        out[0::2] = (mid + q[:-2] + 1) >> 2
        out[1::2] = (mid + q[2:] + 2) >> 2
    elif (hf, vf) == (2, 2) and dw > 2:
        q = _pad_edge(p, 0)
        mid = 3 * q[1:-1]
        col = np.empty((2 * p.shape[0], dw), np.int64)
        col[0::2] = mid + q[:-2]
        col[1::2] = mid + q[2:]
        c = _pad_edge(col, 1)
        cm = 3 * c[:, 1:-1]
        out = np.empty((col.shape[0], 2 * dw), np.int64)
        out[:, 0::2] = (cm + c[:, :-2] + 8) >> 4
        out[:, 1::2] = (cm + c[:, 2:] + 7) >> 4
    else:
        out = np.repeat(np.repeat(p, vf, axis=0), hf, axis=1)
    return out[:out_h, :out_w].astype(np.uint8)


def _ycc_to_rgb(y, cb, cr):
    y = y.astype(np.int64)
    cb = cb.astype(np.int64)
    cr = cr.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


def _is_ycc(fr: _Frame) -> bool:
    """libjpeg's ``default_decompress_parms`` guess for 3 components."""
    if fr.jfif:
        return True
    if fr.adobe is not None:
        return fr.adobe != 0
    ids = [c["id"] for c in fr.comps]
    return ids != [82, 71, 66]


def decode_plain(buf) -> np.ndarray:
    """A baseline JPEG stream -> (H, W, C) uint8, C = 1 (gray) or 3 (RGB),
    the pixels libjpeg-turbo (PIL) gives."""
    fr = _parse(bytes(buf))
    hmax = max(c["h"] for c in fr.comps)
    vmax = max(c["v"] for c in fr.comps)
    mx_ = -(-fr.w // (8 * hmax))
    my_ = -(-fr.h // (8 * vmax))
    coefs, grids = [], []
    for c in fr.comps:
        gh, gw = my_ * c["v"], mx_ * c["h"]
        grids.append((gh, gw))
        coefs.append([0] * (gh * gw * 64))
    qt_of = {}
    for scan in fr.scans:
        for ci, _, _ in scan[0]:
            if ci not in qt_of:  # latched at the component's first scan
                tq = fr.comps[ci]["tq"]
                if tq not in scan[4]:
                    raise MXNetError("imdecode: corrupt JPEG (quantization "
                                     "table %d undefined)" % tq)
                qt_of[ci] = scan[4][tq]
        _decode_scan(fr, scan, coefs, grids)
    planes = []
    for ci, c in enumerate(fr.comps):
        if ci not in qt_of:
            raise MXNetError("imdecode: corrupt JPEG (component %d in no "
                             "scan)" % c["id"])
        gh, gw = grids[ci]
        blk = np.asarray(coefs[ci], np.int64).reshape(gh * gw, 64) * qt_of[ci]
        pix = _idct(blk.reshape(-1, 8, 8)).reshape(gh, gw, 8, 8)
        plane = pix.transpose(0, 2, 1, 3).reshape(gh * 8, gw * 8)
        dh = -(-fr.h * c["v"] // vmax)
        dw = -(-fr.w * c["h"] // hmax)
        plane = plane[:dh, :dw]
        hf, vf = hmax // c["h"], vmax // c["v"]
        if hf * c["h"] != hmax or vf * c["v"] != vmax:
            _unsupported("fractional-sampling")
        planes.append(_upsample(plane, hf, vf, fr.h, fr.w)
                      if (hf, vf) != (1, 1) else plane[:fr.h, :fr.w])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0][:, :, None])
    if _is_ycc(fr):
        return _ycc_to_rgb(*planes)
    return np.ascontiguousarray(np.stack(planes, axis=2))


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _quant_tables(quality: int) -> List[np.ndarray]:
    """``jpeg_set_quality(quality, force_baseline=TRUE)``: the luminance
    and chrominance tables in zigzag order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    out = []
    for base in _BASE_QUANT:
        t = (np.asarray(base, np.int64) * scale + 50) // 100
        out.append(np.clip(t, 1, 255))
    return out


def _huff_codes(bits, vals):
    """(code, length) a symbol, as ``jpeg_make_c_derived_tbl``."""
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _downsample(full, hf, vf, out_w, out_h):
    """``jcsample.c``: ``full`` edge-padded to (out_h * vf, out_w * hf),
    then reduced by (hf, vf): h2v1 and h2v2 with their alternating bias,
    other ratios by ``int_downsample``'s rounded mean."""
    a = full.astype(np.int64)
    a = np.pad(a, ((0, out_h * vf - a.shape[0]), (0, out_w * hf - a.shape[1])),
               mode="edge")
    if (hf, vf) == (1, 1):
        return a
    if (hf, vf) == (2, 1):
        bias = np.tile([0, 1], out_w)[:out_w]
        return (a[:, 0::2] + a[:, 1::2] + bias) >> 1
    if (hf, vf) == (2, 2):
        bias = np.tile([1, 2], out_w)[:out_w]
        return (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2]
                + a[1::2, 1::2] + bias) >> 2
    n = hf * vf
    s = a.reshape(out_h, vf, out_w, hf).sum(axis=(1, 3))
    return (s + n // 2) // n


def _comp_planes(img, comps, hmax, vmax):
    """Each component's plane at its padded block size, as libjpeg
    prepares it: colour conversion, edge padding of the image to a row
    group and to whole blocks, downsampling, and the last row repeated
    to the iMCU height."""
    h, w = img.shape[:2]
    if len(comps) == 1:
        fulls = [img[:, :, 0].astype(np.int64)]
    else:
        r, g, b = (img[:, :, i].astype(np.int64) for i in range(3))
        fulls = [(_Y_R[r] + _Y_G[g] + _Y_B[b]) >> 16,
                 (_CB_R[r] + _CB_G2[g] + _HALF_B[b]) >> 16,
                 (_HALF_B[r] + _CR_G2[g] + _CR_B[b]) >> 16]
    planes = []
    for full, c in zip(fulls, comps):
        hf, vf = hmax // c["h"], vmax // c["v"]
        dw = -(-w * c["h"] // hmax)
        dh = -(-h * c["v"] // vmax)
        bw, bh = -(-dw // 8), -(-dh // 8)
        # rows: the image padded to a multiple of the row group (vmax),
        # downsampled, then edge-padded to whole blocks
        rows = -(-h // vmax) * vmax // vf
        ds = _downsample(full, hf, vf, bw * 8, rows)
        ds = np.pad(ds, ((0, max(0, bh * 8 - ds.shape[0])), (0, 0)),
                    mode="edge")[:bh * 8]
        planes.append(ds)
    return planes


def _bit_pack(vals: List[int], lens: List[int]) -> bytes:
    """The bits of each (value, length) in order, padded with ones to a
    byte, 0xFF stuffed."""
    if not vals:
        return b""
    v = np.asarray(vals, np.int64)
    n = np.asarray(lens, np.int64)
    total = int(n.sum())
    which = np.repeat(np.arange(v.size), n)
    start = np.repeat(np.cumsum(n) - n, n)
    shift = n[which] - 1 - (np.arange(total) - start)
    bits = ((v[which] >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    if pad:
        bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _marker(code, payload):
    return bytes([0xFF, code]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode_plain(img, quality: int = 95, sampling: Optional[str] = None,
                 restart: int = 0) -> bytes:
    """A baseline JPEG of an (H, W), (H, W, 1) or (H, W, 3) uint8 image:
    the bytes PIL writes for ``save(format="JPEG", quality=quality)`` (and
    ``subsampling`` 4:4:4, 4:2:2 or 4:2:0; ``sampling`` also takes "440").
    ``restart`` is the restart interval in MCUs (0: none)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (1, 3):
        raise MXNetError("imencode: JPEG takes (H, W), (H, W, 1) or (H, W, 3) "
                         "uint8, got %s %s" % (img.dtype, img.shape))
    h, w, nc = img.shape
    if not (0 < h < 65536 and 0 < w < 65536):
        raise MXNetError("imencode: JPEG of size %dx%d" % (w, h))
    if nc == 1:
        comps = [{"id": 1, "h": 1, "v": 1, "tq": 0}]
    else:
        hs, vs = SAMPLINGS[sampling or "420"]
        comps = [{"id": 1, "h": hs, "v": vs, "tq": 0},
                 {"id": 2, "h": 1, "v": 1, "tq": 1},
                 {"id": 3, "h": 1, "v": 1, "tq": 1}]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    tables = _quant_tables(quality)[:1 if nc == 1 else 2]
    planes = _comp_planes(img, comps, hmax, vmax)
    # quantized blocks of each component, (bh, bw, 64) row-major
    qblocks = []
    for plane, c in zip(planes, comps):
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        blk = (plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
               .reshape(-1, 8, 8) - 128)
        nat = np.zeros(64, np.int64)
        nat[NATURAL[:64]] = tables[c["tq"]]
        q = _quantize(_fdct(blk).reshape(-1, 64), nat)
        qblocks.append(q.reshape(bh, bw, 64).tolist())
    codes = {key: _huff_codes(*STD_HUFF[key]) for key in STD_HUFF}
    zz = NATURAL[1:64]
    mx_ = -(-w // (8 * hmax))
    my_ = -(-h // (8 * vmax))
    # MCUs in order; a single-component scan has one block an MCU
    if nc == 1:
        bh, bw = len(qblocks[0]), len(qblocks[0][0])
        mcus = [(by, bx) for by in range(bh) for bx in range(bw)]
    else:
        mcus = [(my, mxx) for my in range(my_) for mxx in range(mx_)]
    out_segments = []
    vals: List[int] = []
    lens: List[int] = []
    pred = [0] * nc

    def emit_block(ci, blk):
        t = 0 if ci == 0 else 1
        dc_codes, ac_codes = codes[(0, t)], codes[(1, t)]
        diff = blk[0] - pred[ci]
        pred[ci] = blk[0]
        mag = -diff if diff < 0 else diff
        nbits = mag.bit_length()
        code, ln = dc_codes[nbits]
        vals.append(code)
        lens.append(ln)
        if nbits:
            vals.append((diff - 1 if diff < 0 else diff) & ((1 << nbits) - 1))
            lens.append(nbits)
        run = 0
        for k in zz:
            v = blk[k]
            if v == 0:
                run += 1
                continue
            while run > 15:
                code, ln = ac_codes[0xF0]
                vals.append(code)
                lens.append(ln)
                run -= 16
            mag = -v if v < 0 else v
            nbits = mag.bit_length()
            code, ln = ac_codes[(run << 4) + nbits]
            vals.append(code)
            lens.append(ln)
            vals.append((v - 1 if v < 0 else v) & ((1 << nbits) - 1))
            lens.append(nbits)
            run = 0
        if run:
            code, ln = ac_codes[0]
            vals.append(code)
            lens.append(ln)

    zero = [0] * 64
    for m, (a, b) in enumerate(mcus):
        if restart and m and m % restart == 0:
            out_segments.append(_bit_pack(vals, lens)
                                + bytes([0xFF, 0xD0 + (m // restart - 1) % 8]))
            vals, lens = [], []
            pred = [0] * nc
        if nc == 1:
            emit_block(0, qblocks[0][a][b])
            continue
        for ci, c in enumerate(comps):
            grid = qblocks[ci]
            gh, gw = len(grid), len(grid[0])
            prev = None
            for v in range(c["v"]):
                by = a * c["v"] + v
                for hh in range(c["h"]):
                    bx = b * c["h"] + hh
                    if by < gh and bx < gw:
                        blk = grid[by][bx]
                    else:
                        # a dummy block past the right or bottom edge: no
                        # AC, the DC of the MCU's block before it
                        blk = list(zero)
                        blk[0] = prev[0]
                    emit_block(ci, blk)
                    prev = blk
    out_segments.append(_bit_pack(vals, lens))
    head = [b"\xff\xd8",
            _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, table in enumerate(tables):
        head.append(_marker(0xDB, bytes([t]) + table.astype(np.uint8)
                            .tobytes()))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([nc])
    for c in comps:
        sof += bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]])
    head.append(_marker(0xC0, sof))
    for t in range(len(tables)):
        for tc in (0, 1):
            bits, hv = STD_HUFF[(tc, t)]
            head.append(_marker(0xC4, bytes([(tc << 4) | t] + bits + hv)))
    if restart:
        head.append(_marker(0xDD, restart.to_bytes(2, "big")))
    sos = bytes([nc])
    for ci, c in enumerate(comps):
        t = 0 if ci == 0 else 1
        sos += bytes([c["id"], (t << 4) | t])
    head.append(_marker(0xDA, sos + b"\x00\x3f\x00"))
    return b"".join(head) + b"".join(out_segments) + b"\xff\xd9"


# ---------------------------------------------------------------------------
# Pillow's bilinear resample (Resample.c)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _resample_coeffs(in_size: int, out_size: int):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the bilinear
    filter over the box (0, in_size): (xmin, int32 coefficients (out,
    ksize)), coefficients past a row's xmax zero."""
    scale = float(np.float32(in_size) - np.float32(0.0)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.trunc(center - support + 0.5).astype(np.int64)
    xmin = np.maximum(xmin, 0)
    xmax = np.trunc(center + support + 0.5).astype(np.int64)
    xmax = np.minimum(xmax, in_size) - xmin
    x = np.arange(ksize, dtype=np.int64)
    arg = ((x[None, :] + xmin[:, None]).astype(np.float64)
           - center[:, None] + 0.5) * ss
    arg = np.abs(arg)
    wts = np.where(arg < 1.0, 1.0 - arg, 0.0)
    wts = np.where(x[None, :] < xmax[:, None], wts, 0.0)
    ww = np.zeros(out_size, np.float64)
    for k in range(ksize):  # in order, as the C loop sums
        ww = ww + wts[:, k]
    wts = np.where(ww[:, None] != 0.0, wts / np.where(ww == 0.0, 1.0,
                                                       ww)[:, None], wts)
    scaled = wts * float(1 << _PRECISION_BITS)
    kk = np.where(wts < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled))
    return xmin, kk.astype(np.int64)


def _clip8(ss):
    return np.where(ss >= (1 << _PRECISION_BITS << 8), 255,
                    np.where(ss <= 0, 0, ss >> _PRECISION_BITS)).astype(
                        np.uint8)


def _resample_axis(img, out_size, axis):
    in_size = img.shape[axis]
    xmin, kk = _resample_coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :],
                     in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for k in range(kk.shape[1]):
        acc += src[idx[:, k]] * kk[:, k].reshape((-1,) + (1,) * (src.ndim
                                                                  - 1))
    return np.moveaxis(_clip8(acc), 0, axis)


def resize_plain(img, w: int, h: int) -> np.ndarray:
    """Pillow's ``Image.resize((w, h), Image.BILINEAR)`` of an (H, W, C)
    uint8 image."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise MXNetError("resize: (H, W, C) uint8 expected, got %s %s"
                         % (img.dtype, img.shape))
    if w < 1 or h < 1:
        raise MXNetError("resize: size %dx%d" % (w, h))
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return np.ascontiguousarray(out)


# ---------------------------------------------------------------------------
# the host library and the choice by context
# ---------------------------------------------------------------------------

_lib_lock = threading.Lock()
_lib = None


def library():
    """The loaded host library (built at first use; raises with the
    compiler's output if the build fails)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from .ops import _build

            lib = _build.load("imgcodec")
            c_p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.imgcodec_decode.argtypes = [c_p, i64, c_p, i64,
                                            ctypes.POINTER(i32)]
            lib.imgcodec_decode.restype = i32
            lib.imgcodec_encode.argtypes = [c_p, i32, i32, i32, i32, i32,
                                            i32, i32, c_p, i64,
                                            ctypes.POINTER(i64)]
            lib.imgcodec_encode.restype = i32
            lib.imgcodec_resize.argtypes = [c_p, i32, i32, i32, c_p, i32,
                                            i32]
            lib.imgcodec_resize.restype = i32
            lib.imgcodec_error.argtypes = []
            lib.imgcodec_error.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _lib_error(lib, what):
    msg = lib.imgcodec_error().decode()
    raise MXNetError(msg if msg else "%s: the host library failed" % what)


def use_library(ctx=None) -> bool:
    """True where the context (the current one by default) is the card."""
    if ctx is None:
        from .context import current_context

        ctx = current_context()
    return ctx.device_type == "gpu"


def _lib_decode(buf: bytes) -> np.ndarray:
    lib = library()
    dims = (ctypes.c_int32 * 3)()
    if lib.imgcodec_decode(buf, len(buf), None, 0, dims) != 0:
        _lib_error(lib, "imdecode")
    out = np.empty((dims[0], dims[1], dims[2]), np.uint8)
    if lib.imgcodec_decode(buf, len(buf), out.ctypes.data, out.size,
                           dims) != 0:
        _lib_error(lib, "imdecode")
    LIB_CALLS["decode"] += 1
    return out


def _lib_encode(img: np.ndarray, quality, sampling, restart) -> bytes:
    lib = library()
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    hs, vs = SAMPLINGS[sampling or "420"] if c == 3 else (1, 1)
    need = ctypes.c_int64(0)
    cap = h * w * c + 4096
    for _ in range(2):
        out = np.empty(cap, np.uint8)
        rc = lib.imgcodec_encode(img.ctypes.data, h, w, c, int(quality), hs,
                                 vs, int(restart), out.ctypes.data, cap,
                                 ctypes.byref(need))
        if rc == 0:
            LIB_CALLS["encode"] += 1
            return out[:need.value].tobytes()
        if rc != 1:
            break
        cap = need.value
    _lib_error(lib, "imencode")


def _lib_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    lib = library()
    img = np.ascontiguousarray(img)
    out = np.empty((h, w, img.shape[2]), np.uint8)
    if lib.imgcodec_resize(img.ctypes.data, img.shape[0], img.shape[1],
                           img.shape[2], out.ctypes.data, h, w) != 0:
        _lib_error(lib, "resize")
    LIB_CALLS["resize"] += 1
    return out


def decode(buf, lib: Optional[bool] = None) -> np.ndarray:
    """Decode a baseline JPEG to (H, W, 1 or 3) uint8: the host library on
    the card's context, the plain version under ``mx.cpu()`` (``lib``
    forces one)."""
    buf = bytes(buf)
    if use_library() if lib is None else lib:
        return _lib_decode(buf)
    return decode_plain(buf)


def encode(img, quality: int = 95, sampling: Optional[str] = None,
           restart: int = 0, lib: Optional[bool] = None) -> bytes:
    """Encode (H, W[, 1 or 3]) uint8 as baseline JPEG (see
    :func:`encode_plain`); the library or the plain version by context."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    if sampling is not None and sampling not in SAMPLINGS:
        raise MXNetError("imencode: sampling %r (one of %s)"
                         % (sampling, sorted(SAMPLINGS)))
    if use_library() if lib is None else lib:
        if img.dtype != np.uint8 or img.ndim != 3 or \
                img.shape[2] not in (1, 3):
            raise MXNetError("imencode: JPEG takes (H, W), (H, W, 1) or "
                             "(H, W, 3) uint8, got %s %s"
                             % (img.dtype, img.shape))
        return _lib_encode(img, quality, sampling, restart)
    return encode_plain(img, quality, sampling, restart)


def resize_bilinear(img, w: int, h: int,
                    lib: Optional[bool] = None) -> np.ndarray:
    """Pillow's bilinear resize of (H, W, C) uint8 to (h, w, C): the
    library or the plain version by context (``lib`` forces one)."""
    img = np.asarray(img)
    if use_library() if lib is None else lib:
        if img.dtype != np.uint8 or img.ndim != 3 or w < 1 or h < 1:
            raise MXNetError("resize: (H, W, C) uint8 and a positive size "
                             "expected, got %s %s to %dx%d"
                             % (img.dtype, img.shape, w, h))
        if (w, h) == (img.shape[1], img.shape[0]):
            return img.copy()
        return _lib_resize(img, w, h)
    return resize_plain(img, w, h)
