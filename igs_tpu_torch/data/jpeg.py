"""Baseline JPEG encoder in numpy: the frames of the free-view video.

It writes what PIL (libjpeg) writes for ``Image.save(format="JPEG",
quality=q)``, which the JAX package's ``save_video_avi`` calls:

* JFIF 1.01; YCbCr, full range (BT.601), libjpeg's fixed-point
  conversion; 4:2:0 subsampling, the chroma downsampled by libjpeg's 2×2
  average with its alternating 1/2 rounding bias;
* the IJG (Annex K) quantisation tables scaled for ``quality`` (scale
  ``5000 / q`` below 50, ``200 − 2q`` from 50), the standard Huffman
  tables (Annex K.3), one DQT and one DHT segment per table;
* libjpeg's default DCT (the integer "islow" one) and its rounding
  quantiser; the planes padded to whole 16×16 MCUs as libjpeg pads them:
  the columns repeated before the chroma is downsampled, the rows after,
  and a partial MCU's luma blocks past the image made flat, as libjpeg's
  "dummy blocks" are. The bytes are PIL's for the same image.

The entropy coding (run lengths, size categories, bit packing, byte
stuffing) runs vectorised over every block of the frame. The tables
(``QUANT_LUMA``, ``QUANT_CHROMA``, ``ZIGZAG``, the ``HUFF_*`` bits and
values) are what a baseline decoder needs too.
"""

from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

# zigzag position i → natural (row-major) index of the 8×8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1, natural order
QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
QUANT_CHROMA = np.full(64, 99)
QUANT_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19, 24, 25, 26, 27]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 99, 47, 66, 99, 99]

# Annex K.3: code counts per length 1..16, and the symbols in code order
HUFF_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
                tuple(range(12)))
HUFF_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0),
                  tuple(range(12)))


def _ac_values(head):
    """An AC table's symbols: ``head``, then the (run, size 1..10) symbols
    it does not list, by run and size."""
    rest = [r << 4 | s for r in range(16) for s in range(1, 11)]
    return tuple(head) + tuple(v for v in rest if v not in set(head))


HUFF_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D),
                _ac_values((
                    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21,
                    0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71,
                    0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1,
                    0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
                    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
                    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37,
                    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
                    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
                    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A,
                    0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
                    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92)))
HUFF_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77),
                  _ac_values((
                      0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31,
                      0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
                      0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1,
                      0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
                      0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
                      0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36,
                      0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47,
                      0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
                      0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
                      0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
                      0x82)))


def quant_tables(quality: int) -> Tuple[np.ndarray, np.ndarray]:
    """libjpeg's ``jpeg_set_quality``: the Annex K tables scaled, clamped
    to [1, 255] (baseline), natural order."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return tuple(np.clip((t * scale + 50) // 100, 1, 255).astype(np.int64)
                 for t in (QUANT_LUMA, QUANT_CHROMA))


def huffman_codes(table) -> Tuple[np.ndarray, np.ndarray]:
    """(code, length) per symbol 0..255 of a (bits, values) table (Annex
    C's canonical assignment); unused symbols have length 0."""
    bits, values = table
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(bits, start=1):
        for _ in range(n):
            code_of[values[k]] = code
            len_of[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_TABLES = {name: huffman_codes(t) for name, t in (
    ("dc0", HUFF_DC_LUMA), ("ac0", HUFF_AC_LUMA), ("dc1", HUFF_DC_CHROMA),
    ("ac1", HUFF_AC_CHROMA))}


def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 → (3, H, W) int64 Y, Cb, Cr: libjpeg's
    ``rgb_ycc_convert`` (16-bit fixed point; Cb and Cr round with
    0.5 − ε so 255 stays 255)."""
    fix = lambda x: int(x * 65536 + 0.5)
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off
          + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off
          + half - 1) >> 16
    return np.stack([y, cb, cr])


def downsample_h2v2(c: np.ndarray) -> np.ndarray:
    """libjpeg's ``h2v2_downsample``: the 2×2 sum plus a bias of 1, 2, 1,
    2, … along each output row, shifted right by 2."""
    s = c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2]
    bias = 1 + (np.arange(s.shape[1]) & 1)
    return (s + bias) >> 2


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) with H, W multiples of 8 → (H/8, W/8, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


# jfdctint.c's fixed-point constants (13 fractional bits)
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299,
                            15137, 16069, 16819, 20995, 25172)


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of libjpeg's ``jpeg_fdct_islow`` over the last axis."""
    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    bits = _CONST_BITS - _PASS1_BITS if first else _CONST_BITS + _PASS1_BITS
    if first:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
    z1 = (tmp12 + tmp13) * _F0541
    out[2] = _descale(z1 + tmp13 * _F0765, bits)
    out[6] = _descale(z1 - tmp12 * _F1847, bits)
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * _F1175
    tmp4, tmp5 = tmp4 * _F0298, tmp5 * _F2053
    tmp6, tmp7 = tmp6 * _F3072, tmp7 * _F1501
    z1, z2 = -z1 * _F0899, -z2 * _F2562
    z3, z4 = -z3 * _F1961 + z5, -z4 * _F0390 + z5
    out[7] = _descale(tmp4 + z1 + z3, bits)
    out[5] = _descale(tmp5 + z2 + z4, bits)
    out[3] = _descale(tmp6 + z2 + z3, bits)
    out[1] = _descale(tmp7 + z1 + z4, bits)
    return np.stack(out, axis=-1)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's integer "islow" forward DCT of (..., 8, 8) level-shifted
    int64 blocks: 8× the orthonormal DCT, rounded as libjpeg rounds."""
    rows = _fdct_pass(blocks, first=True)
    return _fdct_pass(np.swapaxes(rows, -1, -2), first=False).swapaxes(
        -1, -2)


def _quantise(blocks: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Level-shifted islow DCT of (..., 8, 8) blocks, divided by 8× the
    table with rounding half away from zero (libjpeg's ``quantize``) →
    (..., 64) coefficients in zigzag order."""
    coef = fdct_islow(blocks.astype(np.int64) - 128)
    coef = coef.reshape(coef.shape[:-2] + (64,))[..., ZIGZAG]
    qval = (qt[ZIGZAG] * 8).astype(np.int64)
    mag = (np.abs(coef) + (qval >> 1)) // qval
    return np.where(coef < 0, -mag, mag)


def _bit_length(v: np.ndarray) -> np.ndarray:
    """Size category: bits of |v| (0 for 0)."""
    a = np.abs(v)
    out = np.zeros(a.shape, np.int64)
    nz = a > 0
    out[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return out


def _extra_bits(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << size) - 1)


def _entropy_code(coefs: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code (n_blocks, 64) zigzag coefficients in scan order;
    ``comp[i]``: 0 for a luma block, 1 or 2 for Cb or Cr (DC predictions
    per component) → the stuffed scan bytes."""
    nb = coefs.shape[0]
    table = (comp > 0).astype(np.int64)  # 0 luma tables, 1 chroma
    # DC: the difference to the previous block of the same component
    dc = coefs[:, 0]
    diff = np.empty(nb, np.int64)
    for c in range(3):
        idx = np.nonzero(comp == c)[0]
        d = dc[idx]
        diff[idx] = np.diff(d, prepend=0)
    dsize = _bit_length(diff)
    dcode = np.where(table == 0, _TABLES["dc0"][0][dsize],
                     _TABLES["dc1"][0][dsize])
    dlen = np.where(table == 0, _TABLES["dc0"][1][dsize],
                    _TABLES["dc1"][1][dsize])
    # AC: the nonzero coefficients with their zero runs
    ac = coefs[:, 1:]
    blk, pos = np.nonzero(ac)
    k = pos + 1
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.zeros(len(blk), np.int64)
    prev[1:] = k[:-1]
    prev[first] = 0
    run = k - prev - 1
    n_zrl, run = run // 16, run % 16
    vals = ac[blk, pos]
    asize = _bit_length(vals)
    sym = run << 4 | asize
    t = table[blk]
    acode = np.where(t == 0, _TABLES["ac0"][0][sym], _TABLES["ac1"][0][sym])
    alen = np.where(t == 0, _TABLES["ac0"][1][sym], _TABLES["ac1"][1][sym])
    # ZRL (run of 16 zeros) items before their coefficient: at most 3
    z_item = np.repeat(np.arange(len(blk)), n_zrl)
    z_j = np.arange(len(z_item)) - np.repeat(np.cumsum(n_zrl) - n_zrl,
                                             n_zrl)
    zt = t[z_item]
    zcode = np.where(zt == 0, _TABLES["ac0"][0][0xF0], _TABLES["ac1"][0][0xF0])
    zlen = np.where(zt == 0, _TABLES["ac0"][1][0xF0], _TABLES["ac1"][1][0xF0])
    # EOB where the block ends in zeros
    last = np.zeros(nb, np.int64)
    last[blk] = k  # row-major nonzero: the last write is the largest k
    eob_blk = np.nonzero(last < 63)[0]
    et = table[eob_blk]
    ecode = np.where(et == 0, _TABLES["ac0"][0][0], _TABLES["ac1"][0][0])
    elen = np.where(et == 0, _TABLES["ac0"][1][0], _TABLES["ac1"][1][0])

    slot = 4 * 64 + 1  # order inside a block: DC, then per k ZRLs and AC
    key = np.concatenate([
        np.arange(nb) * slot,
        blk * slot + 4 * k + 3,
        blk[z_item] * slot + 4 * k[z_item] + z_j,
        eob_blk * slot + 4 * 64])
    value = np.concatenate([
        dcode << dsize | np.where(dsize > 0, _extra_bits(diff, dsize), 0),
        acode << asize | _extra_bits(vals, asize),
        zcode, ecode])
    length = np.concatenate([dlen + dsize, alen + asize, zlen, elen])
    order = np.argsort(key, kind="stable")
    value, length = value[order], length[order]

    total = int(length.sum())
    start = np.cumsum(length) - length
    item = np.repeat(np.arange(len(length)), length)
    shift = length[item] - 1 - (np.arange(total) - start[item])
    bits = ((value[item] >> shift) & 1).astype(np.uint8)
    pad = -total % 8  # fill the last byte with ones
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    data = np.packbits(bits)
    ff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, ff + 1, 0).tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(body) + 2) + body


def _dht(cls_id: int, table) -> bytes:
    bits, values = table
    return _segment(0xC4, bytes([cls_id]) + bytes(bits) + bytes(values))


def encode_jpeg(img: np.ndarray, quality: int = 92) -> bytes:
    """(H, W, 3) uint8 RGB → baseline JFIF bytes, 4:2:0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want (H, W, 3) uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    qy, qc = quant_tables(quality)
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    # libjpeg pads the columns before downsampling but the rows after:
    # to an even count first, then each plane's last row to the MCU
    padded = np.pad(img, ((0, h % 2), (0, wp - w), (0, 0)), mode="edge")
    y, cb, cr = rgb_to_ycbcr(padded)
    y = np.pad(y, ((0, hp - y.shape[0]), (0, 0)), mode="edge")
    cb, cr = (np.pad(downsample_h2v2(c), ((0, hp // 2 - (h + 1) // 2),
                                          (0, 0)), mode="edge")
              for c in (cb, cr))
    my, mx = hp // 16, wp // 16
    # Y blocks of each MCU in raster order: (my, mx, 2, 2, 8, 8)
    yb = _blocks(y).reshape(my, 2, mx, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
    yq = _quantise(yb, qy)  # (my, mx, 2, 2, 64)
    # libjpeg's dummy blocks: a luma block column or row of the last MCU
    # past the image's blocks is flat, with the DC of the block before it
    # in the MCU (columns first, then rows)
    if -(-w // 8) % 2:
        yq[:, -1, :, 1, 1:] = 0
        yq[:, -1, :, 1, 0] = yq[:, -1, :, 0, 0]
    if -(-h // 8) % 2:
        yq[-1, :, 1, :, 1:] = 0
        yq[-1, :, 1, :, 0] = yq[-1, :, 0, 1, 0][:, None]
    yq = yq.reshape(my * mx, 4, 64)
    cq = [_quantise(_blocks(c), qc).reshape(my * mx, 1, 64) for c in (cb, cr)]
    coefs = np.concatenate([yq] + cq, axis=1).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    scan = _entropy_code(coefs, comp)

    head = b"\xff\xd8" + _segment(
        0xE0, b"JFIF\x00" + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1)
        + b"\x00\x00")
    for i, qt in enumerate((qy, qc)):
        head += _segment(0xDB, bytes([i]) + bytes(qt[ZIGZAG].tolist()))
    head += _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                     + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls_id, table in ((0x00, HUFF_DC_LUMA), (0x10, HUFF_AC_LUMA),
                          (0x01, HUFF_DC_CHROMA), (0x11, HUFF_AC_CHROMA)):
        head += _dht(cls_id, table)
    head += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return head + scan + b"\xff\xd9"


def segments(data: bytes) -> Dict[int, list]:
    """Marker → the bodies of its segments, in order, up to SOS (a
    header walk for tests and checks)."""
    out: Dict[int, list] = {}
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at {pos}")
        marker = data[pos + 1]
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.setdefault(marker, []).append(data[pos + 4:pos + 2 + n])
        pos += 2 + n
        if marker == 0xDA:
            break
    return out
