"""Baseline JPEG in numpy: the encoder of the free-view video and the
decoder of JPEG inputs (``scene_type: enerf``, the ``metrics`` CLI).

The encoder writes what PIL (libjpeg) writes for ``Image.save(format=
"JPEG", quality=q)``, which the JAX package's ``save_video_avi`` calls:

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
stuffing) runs vectorised over every block of the frame.

The decoder (``decode_jpeg``) returns the pixels PIL returns
(``np.asarray(Image.open(f))``, PIL's libjpeg-turbo at its defaults) for
baseline, extended sequential and progressive Huffman files (SOF0, SOF1,
SOF2) of 8-bit samples with 1, 3 or 4 components, each component
sampled at the frame's largest factors or at any integral fraction of
them (4:4:4, 4:2:2, 4:2:0, 4:1:1, 4:4:0, and PIL's CMYK files),
with or without restart intervals, in one interleaved scan or one scan a
component. It reads the DQT and DHT segments of the file (libjpeg-turbo's
standard tables stand in for a Huffman table the file leaves out, as in
motion-JPEG frames) and follows libjpeg where the pixels depend on it:
the islow integer inverse DCT with its range limit, the "fancy" triangle
upsampling of the chroma (``h2v1_fancy_upsample``,
``h2v2_fancy_upsample``, with their 1/2 and 8/7 rounding biases, and the
box upsampling libjpeg falls back to for planes at most 2 samples wide;
libjpeg-turbo's ``h1v2_fancy_upsample`` for 4:4:0; plain replication,
``int_upsample``, for 4:1:1 and every other integral ratio),
the edges replicated at the chroma's own width and height, and the
fixed-point YCbCr→RGB tables. Four components are CMYK, or YCCK where
an Adobe marker says so (``ycck_cmyk_convert``), given as PIL gives
them: its "CMYK;I" raw mode inverts every channel. A progressive file's
scans (DC first and refine, AC first with end-of-band runs, AC refine
with correction bits, as libjpeg's ``jdphuff.c``) accumulate into the
same coefficients, which go through the same inverse DCT once the last
scan is read; where the scans leave coefficients 1..9 short of their
last bit (a file cut after an early scan), libjpeg-turbo's block
smoothing (``jdcoefct.c``) estimates them from the 5x5 neighbourhood of
DC values first (``smooth_blocks``). Everything else raises by name:
lossless, hierarchical and arithmetic-coded files, 12-bit samples, 2
components and fractional sampling (which libjpeg refuses too).

The Huffman decode is sequential: a loop over the symbols, each looked
up in a 65536-entry table of the next 16 bits that gives the code's
length, its run and, when the extra bits fit in the same 16 bits, the
coefficient itself (libjpeg-turbo's lookahead, widened). The dequantise,
the inverse DCT, the upsampling and the colour conversion run vectorised
over every block of the image.
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


def _marker_at(data: bytes, pos: int) -> Tuple[int, int, int]:
    """The segment at ``pos``: (marker, body start, body end = the next
    segment's position). Fill bytes (0xFF runs) before the marker are
    skipped; SOI, EOI, RSTn and TEM have no body."""
    if data[pos] != 0xFF:
        raise ValueError(f"JPEG: no marker at byte {pos}")
    while pos < len(data) - 1 and data[pos + 1] == 0xFF:
        pos += 1
    marker, pos = data[pos + 1], pos + 2
    if marker in (0xD8, 0xD9, 0x01) or 0xD0 <= marker <= 0xD7:
        return marker, pos, pos
    length = struct.unpack(">H", data[pos:pos + 2])[0]
    return marker, pos + 2, pos + length


def segments(data: bytes) -> Dict[int, list]:
    """Marker → the bodies of its segments, in order, up to SOS (a
    header walk for tests and checks)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    out: Dict[int, list] = {}
    pos = 2
    while pos < len(data):
        marker, a, pos = _marker_at(data, pos)
        out.setdefault(marker, []).append(data[a:pos])
        if marker in (0xDA, 0xD9):
            break
    return out


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

# the frame types the decoder refuses, by name
_SOF_REFUSED = {
    0xC3: "lossless (SOF3)",
    0xC5: "differential sequential DCT (SOF5, hierarchical)",
    0xC6: "differential progressive DCT (SOF6, hierarchical)",
    0xC7: "differential lossless (SOF7, hierarchical)",
    0xC9: "arithmetic-coded sequential DCT (SOF9)",
    0xCA: "arithmetic-coded progressive DCT (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCD: "arithmetic-coded differential sequential DCT (SOF13)",
    0xCE: "arithmetic-coded differential progressive DCT (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
# zigzag position → natural index, for positions up to 79: a corrupt run
# past the block's end lands on coefficient 63, as libjpeg's padded table
# does
_NATURAL = ZIGZAG.tolist() + [63] * 16
_STD_HUFF = {(0, 0): HUFF_DC_LUMA, (0, 1): HUFF_DC_CHROMA,
             (1, 0): HUFF_AC_LUMA, (1, 1): HUFF_AC_CHROMA}


def _sof(marker: int, body: bytes) -> Dict:
    if marker in _SOF_REFUSED:
        raise NotImplementedError(
            f"JPEG: {_SOF_REFUSED[marker]} is not supported; the decoder "
            "reads baseline, extended sequential and progressive Huffman "
            "files")
    precision, h, w, nf = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise NotImplementedError(
            f"JPEG: {precision}-bit samples are not supported (8-bit only)")
    if nf not in (1, 3, 4):
        raise NotImplementedError(
            f"JPEG: {nf} components are not supported; 1 (greyscale), 3 "
            "(YCbCr/RGB) or 4 (CMYK/YCCK)")
    if h == 0:
        raise NotImplementedError("JPEG: a height set by a DNL marker is not "
                                  "supported")
    comps = []
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    return {"height": h, "width": w, "comps": comps,
            "progressive": marker == 0xC2}


def _is_sof(marker: int) -> bool:
    return 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC)


def jpeg_size(path: str) -> Tuple[int, int]:
    """(width, height) of a JPEG file, from its SOF segment."""
    with open(path, "rb") as f:
        segs = segments(f.read())
    for marker, bodies in segs.items():
        if _is_sof(marker):
            h, w = struct.unpack(">HH", bodies[0][1:5])
            return w, h
    raise ValueError(f"{path}: no SOF segment before the scan")


def _lookup(table, ac: bool) -> list:
    """The 65536-entry lookahead of a Huffman table, indexed by the next
    16 bits of the stream. An entry ``e > 0`` is a whole symbol with its
    extra bits: length ``e & 31``, the zigzag advance ``(e >> 5) & 127``
    (AC: run + 1, 16 for ZRL, 0 for end of block) and the coefficient
    ``(e >> 12) - 32768``. ``e < 0`` is a code whose extra bits pass the
    16: ``-e - 1`` holds its length, size and advance (``_slow``); ``e ==
    0`` is no code."""
    code_of, len_of = huffman_codes(table)
    length = np.zeros(65536, np.int64)
    sym = np.zeros(65536, np.int64)
    for s in np.flatnonzero(len_of):
        n = int(len_of[s])
        lo = int(code_of[s]) << (16 - n)
        length[lo:lo + (1 << (16 - n))] = n
        sym[lo:lo + (1 << (16 - n))] = s
    if ac:
        run, size = sym >> 4, sym & 15
        adv = np.where(size > 0, run + 1, np.where(run == 15, 16, 0))
    else:
        if max(table[1], default=0) > 15:
            raise ValueError("JPEG: a DC Huffman table holds a size past 15")
        size, adv = sym, np.zeros_like(sym)
    total = length + size
    idx = np.arange(65536)
    extra = (idx >> np.maximum(16 - total, 0)) & ((1 << size) - 1)
    value = np.where(extra < (1 << np.maximum(size - 1, 0)),
                     extra - (1 << size) + 1, extra)
    value = np.where(size == 0, 0, value)
    fast = total | adv << 5 | (value + 32768) << 12
    slow = -(1 + (length | size << 5 | adv << 9))
    out = np.where(length == 0, 0, np.where(total <= 16, fast, slow))
    return out.tolist()


def _slow(e: int, w: int, p: int) -> int:
    """A lookahead entry whose extra bits pass the 16, completed from the
    40-bit window ``w`` holding bit ``p``: the fast entry's layout."""
    info = -e - 1
    n, size, adv = info & 31, (info >> 5) & 15, info >> 9
    w32 = (w >> (8 - (p & 7))) & 0xFFFFFFFF
    extra = (w32 >> (32 - n - size)) & ((1 << size) - 1)
    value = 0 if size == 0 else (
        extra if extra >= 1 << (size - 1) else extra - (1 << size) + 1)
    return (n + size) | adv << 5 | (value + 32768) << 12


def _scan_bytes(data: bytes, pos: int):
    """The entropy-coded data from ``pos``: (bytes with the stuffing and
    the RSTn markers taken out, the bit offset at which each restart
    segment starts, the position of the marker that ends the scan)."""
    arr = np.frombuffer(data, np.uint8, offset=pos)
    ff = np.flatnonzero(arr[:-1] == 0xFF)
    nxt = arr[ff + 1]
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ff[(nxt != 0) & ~is_rst]
    end = int(ends[0]) if len(ends) else len(arr)
    keep = np.ones(end, bool)
    inside = ff < end
    stuffed = ff[inside & (nxt == 0)]
    rst = ff[inside & is_rst]
    keep[stuffed + 1] = False
    keep[rst] = False
    keep[rst + 1] = False
    starts = np.cumsum(keep) - keep  # kept bytes before each byte
    seg_bits = [0] + (8 * starts[rst]).tolist()
    return arr[:end][keep], seg_bits, pos + end


def _windows(scan: np.ndarray) -> list:
    """Per byte i of the scan, bytes i..i+4 as one 40-bit integer (zeros
    past the end, as libjpeg feeds zeros at a marker)."""
    u = np.concatenate([scan, np.zeros(16, np.uint8)]).astype(np.int64)
    n = len(scan) + 8
    return (u[:n] << 32 | u[1:n + 1] << 24 | u[2:n + 2] << 16
            | u[3:n + 3] << 8 | u[4:n + 4]).tolist()


def _decode_scan(win, seg_bits, blocks, restart, coef):
    """Huffman-decode one scan into the flat coefficient list ``coef``.
    ``blocks``: per block in scan order (base offset in ``coef``, DC
    lookahead, AC lookahead, component slot); ``restart``: blocks per
    restart interval (0: none)."""
    nat = _NATURAL
    slow = _slow
    pred = [0, 0, 0, 0]
    p = 0
    seg = 0
    for i, (base, dct, act, c) in enumerate(blocks):
        if restart and i and i % restart == 0:
            seg += 1
            if seg >= len(seg_bits):
                raise ValueError("JPEG: fewer RST markers than the restart "
                                 "interval needs")
            p = seg_bits[seg]
            pred = [0, 0, 0, 0]
        w = win[p >> 3]
        e = dct[(w >> (24 - (p & 7))) & 0xFFFF]
        if e <= 0:
            if e == 0:
                raise ValueError(f"JPEG: bad Huffman code at bit {p}")
            e = slow(e, w, p)
        p += e & 31
        pred[c] += (e >> 12) - 32768
        coef[base] = pred[c]
        k = 1
        while k < 64:
            w = win[p >> 3]
            e = act[(w >> (24 - (p & 7))) & 0xFFFF]
            if e <= 0:
                if e == 0:
                    raise ValueError(f"JPEG: bad Huffman code at bit {p}")
                e = slow(e, w, p)
            p += e & 31
            adv = (e >> 5) & 127
            if not adv:
                break
            k += adv
            coef[base + nat[k - 1]] = (e >> 12) - 32768


def _symbols(table) -> list:
    """The 65536-entry lookahead of a Huffman table for the progressive
    AC scans: ``length | symbol << 5`` per next 16 bits, 0 for no code."""
    code_of, len_of = huffman_codes(table)
    out = np.zeros(65536, np.int64)
    for sym in np.flatnonzero(len_of):
        n = int(len_of[sym])
        lo = int(code_of[sym]) << (16 - n)
        out[lo:lo + (1 << (16 - n))] = n | int(sym) << 5
    return out.tolist()


def _decode_progressive(win, seg_bits, blocks, restart, coef, ss, se, ah,
                        al):
    """Huffman-decode one progressive scan (libjpeg's ``jdphuff.c``) into
    ``coef``: DC first (``ss == 0``, ``ah == 0``; ``blocks`` carry the DC
    lookahead), DC refine (one bit a block), AC first with end-of-band
    runs and AC refine with correction bits (``blocks`` carry the
    ``_symbols`` lookahead of their AC table). Coefficients are scaled by
    ``1 << al`` as they land; refinements add that bit."""
    nat = _NATURAL
    p1, m1 = 1 << al, -1 << al
    pred = [0, 0, 0, 0]
    eobrun = 0
    p = 0
    seg = 0

    def bad(at):
        return ValueError(f"JPEG: bad Huffman code at bit {at}")

    for i, (base, dct, act, c) in enumerate(blocks):
        if restart and i and i % restart == 0:
            seg += 1
            if seg >= len(seg_bits):
                raise ValueError("JPEG: fewer RST markers than the restart "
                                 "interval needs")
            p = seg_bits[seg]
            pred = [0, 0, 0, 0]
            eobrun = 0
        if ss == 0:
            if ah:  # DC refine
                if (win[p >> 3] >> (39 - (p & 7))) & 1:
                    coef[base] |= p1
                p += 1
                continue
            w = win[p >> 3]
            e = dct[(w >> (24 - (p & 7))) & 0xFFFF]
            if e <= 0:
                if e == 0:
                    raise bad(p)
                e = _slow(e, w, p)
            p += e & 31
            pred[c] += (e >> 12) - 32768
            coef[base] = pred[c] << al
            continue
        k = ss
        if not ah:  # AC first
            if eobrun:
                eobrun -= 1
                continue
            while k <= se:
                e = act[(win[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
                if not e:
                    raise bad(p)
                p += e & 31
                r, size = e >> 9, (e >> 5) & 15
                if size:
                    k += r
                    v = (win[p >> 3] >> (40 - (p & 7) - size)) & (
                        (1 << size) - 1)
                    p += size
                    if v < 1 << (size - 1):
                        v -= (1 << size) - 1
                    coef[base + nat[k]] = v << al
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (40 - (p & 7) - r)) & (
                            (1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break
                k += 1
            continue
        # AC refine
        if not eobrun:
            while k <= se:
                e = act[(win[p >> 3] >> (24 - (p & 7))) & 0xFFFF]
                if not e:
                    raise bad(p)
                p += e & 31
                r, size = e >> 9, (e >> 5) & 15
                new = 0
                if size:
                    new = p1 if (win[p >> 3] >> (39 - (p & 7))) & 1 else m1
                    p += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += (win[p >> 3] >> (40 - (p & 7) - r)) & (
                            (1 << r) - 1)
                        p += r
                    break
                while k <= se:  # skip r zeros, refining the nonzeros
                    at = base + nat[k]
                    v = coef[at]
                    if v:
                        if (win[p >> 3] >> (39 - (p & 7))) & 1 \
                                and not v & p1:
                            coef[at] = v + (p1 if v >= 0 else m1)
                        p += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if new:
                    coef[base + nat[k]] = new
                k += 1
        if eobrun:
            while k <= se:  # the band's end: correction bits only
                at = base + nat[k]
                v = coef[at]
                if v:
                    if (win[p >> 3] >> (39 - (p & 7))) & 1 and not v & p1:
                        coef[at] = v + (p1 if v >= 0 else m1)
                    p += 1
                k += 1
            eobrun -= 1


# jidctint.c's constants (13 fractional bits), as the forward DCT's
def _idct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of libjpeg's ``jpeg_idct_islow`` over the last axis
    (int64): columns first (``first``, descaled by 11 bits), then rows
    (descaled by 18, the range limit left to the caller)."""
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[..., 0] + d[..., 4]) << _CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = -z1 * _F0899, -z2 * _F2562
    z3, z4 = -z3 * _F1961 + z5, -z4 * _F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    n = (_CONST_BITS - _PASS1_BITS if first
         else _CONST_BITS + _PASS1_BITS + 3)
    out = (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)
    return np.stack([_descale(x, n) for x in out], axis=-1)


# libjpeg's post-IDCT range limit, indexed by the descaled value & 1023:
# −128..127 → 0..255, past it saturated, the wrap of the table kept
_RANGE_LIMIT = np.clip(((np.arange(1024) ^ 512) - 512) + 128, 0,
                       255).astype(np.uint8)


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(..., 64) natural-order coefficients and their natural-order
    quantisation table → (..., 8, 8) uint8 samples: libjpeg's islow
    inverse DCT with its range limit."""
    blocks = (coef.astype(np.int64) * qt.astype(np.int64)).reshape(
        coef.shape[:-1] + (8, 8))
    cols = _idct_pass(np.swapaxes(blocks, -1, -2), first=True)
    rows = _idct_pass(np.swapaxes(cols, -1, -2), first=False)
    return _RANGE_LIMIT[rows & 1023]


def _edge(c: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """The plane's neighbours before and after along ``axis``, the edges
    replicated."""
    n = c.shape[axis]
    idx = np.arange(n)
    prev = np.take(c, np.maximum(idx - 1, 0), axis=axis)
    nxt = np.take(c, np.minimum(idx + 1, n - 1), axis=axis)
    return prev, nxt


def upsample_h2v1(c: np.ndarray) -> np.ndarray:
    """libjpeg's ``h2v1_fancy_upsample`` (triangle filter, biases 1 and
    2), or the box filter for a plane at most 2 samples wide."""
    c = c.astype(np.int32)
    if c.shape[1] <= 2:
        return np.repeat(c, 2, axis=1).astype(np.uint8)
    prev, nxt = _edge(c, 1)
    out = np.empty((c.shape[0], 2 * c.shape[1]), np.int32)
    out[:, 0::2] = (3 * c + prev + 1) >> 2
    out[:, 1::2] = (3 * c + nxt + 2) >> 2
    return out.astype(np.uint8)


def upsample_h2v2(c: np.ndarray) -> np.ndarray:
    """libjpeg's ``h2v2_fancy_upsample`` (3/4–1/4 in each direction, the
    column sums' biases 8 and 7), or the box filter for a plane at most 2
    samples wide."""
    c = c.astype(np.int32)
    if c.shape[1] <= 2:
        return np.repeat(np.repeat(c, 2, axis=0), 2, axis=1).astype(np.uint8)
    above, below = _edge(c, 0)
    out = np.empty((2 * c.shape[0], 2 * c.shape[1]), np.int32)
    for r, other in ((0, above), (1, below)):
        col = 3 * c + other  # the column sums of output row 2i + r
        prev, nxt = _edge(col, 1)
        out[r::2, 0::2] = (3 * col + prev + 8) >> 4
        out[r::2, 1::2] = (3 * col + nxt + 7) >> 4
    return out.astype(np.uint8)


def upsample_h1v2(c: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's ``h1v2_fancy_upsample`` (4:4:0): each output row
    3/4 of its input row and 1/4 of the row above (bias 1) or below
    (bias 2), the edge rows replicated."""
    c = c.astype(np.int32)
    above, below = _edge(c, 0)
    out = np.empty((2 * c.shape[0], c.shape[1]), np.int32)
    out[0::2] = (3 * c + above + 1) >> 2
    out[1::2] = (3 * c + below + 2) >> 2
    return out.astype(np.uint8)


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


# jdcolor.c's build_ycc_rgb_table, indexed by Cb or Cr
_X = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix(1.40200) * _X + (1 << 15)) >> 16
_CB_B = (_fix(1.77200) * _X + (1 << 15)) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + (1 << 15)


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                 ) -> np.ndarray:
    """libjpeg's ``ycc_rgb_convert`` of three uint8 planes → (H, W, 3)."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _color_space(comps, jfif: bool, adobe) -> str:
    """libjpeg's guess of a file's colour space (``jdapimin.c``): for 4
    components CMYK unless an Adobe marker names another transform than
    0 (YCCK); for 3 a JFIF marker, then an Adobe transform, then the
    component ids."""
    if len(comps) == 4:
        return "CMYK" if adobe in (None, 0) else "YCCK"
    if jfif:
        return "YCbCr"
    if adobe is not None:
        return "RGB" if adobe == 0 else "YCbCr"
    ids = [c["id"] for c in comps]
    return "RGB" if ids == [82, 71, 66] else "YCbCr"


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline, extended sequential or progressive Huffman JPEG →
    uint8 (H, W, 3) RGB, or (H, W) for a greyscale file: the pixels of
    ``np.asarray(PIL.Image.open(...))``. Other kinds raise
    ``NotImplementedError`` by name; a malformed file ``ValueError``."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError("JPEG: no SOI")
    qts: Dict[int, np.ndarray] = {}
    hts: Dict[Tuple[int, int], tuple] = {}
    frame = None
    restart = 0
    jfif, adobe = False, None
    coef: list = []
    offsets: list = []
    latched: Dict[int, np.ndarray] = {}
    pos = 2
    while pos < len(data):
        marker, a, pos = _marker_at(data, pos)
        body = data[a:pos]
        if marker == 0xD9:
            break
        if marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1:i + 1 + n],
                                     ">u2" if pq else np.uint8)
                qt = np.zeros(64, np.int64)
                qt[ZIGZAG] = vals
                qts[tq] = qt
                i += 1 + n
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                bits = tuple(body[i + 1:i + 17])
                n = sum(bits)
                hts[(tc, th)] = (bits, tuple(body[i + 17:i + 17 + n]))
                i += 17 + n
        elif marker == 0xDD:
            restart = struct.unpack(">H", body[:2])[0]
        elif marker == 0xCC:
            raise NotImplementedError(
                "JPEG: arithmetic coding (DAC) is not supported")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif _is_sof(marker):
            if frame is not None:
                raise ValueError("JPEG: a second SOF")
            frame = _sof(marker, body)
            comps = frame["comps"]
            # per component, the Al each coefficient was last scanned at
            # (-1: not yet), as libjpeg's coef_bits
            frame["bits"] = [[-1] * 64 for _ in comps]
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux = -(-frame["width"] // (8 * hmax))
            mcuy = -(-frame["height"] // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"] = -(-frame["width"] * c["h"] // hmax)
                c["h_px"] = -(-frame["height"] * c["v"] // vmax)
                offsets.append(len(coef))
                coef.extend([0] * (c["bw"] * c["bh"] * 64))
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG: SOS before SOF")
            pos = _read_scan(data, body, pos, frame, qts, hts, restart,
                             coef, offsets, latched)
        elif marker == 0xDC:
            raise NotImplementedError("JPEG: DNL markers are not supported")
    if frame is None:
        raise ValueError("JPEG: no SOF")
    if not latched:
        raise ValueError("JPEG: no scan")
    comps = frame["comps"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    coef_arr = np.asarray(coef, np.int64)
    # a progressive file whose scans leave coefficients 1..9 short of
    # their last bit: libjpeg estimates them from the neighbours' DCs
    smooth = _smoothing_ok(frame, latched)
    planes = []
    for i, c in enumerate(comps):
        qt = latched.get(i, np.zeros(64, np.int64))
        n = c["bw"] * c["bh"] * 64
        blk = coef_arr[offsets[i]:offsets[i] + n].reshape(c["bh"], c["bw"],
                                                          64)
        if smooth:
            blk = smooth_blocks(blk, c, frame["bits"][i], qt,
                                -(-frame["height"] // (8 * vmax)))
        px = idct_islow(blk, qt).transpose(0, 2, 1, 3).reshape(
            8 * c["bh"], 8 * c["bw"])
        planes.append(px[:c["h_px"], :c["w"]])
    h, w = frame["height"], frame["width"]
    if len(comps) == 1:
        return np.ascontiguousarray(planes[0][:h, :w])
    full = []
    for c, px in zip(comps, planes):
        fh, fv = hmax // c["h"], vmax // c["v"]
        if hmax % c["h"] or vmax % c["v"]:
            raise NotImplementedError(
                "JPEG: sampling factors "
                f"{[(k['h'], k['v']) for k in comps]} are not supported; "
                "each component's must divide the largest (libjpeg: "
                "fractional sampling)")
        if (fh, fv) == (2, 1):
            px = upsample_h2v1(px)
        elif (fh, fv) == (2, 2):
            px = upsample_h2v2(px)
        elif (fh, fv) == (1, 2):
            px = upsample_h1v2(px)
        elif (fh, fv) != (1, 1):
            # libjpeg's int_upsample (4:1:1 and every other integral
            # ratio): no fancy filter, each sample repeated
            px = np.repeat(np.repeat(px, fv, axis=0), fh, axis=1)
        full.append(px[:h, :w])
    space = _color_space(comps, jfif, adobe)
    if space == "RGB":
        return np.stack(full, axis=-1)
    if space == "YCbCr":
        return ycbcr_to_rgb(*full)
    # libjpeg's CMYK output (``ycck_cmyk_convert`` for YCCK: the inverted
    # RGB of the YCC, K kept), then PIL's "CMYK;I" raw mode, which inverts
    # every channel (Adobe's convention)
    if space == "YCCK":
        return np.concatenate(
            [ycbcr_to_rgb(*full[:3]), 255 - full[3][..., None]], axis=-1)
    return 255 - np.stack(full, axis=-1)


# block smoothing (libjpeg-turbo 3.1 ``jdcoefct.c``): the natural-order
# positions of coefficients 1..9 of ``coef_bits`` (Q01, Q10, Q20, Q11, Q02,
# Q03, Q12, Q21, Q30), and the weights of the 5x5 neighbourhood of DC
# values (rows above to below, columns left to right) by which each is
# estimated: with AC data present ("plain", Annex K.8 on a 5x5 window),
# and with none (DC interpolation, which also re-estimates the DC)
_SMOOTH_POS = (1, 8, 16, 9, 2, 3, 10, 17, 24)
_W01 = np.array([[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3],
                 [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3],
                 [-1, -1, 0, 1, 1]])
_W01_PLAIN = np.zeros((5, 5), np.int64)
_W01_PLAIN[2] = (-7, 50, 0, -50, 7)
_W20 = np.array([[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
                 [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]])
_W20_PLAIN = np.zeros((5, 5), np.int64)
_W20_PLAIN[:, 2] = (-1, 13, -24, 13, -1)
_W11 = np.array([[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
                 [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]])
_W11_PLAIN = np.array([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1],
                       [0, 0, 0, 0, 0], [1, -10, 0, 10, -1],
                       [0, 1, 0, -1, 0]])
_W03 = np.zeros((5, 5), np.int64)
_W03[1:4, 1], _W03[1:4, 3] = (1, 2, 1), (-1, -2, -1)
_W12 = np.zeros((5, 5), np.int64)
_W12[1, 1:4], _W12[3, 1:4] = (1, -3, 1), (-1, 3, -1)
_WDC = np.array([[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
                 [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
                 [-2, -6, -8, -6, -2]])
# (with DC interpolation, plain) per coefficient 1..9; None: not estimated
_SMOOTH_W = ((_W01, _W01_PLAIN), (_W01.T, _W01_PLAIN.T), (_W20, _W20_PLAIN),
             (_W11, _W11_PLAIN), (_W20.T, _W20_PLAIN.T), (_W03, None),
             (_W12, None), (_W12.T, None), (_W03.T, None))


def _smoothing_ok(frame, latched) -> bool:
    """libjpeg's ``smoothing_ok``: a progressive file, every component's
    quantisation table latched with its DC and coefficients 1..9 nonzero,
    every component's DC scanned, and some component's coefficients
    1..9 not all at their last bit."""
    if not frame["progressive"]:
        return False
    useful = False
    for i, bits in enumerate(frame["bits"]):
        qt = latched.get(i)
        if (qt is None or qt[0] == 0 or any(qt[p] == 0 for p in _SMOOTH_POS)
                or bits[0] < 0):
            return False
        useful |= any(b != 0 for b in bits[1:10])
    return useful


def _smooth_rows(comp, imcu_rows: int) -> np.ndarray:
    """(real block rows, 5): the block rows ``decompress_smooth_data``
    reads two above to two below each of the component's block rows. Its
    own indexing is kept: in the last iMCU row the row's number counts
    that row's block rows only, so an edge test there can replicate a row
    that exists."""
    v, rows = comp["v"], -(-comp["h_px"] // 8)
    out = []
    for a in range(rows):
        r, br = divmod(a, v)
        per = v if r < imcu_rows - 1 else (rows % v or v)
        n, at = per * imcu_rows, r * per + br
        prev = a - 1 if at > 0 else a
        nxt = a + 1 if at < n - 1 else a
        out.append((a - 2 if at > 1 else prev, prev, a, nxt,
                    a + 2 if at < n - 2 else nxt))
    return np.array(out, np.int64)


def _estimate(num: np.ndarray, q: int, al: int) -> np.ndarray:
    """``pred`` of ``num`` over a quantiser: rounded magnitude, capped
    below 2^Al when Al > 0, the sign put back."""
    q = int(q)
    mag = np.where(num >= 0, ((q << 7) + num) // (q << 8),
                   ((q << 7) - num) // (q << 8))
    if al > 0:
        mag = np.minimum(mag, (1 << al) - 1)
    return np.where(num >= 0, mag, -mag)


def smooth_blocks(blk: np.ndarray, comp, bits, qt: np.ndarray,
                  imcu_rows: int) -> np.ndarray:
    """libjpeg-turbo's block smoothing of one component's (rows, cols, 64)
    natural-order coefficients: each of coefficients 1..9 that is still 0
    and not known exactly (its ``coef_bits`` not 0) is estimated from the
    5x5 neighbourhood of DC values, capped below 2^Al; when no AC
    coefficient was scanned at all the DC is re-estimated too. Columns
    past the edge replicate the edge block; rows follow
    ``_smooth_rows``. Returns a copy."""
    rows = _smooth_rows(comp, imcu_rows)
    ncol = -(-comp["w"] // 8)
    j = np.arange(ncol)
    cols = np.clip(j[:, None] + np.arange(-2, 3)[None, :], 0, ncol - 1)
    dc = blk[..., 0]
    # (rows, cols, 5, 5) neighbourhoods of DC values
    nb = dc[rows[:, None, :, None], cols[None, :, None, :]]
    out = blk.copy()
    work = out[:len(rows), :ncol]
    change_dc = all(b == -1 for b in bits[1:10])
    q00 = int(qt[0])
    for k, (pos, weights) in enumerate(zip(_SMOOTH_POS, _SMOOTH_W), 1):
        w = weights[0] if change_dc else weights[1]
        al = bits[k]
        if w is None or al == 0:
            continue
        num = q00 * np.einsum("rcij,ij->rc", nb, w)
        pred = _estimate(num, qt[pos], al)
        work[..., pos] = np.where(work[..., pos] == 0, pred, work[..., pos])
    if change_dc:
        work[..., 0] = _estimate(q00 * np.einsum("rcij,ij->rc", nb, _WDC),
                                 q00, 0)
    return out


def _read_scan(data, sos, pos, frame, qts, hts, restart, coef, offsets,
               latched) -> int:
    """Decode the scan whose SOS body is ``sos`` and whose data starts at
    ``pos`` into ``coef``; returns the position of the marker after it."""
    comps = frame["comps"]
    ns = sos[0]
    ss, se, ah, al = (sos[1 + 2 * ns], sos[2 + 2 * ns],
                      sos[3 + 2 * ns] >> 4, sos[3 + 2 * ns] & 15)
    prog = frame["progressive"]
    if prog and (se > 63 or ss > se or (ss == 0) != (se == 0)
                 or (ss and ns != 1) or al > 13):
        raise ValueError(f"JPEG: a bad progressive scan (Ss {ss}, Se {se}, "
                         f"Ah {ah}, Al {al}, {ns} components)")
    # the tables the scan reads: a progressive scan reads the DC table in
    # its first DC pass only and the AC table in AC passes only
    needs = ((0, not prog or (ss == 0 and not ah)), (1, not prog or ss > 0))
    slots = []
    for j in range(ns):
        cid, td_ta = sos[1 + 2 * j], sos[2 + 2 * j]
        i = next((k for k, c in enumerate(comps) if c["id"] == cid), None)
        if i is None:
            raise ValueError(f"JPEG: the scan names component {cid}, which "
                             "the frame does not have")
        tables = []
        for (cls, needed), th in zip(needs, (td_ta >> 4, td_ta & 15)):
            table = hts.get((cls, th)) or _STD_HUFF.get((cls, th))
            if not needed:
                tables.append(None)
                continue
            if table is None:
                raise ValueError(f"JPEG: no Huffman table {cls}/{th}")
            tables.append(_symbols(table) if prog and cls
                          else _lookup(table, ac=bool(cls)))
        bits = frame["bits"][i]
        if prog and (ah != (bits[ss] if bits[ss] >= 0 else 0)
                     or min(bits[ss:se + 1]) != max(bits[ss:se + 1])):
            raise ValueError(f"JPEG: a progressive scan refines component "
                             f"{cid}'s coefficients {ss}..{se} out of order")
        bits[ss:se + 1] = [al] * (se + 1 - ss)
        if i not in latched:
            if comps[i]["tq"] not in qts:
                raise ValueError(f"JPEG: no quantisation table "
                                 f"{comps[i]['tq']}")
            latched[i] = qts[comps[i]["tq"]]
        slots.append((i, tables[0], tables[1]))
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    blocks = []
    if ns == 1:  # non-interleaved: the component's own block raster
        i, dct, act = slots[0]
        c = comps[i]
        nbx, nby = -(-c["w"] // 8), -(-c["h_px"] // 8)
        for by in range(nby):
            row = offsets[i] + by * c["bw"] * 64
            blocks.extend((row + bx * 64, dct, act, 0) for bx in range(nbx))
    else:
        mcux = -(-frame["width"] // (8 * hmax))
        mcuy = -(-frame["height"] // (8 * vmax))
        mcu = []  # (component slot, block row, block column) in an MCU
        for s, (i, _, _) in enumerate(slots):
            c = comps[i]
            mcu.extend((s, v, hh) for v in range(c["v"])
                       for hh in range(c["h"]))
        for my in range(mcuy):
            for mx in range(mcux):
                for s, v, hh in mcu:
                    i, dct, act = slots[s]
                    c = comps[i]
                    base = offsets[i] + ((my * c["v"] + v) * c["bw"]
                                         + mx * c["h"] + hh) * 64
                    blocks.append((base, dct, act, s))
    per_interval = restart * (1 if ns == 1 else len(mcu))
    scan, seg_bits, end = _scan_bytes(data, pos)
    if prog:
        _decode_progressive(_windows(scan), seg_bits, blocks, per_interval,
                            coef, ss, se, ah, al)
    else:
        _decode_scan(_windows(scan), seg_bits, blocks, per_interval, coef)
    return end
