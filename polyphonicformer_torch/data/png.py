"""PNG decode and encode without cv2 or PIL: ``zlib`` from the standard
library for the compressed stream, the port's native library
(``ops/native.py::png_unfilter``) for the scanline filters.

``read_png`` decodes non-interlaced PNGs of colour types 0 (grey), 2 (RGB),
3 (palette, expanded to RGB through PLTE) and 6 (RGBA) at bit depths 8 and
16 (big-endian samples become native ``uint16``), and grey and palette
images at 1, 2 and 4 bits.  Anything else (Adam7 interlacing, grey with
alpha, a ``tRNS`` chunk, an unknown critical chunk) raises
``NotImplementedError``; a damaged file (bad signature, CRC or length)
raises ``ValueError``.  It never guesses.

``imread_rgb`` and ``imread_unchanged`` keep the semantics of
``cv2.imread`` that the JAX package's ``data/cityscapes_dvps.py`` relies
on: ``imread_rgb`` is ``cv2.cvtColor(cv2.imread(p, IMREAD_COLOR),
BGR2RGB)`` (RGB ``uint8``; 16-bit samples keep their high byte, grey is
replicated, alpha dropped), ``imread_unchanged`` is ``cv2.imread(p,
IMREAD_UNCHANGED)`` for the single-channel images Cityscapes-DVPS stores
(its panoptic and depth PNGs).  For colour images ``imread_unchanged``
returns the channels as stored (RGB, RGBA), where cv2 would return BGR.
Sub-byte grey is scaled to 0-255, as cv2 (libpng's
``png_set_expand_gray_1_2_4_to_8``) does.

``write_png`` writes one filter type on every row (0 by default) and a
zlib stream, enough for the demo's outputs and for writing a test split.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..ops import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 6: (8, 16)}


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked, through IEND."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG truncated before IEND")
        length, = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG chunk {ctype!r} truncated")
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(payload, zlib.crc32(ctype)) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def decode_png(data: bytes) -> np.ndarray:
    """The image in ``data``: (H, W) for grey, (H, W, 3) for RGB and
    palette, (H, W, 4) for RGBA; ``uint8`` or ``uint16``."""
    header = palette = None
    idat = []
    for ctype, payload in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"tRNS":
            raise NotImplementedError("PNG with a tRNS (transparency) chunk")
        elif ctype[0] & 0x20 == 0 and ctype != b"IEND":  # an unknown critical chunk
            raise NotImplementedError(f"PNG critical chunk {ctype!r}")
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, compression, filter_method, interlace = header
    if compression != 0 or filter_method != 0:
        raise ValueError(f"PNG compression {compression} / filter method {filter_method}")
    if interlace != 0:
        raise NotImplementedError("interlaced (Adam7) PNG")
    if color not in _CHANNELS or depth not in _DEPTHS[color]:
        raise NotImplementedError(f"PNG colour type {color} at bit depth {depth}")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    channels = _CHANNELS[color]
    bits = channels * depth
    row_bytes = (width * bits + 7) // 8
    want = height * (row_bytes + 1)
    try:
        raw = zlib.decompress(b"".join(idat), bufsize=max(want, 1))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    if len(raw) != want:
        raise ValueError(f"PNG image data: {len(raw)} bytes, expected {want}")
    rows = native.png_unfilter(np.frombuffer(raw, np.uint8), height, row_bytes,
                               max(1, bits // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        img = rows
    else:
        img = np.unpackbits(rows, axis=1, count=width * depth)
        if depth > 1:
            img = img.reshape(height, width, depth)
            img = np.packbits(img, axis=2, bitorder="big")[..., 0] >> (8 - depth)
    img = img.reshape(height, width, channels) if channels > 1 else img.reshape(height, width)
    if color == 3:
        if int(img.max(initial=0)) >= len(palette):
            raise ValueError("PNG palette index beyond PLTE")
        return palette[img]
    if depth < 8:  # grey: scale to 0-255 as libpng's expand does
        img = img * np.uint8(255 // ((1 << depth) - 1))
    return img


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def imread_unchanged(path) -> np.ndarray:
    return read_png(path)


def imread_rgb(path) -> np.ndarray:
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def filter_rows(rows: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """(H, row_bytes) uint8 scanlines -> (H, 1 + row_bytes) with each row
    filtered by ``filter_type`` (0-4) and led by its type byte."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    if filter_type == 0:
        pred = np.zeros_like(x)
    elif filter_type == 1:
        pred = a
    elif filter_type == 2:
        pred = b
    elif filter_type == 3:
        pred = (a + b) >> 1
    elif filter_type == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"filter type {filter_type} not in 0..4")
    out = np.empty((rows.shape[0], rows.shape[1] + 1), np.uint8)
    out[:, 0] = filter_type
    out[:, 1:] = (x - pred).astype(np.uint8)
    return out


def encode_png(array: np.ndarray, level: int = 1, filter_type: int = 0) -> bytes:
    """(H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA, ``uint8`` or
    ``uint16``, as PNG bytes."""
    array = np.asarray(array)
    if array.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"write_png: dtype {array.dtype}, expected uint8 or uint16")
    if array.ndim == 2:
        color = 0
    elif array.ndim == 3 and array.shape[2] in (3, 4):
        color = 2 if array.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png: shape {array.shape}")
    h, w = array.shape[:2]
    depth = 8 * array.dtype.itemsize
    samples = array.astype(">u2") if depth == 16 else array
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(h, -1)
    bpp = _CHANNELS[color] * depth // 8
    body = filter_rows(rows, bpp, filter_type) if filter_type else \
        np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + ctype + payload
                + struct.pack(">I", zlib.crc32(payload, zlib.crc32(ctype))))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(body.tobytes(), level)) + chunk(b"IEND", b""))


def write_png(path, array: np.ndarray, level: int = 1, filter_type: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(array, level, filter_type))


def unfilter_plain(raw: np.ndarray, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The plain version of ``native.png_unfilter``: numpy for None, Sub and
    Up, a loop over the bytes for Average and Paeth.  For the tests."""
    src = np.asarray(raw, np.uint8).reshape(rows, row_bytes + 1)
    out = np.zeros((rows, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for r in range(rows):
        ft, line = int(src[r, 0]), src[r, 1:]
        if ft == 0:
            out[r] = line
        elif ft == 1:
            pad = (-row_bytes) % bpp
            cols = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            out[r] = np.add.accumulate(cols, axis=0, dtype=np.uint8).reshape(-1)[:row_bytes]
        elif ft == 2:
            out[r] = line + prev
        elif ft in (3, 4):
            cur = out[r]
            for i in range(row_bytes):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(prev[i - bpp]) if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {r}: unknown filter type {ft}")
        prev = out[r]
    return out
