"""PNG decode and encode on numpy and the standard library's ``zlib``.

The counterpart of the JAX package's native decoder
(``medt_tpu/data/native.py`` over ``native/medt_io.cpp``, libpng) and of its
cv2/PIL fallbacks, with none of those libraries: the card's machine has no
PIL and may have no libpng. The result is what ``medt_io.cpp`` gives:

* colour reads are BGR (cv2's channel order), gray reads single-channel;
* 16-bit samples keep their high byte (``png_set_strip_16``);
* 1, 2 and 4-bit gray expand to 8 bits (``png_set_expand_gray_1_2_4_to_8``);
  palette images expand through ``PLTE``; alpha, from ``tRNS`` or a
  channel, is dropped (``png_set_strip_alpha``);
* colour read as gray takes libpng's fixed-point ``rgb_to_gray`` with the
  weights 29900/58700 (``png_set_rgb_to_gray_fixed``, ``medt_io.cpp:67``):
  coefficients ``r, g, b = 9797, 19234, 13737`` over 2^15, truncated on 8-bit
  samples and rounded on 16-bit ones before the high byte is kept. A file
  without a ``gAMA`` chunk takes exactly this path in libpng; gamma
  correction is not applied.

Interlaced (Adam7) files raise ``ValueError``. The encoder writes 8-bit
gray or RGB images with filter 0 (the CLIs' 0/255 masks, synthetic sets).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels per colour type: gray, RGB, palette, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# png_set_rgb_to_gray_fixed(png, 1, 29900, 58700): red and green truncated
# to 1/32768 units, blue takes the rest
_RC = 29900 * 32768 // 100000
_GC = 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG file ends before IEND")


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (none, sub, up, average, paeth)."""
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data too short")
    rows = np.frombuffer(raw, np.uint8, count=h * (stride + 1)) \
        .reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:                       # sub: running sums per byte lane
            cur = np.empty(stride, np.uint8)
            for k in range(min(bpp, stride)):
                cur[k::bpp] = np.cumsum(line[k::bpp], dtype=np.uint64) \
                    .astype(np.uint8)
        elif kind == 2:                       # up
            cur = line + prior
        elif kind in (3, 4):                  # average, paeth: sequential
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            if kind == 3:
                for x in range(stride):
                    left = cur[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
            else:
                for x in range(stride):
                    if x >= bpp:
                        a, c = cur[x - bpp], up[x - bpp]
                    else:
                        a = c = 0
                    b = up[x]
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                    cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, stride) bytes -> (h, w, ch) samples (uint16 for 16-bit)."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    if depth == 16:
        pairs = rows[:, :w * ch * 2].reshape(h, w, ch, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth]
    bits = bits.reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8).reshape(h, w, ch)


def _rgb_to_gray(rgb: np.ndarray, depth: int) -> np.ndarray:
    """libpng's fixed-point rgb_to_gray, then the high byte for 16-bit."""
    x = rgb.astype(np.uint32)
    dot = _RC * x[..., 0] + _GC * x[..., 1] + _BC * x[..., 2]
    if depth == 16:
        return (((dot + 16384) >> 15) >> 8).astype(np.uint8)
    return (dot >> 15).astype(np.uint8)


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 for ``gray``, else (H, W, 3) uint8 BGR."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced (Adam7) PNG files are not supported")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG colour type {ctype} / depth "
                         f"{depth}")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    px = _samples(rows, w, ch, depth)

    if ctype == 3:                                    # palette -> RGB
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        rgb, depth = palette[px[..., 0]], 8
    elif ctype in (2, 6):
        rgb = px[..., :3]
    else:                                             # gray, gray + alpha
        g = px[..., 0]
        if depth == 16:
            g = g >> 8
        elif depth < 8:
            g = g * (255 // ((1 << depth) - 1))
        g = g.astype(np.uint8)
        return g if gray else np.repeat(g[..., None], 3, axis=-1)
    if gray:
        return _rgb_to_gray(rgb, depth)
    if depth == 16:
        rgb = (rgb >> 8).astype(np.uint8)
    return np.ascontiguousarray(rgb[..., ::-1].astype(np.uint8))


def read_png(path: str, gray: bool = False) -> np.ndarray:
    """Decode a PNG file: (H, W) gray or (H, W, 3) BGR, uint8."""
    with open(path, "rb") as f:
        return decode_png(f.read(), gray)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8, got {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    ctype = {1: 0, 3: 2}.get(image.shape[-1]) if image.ndim == 3 else None
    if ctype is None:
        raise ValueError(f"encode_png takes (H, W[, 1|3]), got {image.shape}")
    h, w, ch = image.shape
    raw = np.zeros((h, w * ch + 1), np.uint8)        # filter 0 on every row
    raw[:, 1:] = image.reshape(h, w * ch)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))


def write_mask_png(path: str, mask01: np.ndarray) -> None:
    """A {0, 1} mask as an 8-bit gray PNG of 0/255 (the CLIs' mask files,
    ``trainer._write_mask_png`` in JAX)."""
    write_png(path, (np.asarray(mask01).astype(np.uint8) * 255))
