"""A small PNG codec on the standard library's ``zlib`` and numpy.

The port decodes ``.png`` images with this module, so the list-format
datasets (and the synthetic fixtures, which are written as PNG) load on a
machine without cv2 or PIL. PNG is lossless, so the decoded pixels are
exactly what ``cv2.imread`` returns.

Scope: 8-bit gray, RGB and RGBA images, non-interlaced, all five row
filters. A valid PNG of any other kind raises ``UnsupportedPNG`` (a
``ValueError``) naming what it found; a damaged one raises ``ValueError``.
The writer emits 8-bit gray / RGB / RGBA with one row filter on every row
(0, no prediction, by default).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (8-bit gray, RGB, RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


class UnsupportedPNG(ValueError):
    """A valid PNG of a kind this codec does not decode (bit depth,
    colour type, interlace); callers may hand it to another decoder."""


def _predict(a: np.ndarray, b: np.ndarray, c: np.ndarray,
             ftype: np.ndarray) -> np.ndarray:
    """The PNG predictor of each row filter from the left (a), up (b) and
    up-left (c) bytes, int16 so Paeth's sums cannot overflow; ``ftype``
    broadcasts against them."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where(ftype == 4, np.where((pa <= pb) & (pa <= pc), a,
                                         np.where(pb <= pc, b, c)),
                    (a + b) >> 1)
    pred = np.where(ftype == 2, b, pred)
    pred = np.where(ftype == 1, a, pred)
    return np.where(ftype == 0, 0, pred)


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) filtered scanlines -> (H, stride) uint8 bytes.

    A byte depends on its left, up and up-left neighbours once they are
    decoded, so the pixels of one anti-diagonal (y + x constant) are
    independent: the decode runs one numpy step per anti-diagonal (H + W - 1
    steps) whatever mix of row filters the encoder chose."""
    ftypes = rows[:, 0]
    lines = rows[:, 1:]
    bad = set(np.unique(ftypes).tolist()) - {0, 1, 2, 3, 4}
    if bad:
        raise ValueError(f"PNG row filter types {sorted(bad)} do not exist")
    if not ftypes.any():
        return lines
    h, w = lines.shape[0], lines.shape[1] // bpp
    x_in = lines.reshape(h, w, bpp).astype(np.int16)
    # decoded pixel (y, x) at out[y + 1, x + 1]; row 0 and column 0 are the
    # zero bytes PNG puts before the image
    out = np.zeros((h + 1, w + 1, bpp), np.int16)
    ft = ftypes.astype(np.int16)[:, None]
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - y
        pred = _predict(out[y + 1, x], out[y, x + 1], out[y, x], ft[y])
        out[y + 1, x + 1] = (x_in[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> (H, W) uint8 for gray, (H, W, 3) RGB or (H, W, 4)
    RGBA. ``name`` only labels the errors."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if len(body) != length or crc_at + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {ctype!r}")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: CRC mismatch in PNG chunk {ctype!r}")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos = crc_at + 4
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS:
        raise UnsupportedPNG(f"{name}: PNG bit depth {depth}, colour type "
                             f"{color}; only 8-bit gray, RGB and RGBA "
                             "decode")
    if interlace:
        raise UnsupportedPNG(f"{name}: interlaced PNG is not supported")
    ch = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * ch):
        raise ValueError(f"{name}: PNG data holds {raw.size} bytes, "
                         f"expected {h * (1 + w * ch)}")
    img = _unfilter(raw.reshape(h, 1 + w * ch), ch).reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def encode_png(img: np.ndarray, filter_type: int = 0) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 -> PNG bytes,
    ``filter_type`` (0-4) on every row. zlib level 1: the fixtures' noisy
    images gain little from more effort, and writing them is set-up
    time."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writer takes uint8, got {img.dtype}")
    ch = img.shape[2] if img.ndim == 3 else 1
    if img.ndim not in (2, 3) or ch not in _COLOR_TYPE:
        raise ValueError(f"PNG writer takes (H, W[, 1|3|4]) images, got "
                         f"{img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG row filter {filter_type} does not exist")
    h, w = img.shape[:2]
    # the encoder predicts from the source bytes, so every row filters at
    # once
    px = np.zeros((h + 1, w + 1, ch), np.int16)
    px[1:, 1:] = img.reshape(h, w, ch)
    pred = _predict(px[1:, :-1], px[:-1, 1:], px[:-1, :-1],
                    np.int16(filter_type))
    rows = np.full((h, 1 + w * ch), filter_type, np.uint8)
    rows[:, 1:] = ((px[1:, 1:] - pred) & 0xFF).reshape(h, w * ch)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    return (SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _COLOR_TYPE[ch], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
