"""PNG codec on the standard library's zlib and numpy.

The dataset players decode frames with this module when the native loader
(rsvio_tpu.native) is not built. It reads what the supported datasets ship:
8- and 16-bit grayscale (EuRoC, TUM-VI, 4Seasons) and RGB(A) (TartanAir),
any of the five row filters, not interlaced. Any other PNG raises
ValueError naming the file. `write_png` is the matching grayscale encoder,
used to write synthetic datasets.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GRAY = 0
_CHANNELS = {0: 1, 2: 3, 6: 4}   # color type -> samples per pixel


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: CRC mismatch in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG has no IEND chunk")


def _unfilter_row(ftype: int, line: np.ndarray, prior: np.ndarray,
                  bpp: int, path: str) -> np.ndarray:
    """Undo one row's filter (PNG spec §9.2); uint8 arithmetic wraps."""
    if ftype == 0:
        return line
    if ftype == 1:    # Sub: running sum along each byte lane
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:    # Up
        return line + prior
    if ftype not in (3, 4):
        raise ValueError(f"{path}: unknown PNG filter type {ftype}")
    # Average and Paeth predict from the reconstructed left neighbour, so
    # they run sequentially along the row.
    r = line.tolist()
    p = prior.tolist()
    for i in range(len(r)):
        a = r[i - bpp] if i >= bpp else 0
        b = p[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = p[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        r[i] = (r[i] + pred) & 0xFF
    return np.asarray(r, np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to a uint8 or uint16 array: (H, W) for grayscale,
    (H, W, 3) or (H, W, 4) for RGB or RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (color type {color}, bit depth {depth}, "
            f"interlace {interlace}); only 8/16-bit grayscale, RGB or RGBA, "
            "non-interlaced images are read")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG image data has the wrong size")
    raw = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior,
                                       bpp, path)
    if depth == 16:
        out = out.view(">u2").astype(np.uint16)
    return out.reshape(height, width, channels) if channels > 1 \
        else out.reshape(height, width)


def _filter_rows(b: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Apply one filter type to every row of the byte image b (H, stride)."""
    bi = b.astype(np.int32)
    left = np.zeros_like(bi)
    left[:, bpp:] = bi[:, :-bpp]
    up = np.zeros_like(bi)
    up[1:] = bi[:-1]
    if ftype == 0:
        pred = 0
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = up
    elif ftype == 3:
        pred = (left + up) >> 1
    elif ftype == 4:
        upleft = np.zeros_like(bi)
        upleft[1:, bpp:] = bi[:-1, :-bpp]
        pa, pb = np.abs(up - upleft), np.abs(left - upleft)
        pc = np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"unknown PNG filter type {ftype}")
    return ((bi - pred) & 0xFF).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type: int = 2) -> None:
    """Encode an (H, W) uint8 or uint16 array as a grayscale PNG, every row
    with `filter_type` (0-4)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError("write_png takes a 2-D uint8 or uint16 array, got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape
    bpp = img.dtype.itemsize
    b = np.ascontiguousarray(img.astype(">u2") if bpp == 2 else img)
    b = b.view(np.uint8).reshape(height, width * bpp)
    rows = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8),
         _filter_rows(b, filter_type, bpp)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8 * bpp, _GRAY, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))
