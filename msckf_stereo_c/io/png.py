"""8-bit grayscale PNG codec on the standard library (``zlib`` + ``struct``).

The decoder is the fallback of ``euroc.ImageSource`` where the native
runtime (``native/``) is not built; the encoder writes synthetic EuRoC
sequences.  Only what EuRoC's camera images use is supported: bit depth 8,
colour type 0 (grayscale), no interlacing — anything else is refused.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _predictors(x: np.ndarray):
    """The five PNG row predictors (None, Sub, Up, Average, Paeth) of every
    pixel of the (H, W) int16 image ``x``, from its left, up and up-left
    neighbours (zero outside the image)."""
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    ul = np.zeros_like(x)
    ul[:, 1:] = up[:, :-1]
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    return np.zeros_like(x), left, up, (left + up) >> 1, paeth


def encode_gray8(img: np.ndarray, filters=4) -> bytes:
    """PNG bytes of a (H, W) uint8 image.  ``filters``: the PNG row filter
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), one for every row or a
    sequence of one per row.  Paeth on every row is what common writers
    choose for camera images, and the decoder's slowest case."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"need a (H, W) uint8 image, got {img.shape} {img.dtype}")
    H, W = img.shape
    ftypes = np.broadcast_to(np.asarray(filters, np.int64), (H,))
    if ftypes.size and not ((ftypes >= 0) & (ftypes <= 4)).all():
        raise ValueError(f"PNG row filters are 0..4, got {filters}")
    x = img.astype(np.int16)
    pred = np.choose(ftypes[:, None], _predictors(x))
    raw = np.zeros((H, W + 1), np.uint8)
    raw[:, 0] = ftypes
    raw[:, 1:] = (x - pred) & 0xFF
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_gray8(path: str, img: np.ndarray, filters=4) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray8(img, filters))


def _inflate(data: bytes):
    """(row filter types (H,), filtered rows (H, W)) of PNG bytes."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if (depth, ctype, interlace) != (8, 0, 0):
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace}); need 8-bit grayscale, non-interlaced"
        )
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, W + 1)
    if raw[:, 0].max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {raw[:, 0].max()}")
    return raw[:, 0], raw[:, 1:]


def _unfilter_rows(ftypes: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Images whose rows use only None, Sub or Up: one vector step per row."""
    N, H, W = filt.shape
    out = np.zeros((N, H + 1, W), np.uint8)  # row 0 = the zero row above the image
    for n in range(N):
        for r in range(H):
            cur = filt[n, r]
            if ftypes[n, r] == 1:  # Sub: running sum along the row
                cur = (np.cumsum(cur, dtype=np.int64) & 0xFF).astype(np.uint8)
            elif ftypes[n, r] == 2:  # Up
                cur = cur + out[n, r]
            out[n, r + 1] = cur
    return out[:, 1:]


def _unfilter_wavefront(ftypes: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Any mix of the five filters.  Average and Paeth chain every pixel to
    its left neighbour, but pixel (y, x) needs only (y, x-1), (y-1, x) and
    (y-1, x-1), so each anti-diagonal y + x = d, of all N images at once, is
    one vector step: H + W - 1 steps instead of N * H * W.  The images are
    skewed so that diagonal d is the contiguous slab ``o[d + 2]`` (pixel
    (y, x) at ``o[y + x + 2, y + 1]``); a neighbour outside the image reads
    a cell that is never written, so it is zero, as the format says."""
    N, H, W = filt.shape
    ys = np.arange(H)[:, None]
    diag = ys + np.arange(W)[None, :] + 2
    f = np.zeros((H + W + 1, H + 1, N), np.int16)
    f[diag, ys + 1] = filt.transpose(1, 2, 0)
    o = np.zeros_like(f)
    t = ftypes.T  # (H, N)
    sub, up, avg, paeth = (t == 1), (t == 2), (t == 3), (t == 4)
    for k in range(2, H + W + 1):
        r0, r1 = max(0, k - 1 - W) + 1, min(H, k - 1) + 1  # rows y + 1 on diagonal k - 2
        a, b, c = o[k - 1, r0:r1], o[k - 1, r0 - 1 : r1 - 1], o[k - 2, r0 - 1 : r1 - 1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pp = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        y = slice(r0 - 1, r1 - 1)
        pred = np.where(
            paeth[y], pp,
            np.where(avg[y], (a + b) >> 1, np.where(up[y], b, np.where(sub[y], a, 0))),
        )
        o[k, r0:r1] = (f[k, r0:r1] + pred) & 0xFF
    return o[diag, ys + 1].transpose(2, 0, 1).astype(np.uint8)


def _unfilter(ftypes: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """(N, H, W) uint8 images from their row filters (N, H) and filtered
    rows (N, H, W)."""
    if ftypes.max(initial=0) <= 2:
        return _unfilter_rows(ftypes, filt)
    return _unfilter_wavefront(ftypes, filt)


def decode_gray8(data: bytes) -> np.ndarray:
    """(H, W) uint8 image from PNG bytes (8-bit grayscale, non-interlaced)."""
    ftypes, filt = _inflate(data)
    return _unfilter(ftypes[None], filt[None])[0]


def read_gray8(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray8(f.read())


def read_gray8_batch(paths, group: int = 32) -> np.ndarray:
    """(N, H, W) uint8 images of same-sized PNG files.  Decoding ``group``
    images in one wavefront amortises its per-step cost."""
    out = []
    for i in range(0, len(paths), group):
        parts = []
        for path in paths[i : i + group]:
            with open(path, "rb") as f:
                parts.append(_inflate(f.read()))
        if len({p[1].shape for p in parts}) > 1:
            raise ValueError("read_gray8_batch needs images of one size")
        out.append(_unfilter(np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts])))
    return np.concatenate(out) if out else np.zeros((0, 0, 0), np.uint8)
