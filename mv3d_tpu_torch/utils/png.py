"""PNG decoding and encoding without PIL.

The KITTI images are 8-bit PNGs. The JAX package reads and writes them
through PIL; the port needs only the standard library's ``zlib``, numpy
and a small host C helper:

  * :func:`decode_png` / :func:`read_png` read 8-bit, non-interlaced gray,
    gray + alpha, RGB and RGBA images (other bit depths, palettes and
    interlacing raise ``ValueError``, as do bad chunk CRCs and truncated
    data). The None, Sub and Up row filters are undone with numpy; Average
    and Paeth, where each byte depends on the one reconstructed just
    before it, by ``csrc/png_unfilter.c``, built with the host C compiler
    at first use into ``mv3d_tpu_torch/_build/`` and called through
    ctypes. A failed build raises: nothing switches to the numpy twin
    (:func:`unfilter_row_plain`), which exists for the tests.
  * :func:`encode_png` / :func:`write_png` write such images with a filter
    chosen per row: the smallest sum of absolute filtered bytes (the
    usual adaptive heuristic), one type for every row, or a type per row.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import threading
import zlib
from typing import Optional, Sequence, Union

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "png_unfilter.c")
BUILD_DIR = os.path.join(_PKG, "_build")
CFLAGS = ("-O2", "-shared", "-fPIC")
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}        # PNG colour type -> channels
_COLOR_TYPE = {v: k for k, v in CHANNELS.items()}
_BUILD_LOCK = threading.Lock()


def library_path() -> str:
    """Where the helper's library lives once built (named by the hash of
    the source and the flags, so an edited source rebuilds)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CFLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"png_unfilter_{digest.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build the helper if needed (raises if the compiler fails) and load
    it."""
    lib = library_path()
    with _BUILD_LOCK:
        if not os.path.exists(lib):
            cc = shutil.which("cc") or shutil.which("gcc")
            if cc is None:
                raise RuntimeError("no host C compiler (cc or gcc) to build "
                                   f"{SOURCE}")
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                out = subprocess.run([cc, *CFLAGS, "-o", tmp, SOURCE],
                                     capture_output=True, text=True,
                                     timeout=120)
                if out.returncode != 0:
                    raise RuntimeError(f"{cc} failed on {SOURCE} "
                                       f"({out.returncode}):\n{out.stderr}")
                os.replace(tmp, lib)    # atomic: concurrent builds agree
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    dll = ctypes.CDLL(lib)
    fn = dll.mv3d_png_unfilter_row
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_size_t, ctypes.c_size_t]
    fn.restype = ctypes.c_int
    return dll


def unfilter_row_kernel(ftype: int, cur: np.ndarray, prev: np.ndarray,
                        bpp: int) -> None:
    """Undo filter ``ftype`` (3 Average or 4 Paeth) on the contiguous uint8
    row ``cur`` in place, given the reconstructed row above, with the C
    helper."""
    if not (cur.dtype == prev.dtype == np.uint8 and cur.shape == prev.shape
            and cur.ndim == 1 and cur.flags.c_contiguous
            and prev.flags.c_contiguous and cur.flags.writeable):
        raise ValueError("rows must be equal contiguous 1-D uint8 arrays")
    if _library().mv3d_png_unfilter_row(ftype, cur.ctypes.data,
                                        prev.ctypes.data, cur.size, bpp):
        raise ValueError(f"filter type {ftype} is not Average or Paeth")


def unfilter_row_plain(ftype: int, cur: np.ndarray, prev: np.ndarray,
                       bpp: int) -> None:
    """Numpy twin of :func:`unfilter_row_kernel`: the same recurrence one
    pixel at a time (slow; for the tests)."""
    out = cur.reshape(-1, bpp)
    up = prev.reshape(-1, bpp).astype(np.int32)
    left = np.zeros(bpp, np.int32)
    upleft = np.zeros(bpp, np.int32)
    for x in range(out.shape[0]):
        b = up[x]
        if ftype == 3:
            pred = (left + b) >> 1
        elif ftype == 4:
            p = left + b - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - b), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, b, upleft))
        else:
            raise ValueError(f"filter type {ftype} is not Average or Paeth")
        out[x] = (out[x].astype(np.int32) + pred) & 255
        left, upleft = out[x].astype(np.int32), b


def unfilter(rows: np.ndarray, filters: np.ndarray, bpp: int,
             row_fn=unfilter_row_kernel) -> np.ndarray:
    """Reconstruct (H, stride) filtered uint8 rows in place, top to bottom:
    None, Sub and Up with numpy, Average and Paeth with ``row_fn``."""
    prev = np.zeros(rows.shape[1], np.uint8)
    for y in range(rows.shape[0]):
        cur, f = rows[y], int(filters[y])
        if f == 1:
            px = cur.reshape(-1, bpp)
            np.cumsum(px, axis=0, dtype=np.uint8, out=px)
        elif f == 2:
            np.add(cur, prev, out=cur)           # uint8: wraps mod 256
        elif f in (3, 4):
            row_fn(f, cur, prev, bpp)
        elif f != 0:
            raise ValueError(f"PNG row {y}: unknown filter type {f}")
        prev = cur
    return rows


def decode_png(data: bytes, row_fn=unfilter_row_kernel) -> np.ndarray:
    """PNG bytes -> (H, W) uint8 for gray, else (H, W, C)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + length > len(data):
            raise ValueError(f"truncated PNG chunk {kind!r}")
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace} (8-bit, "
                         f"non-interlaced gray/gray+alpha/RGB/RGBA only)")
    ch = CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    stride = width * ch
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, not "
                         f"{height * (stride + 1)}")
    buf = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    rows = np.ascontiguousarray(buf[:, 1:])
    unfilter(rows, buf[:, 0], ch, row_fn)
    img = rows.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(H, stride) uint8 -> (5, H, stride) uint8: each row under each filter
    type 0-4 (filtering reads only the unfiltered image, so every row and
    type is computed at once)."""
    x = rows.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    preds = (0, left, up, (left + up) >> 1, _paeth(left, up, upleft))
    return np.stack([(x - p) & 255 for p in preds]).astype(np.uint8)


def encode_png(img: np.ndarray,
               filters: Union[None, int, Sequence[int]] = None) -> bytes:
    """(H, W) or (H, W, C) uint8 (C = 1, 2, 3 or 4) -> PNG bytes. Row
    filters: ``None`` picks per row the type with the smallest sum of
    absolute filtered bytes (as signed bytes); an int uses that type for
    every row; a sequence gives each row's type."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG encoder takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _COLOR_TYPE:
        raise ValueError(f"{ch} channels: the encoder writes 1-4")
    rows = np.ascontiguousarray(img).reshape(h, w * ch)
    cand = filter_rows(rows, ch)
    if filters is None:
        cost = np.abs(cand.view(np.int8).astype(np.int64)).sum(-1)
        types = cost.argmin(0)
    else:
        types = np.broadcast_to(np.asarray(filters, np.int64), (h,))
        if ((types < 0) | (types > 4)).any():
            raise ValueError("PNG filter types are 0-4")
    out = np.empty((h, w * ch + 1), np.uint8)
    out[:, 0] = types
    out[:, 1:] = cand[types, np.arange(h)]

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(out.tobytes()))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray,
              filters: Union[None, int, Sequence[int]] = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))


def row_filters(data: bytes) -> Optional[np.ndarray]:
    """The filter type of every row of an 8-bit non-interlaced PNG (to
    check which filters an encoder used)."""
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data[pos + 8:pos + 21])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + length])
        pos += 12 + length
    if header is None:
        return None
    width, height, _, color, _, _, _ = header
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw.reshape(height, width * CHANNELS[color] + 1)[:, 0].copy()
