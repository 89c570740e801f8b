"""PNG files whose rows carry a chosen scanline filter type.

The port's writer (gomel_tpu_torch/io/pngcodec.write_png) filters every row
but the first with Up, as the JAX package's does; files from other encoders
(PIL, libpng) use Sub, Average and Paeth too. ``png_bytes`` writes such
files without PIL: each row is filtered with the type given for it, in
numpy (the forward filters read only unfiltered neighbours, so each is one
vector expression a row). ``chip_smoke.py`` phase 3i and
``tests/test_torch_host.py`` read them back through the native unfilter and
the numpy path of ``read_png`` (``numpy_path``; ``tools/profile_png.py``
times the two).

    from tools.png_filters import png_bytes
    data = png_bytes(image, [1, 4])   # rows alternate Sub and Paeth
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from gomel_tpu_torch.io import pngcodec

_CTYPE = {1: 0, 2: 4, 3: 2, 4: 6}     # channels -> PNG color type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def filter_row(cur: np.ndarray, up: np.ndarray | None, bpp: int,
               ftype: int) -> np.ndarray:
    """One scanline's filtered bytes (without the type byte): ``cur`` and
    ``up`` (the row above, None on the first row) are uint8 rows."""
    x = cur.astype(np.int32)
    b = np.zeros_like(x) if up is None else up.astype(np.int32)
    a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int32), b[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(x)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = b
    elif ftype == 3:
        pred = (a + b) >> 1
    elif ftype == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"filter type {ftype} is not 0-4")
    return ((x - pred) & 0xFF).astype(np.uint8)


def png_bytes(image: np.ndarray, filters) -> bytes:
    """A PNG of ``image`` (uint8 or uint16, [H, W] or [H, W, C] with C in
    1-4: gray, gray + alpha, RGB, RGBA) whose row y carries filter type
    ``filters[y % len(filters)]``."""
    image = np.ascontiguousarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"unsupported dtype {image.dtype}")
    depth = 16 if image.dtype == np.uint16 else 8
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, ch = image.shape
    body = image.astype(">u2").tobytes() if depth == 16 else image.tobytes()
    rows = np.frombuffer(body, dtype=np.uint8).reshape(h, -1)
    bpp = ch * depth // 8
    raw = np.empty((h, rows.shape[1] + 1), dtype=np.uint8)
    for y in range(h):
        ftype = int(filters[y % len(filters)])
        raw[y, 0] = ftype
        raw[y, 1:] = filter_row(rows[y], rows[y - 1] if y else None, bpp,
                                ftype)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _CTYPE[ch], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _chunk(b"IEND", b""))


def numpy_path(fn):
    """``fn`` as a callable that runs it with the native helper hidden from
    io/pngcodec: its numpy path, as where the helper cannot build."""
    def run():
        saved = pngcodec.get_lib
        pngcodec.get_lib = lambda: None
        try:
            return fn()
        finally:
            pngcodec.get_lib = saved
    return run
