"""Minimal pypng-compatible shim backed by the port's own PNG codec.

Counterpart of ``gomel_tpu/compat/pypng.py``. The reference Python port's
HDR path depends on the ``png`` (pypng) package (phase.py:716-737,
769-782). This module implements the subset that port uses,
``png.Writer(width, height, bitdepth, greyscale, alpha).write(file, rows)``
and ``png.Reader(filename=|file=|bytes=).read()``, on io/pngcodec.py, so
code written against pypng keeps working without it
(``gomel_tpu_torch.compat.install()`` registers it as ``png``).
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from ..io.pngcodec import read_png, write_png


class Writer:
    def __init__(self, width: int, height: int, bitdepth: int = 8,
                 greyscale: bool = False, alpha: bool = False, **_ignored):
        if bitdepth not in (8, 16):
            raise ValueError("shim supports bitdepth 8/16 only")
        self.width = width
        self.height = height
        self.bitdepth = bitdepth
        self.channels = (1 if greyscale else 3) + (1 if alpha else 0)

    def write(self, file, rows: Iterable) -> None:
        dtype = np.uint16 if self.bitdepth == 16 else np.uint8
        arr = np.asarray([list(r) for r in rows], dtype=dtype)
        expected = self.width * self.channels
        if arr.ndim != 2 or arr.shape != (self.height, expected):
            raise ValueError(
                f"rows shape {arr.shape} != ({self.height}, {expected})")
        img = arr.reshape(self.height, self.width, self.channels)
        if self.channels == 1:
            img = img[:, :, 0]
        elif self.channels == 2:  # gray+alpha: expand to RGBA for our writer
            g, a = img[:, :, 0], img[:, :, 1]
            img = np.stack([g, g, g, a], axis=-1)
        write_png(file, img)


class Reader:
    def __init__(self, filename: Optional[str] = None, file=None,
                 bytes: Optional[object] = None):
        self._filename = filename
        self._file = file
        self._bytes = bytes

    def read(self):
        if self._filename is not None:
            img = read_png(self._filename)
        else:
            import tempfile
            data = self._bytes if self._bytes is not None \
                else self._file.read()
            with tempfile.NamedTemporaryFile(suffix=".png") as t:
                t.write(data)
                t.flush()
                img = read_png(t.name)
        if img.ndim == 2:
            img = img[:, :, None]
        h, w, ch = img.shape
        info = {
            "greyscale": ch <= 2,
            "alpha": ch in (2, 4),
            "bitdepth": 16 if img.dtype == np.uint16 else 8,
            "size": (w, h),
            "planes": ch,
        }
        rows = (img[y].reshape(-1) for y in range(h))
        return w, h, rows, info
