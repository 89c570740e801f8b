"""Build on first use and load with ctypes the port's native C++ helpers
(gomel_tpu_torch/native/).

Counterpart of ``gomel_tpu/io/_native.py``: ``NativeLib`` builds a shared
object from source on first use with g++ and configures its symbol
signatures; it returns None when the toolchain or the build fails, so callers
fall back to their pure-Python paths (with a one-time warning: the fallbacks
are correct but orders of magnitude slower). The sources ship inside the
package; the shared objects go to ``build/gomel_tpu_torch/native/`` beside
the package (as the CUDA kernels go to ``build/gomel_tpu_torch/``), never
next to the sources. Two helpers: the FLAC decoder (its ``NativeLib`` is in
io/flac.py) and the PNG scanline filter (here, for io/pngcodec.py).
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading

_logger = logging.getLogger("gomel_tpu_torch")
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_DIR, "native")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "gomel_tpu_torch",
                         "native")


class NativeLib:
    """Lazy build-and-load of one native helper."""

    def __init__(self, src_name: str, so_name: str, configure):
        self._src = os.path.join(_NATIVE_DIR, src_name)
        self._so = os.path.join(BUILD_DIR, so_name)
        self._configure = configure
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def _build(self) -> None:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                            self._src],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, self._so)   # a concurrent loader sees old or new
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def get(self):
        """Return the loaded ctypes library, building if needed, or None."""
        with self._lock:
            if self._lib is not None or self._tried:
                return self._lib
            self._tried = True
            try:
                if not os.path.exists(self._so) or (
                    os.path.exists(self._src)
                    and os.path.getmtime(self._src) > os.path.getmtime(self._so)
                ):
                    if not os.path.exists(self._src):
                        raise FileNotFoundError(self._src)
                    self._build()
                lib = ctypes.CDLL(self._so)
                self._configure(lib)
                self._lib = lib
            except Exception as e:
                _logger.warning(
                    "native helper %s unavailable (%s: %s); falling back to "
                    "the pure-Python implementation — correct but orders of "
                    "magnitude slower", os.path.basename(self._src),
                    type(e).__name__, e)
                self._lib = None
            return self._lib


def _configure_pngfilter(lib):
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long, ctypes.c_int,
    ]
    lib.png_filter_up.restype = None
    lib.png_filter_up.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_long, ctypes.c_long,
    ]


_pngfilter = NativeLib("pngfilter.cpp", "_pngfilter.so", _configure_pngfilter)


def get_lib():
    """PNG filter helper (pngcodec.py's fast path), or None."""
    return _pngfilter.get()
