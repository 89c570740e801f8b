"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

At first use one ``nvcc`` per source, all started together, compiles each for
``sm_90a``, and one more links the objects into one shared library with a
plain C interface, ``build/gomel_tpu_torch/libgomel_kernels.so`` beside the
package. A stamp file holds the hash of the sources the library was built
from; a changed source rebuilds it. Several processes may load the kernels
at once (the multi-process meshes): the build runs under an exclusive
``flock`` on ``build.lock`` in the build directory, a process that waited
for it finds the stamp current and builds nothing, and the library and the
stamp each land by an atomic rename. ``ctypes`` loads the library, and
:func:`launch` calls an entry point on PyTorch's current stream and raises
if the launch failed.

Nothing here runs at import: this module is imported on machines with no
CUDA toolkit, where only the kernels' plain PyTorch versions run.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "gomel_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libgomel_kernels.so")
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]
LINK_FLAGS = [*_ARCH, "-shared"]

_P, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_float)
# every entry point ends with (device index, stream) and returns a cudaError_t
_SIGNATURES = {
    "gomel_pcm16_ingest": [_P, _P, _I64, _I64, _I64, _I32, _F32, _P, _I32,
                           _I32],
    "gomel_stft_mag": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                       _I64, _I32, _I32],
    "gomel_stft_planes": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                          _I32, _I32, _I64, _I32, _I32],
    "gomel_stft_mel_log": [_P, _P, _P, _P, _P, _P, _I32, _P, _I64, _I64,
                           _I64, _I64, _I64, _I64, _I32, _I32, _I32],
    "gomel_stft_mel_log_pcm16": [_P, _F32, _P, _I64, _P, _P, _P, _P, _P,
                                 _I32, _P, _I64, _I64, _I64, _I64, _I64,
                                 _I32, _I32, _I32],
    "gomel_mel_log": [_P, _P, _P, _I32, _I64, _P, _I64, _I64, _I64],
    "gomel_quantize_mel": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                           _I32, _F32],
    "gomel_quantize_mel_parts": [_I64, _I64, _I64, _P],
    "gomel_quantize_planes": [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                              _I32, _F32, _I32],
    "gomel_quantize_planes_parts": [_I64, _I64, _I64, _P],
    "gomel_irfft_window": [_I32, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                           _I64, _I64, _F32, _I32, _I64, _I32, _I32],
    "gomel_overlap_normalize": [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                _I32, _F32, _F32],
    "gomel_mel_to_mag": [_I32, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                         _I64, _I64, _F32, _F32, _F32, _F32],
    "gomel_gl_project": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                         _I64, _I32, _I32],
    "gomel_gl_overlap_add": [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                             _F32],
    "gomel_dequantize_raw": [_P, _P, _P, _P, _I64, _I32, _I32, _F32, _I32,
                             _F32],
    "gomel_shard_epilogue": [_P, _I64, _P, _I64, _I64, _P, _I64, _I64, _I64,
                             _I64, _I32, _F32, _F32, _P, _F32, _P, _I64, _P,
                             _P, _P, _I64, _I64],
    "gomel_dft_weight_map": [_P, _P, _I32, _I64, _I64],
    "gomel_dft_fwd": [_I32, _P, _P, _P, _P, _P, _P, _I32, _I64, _I64, _I64,
                      _I64, _I64, _I64, _I64, _I64, _I32, _I32, _I32],
    "gomel_dft_inv": [_I32, _I32, _P, _P, _I64, _P, _P, _I64, _I64, _I64,
                      _I64, _I64, _I64],
    "gomel_threefry_uniform": [_P, _P, _I64, _I64],
}


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, how often
    its wrapper launched it (a plain count a run can reset and read), and
    the name of the wrapper's span (utils/profiling.annotate), one a
    launch."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source        # path in the repository
        self.replaces = replaces    # file:line of the TPU kernel
        self.launches = 0
        self.span = "gomel.op." + name


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def sources_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                           "kernels can only be built where the CUDA toolkit "
                           "is installed")
    return path


def _current(digest: str) -> bool:
    """Whether the library exists and its stamp holds ``digest``."""
    stamp = LIB_PATH + ".sha256"
    if not (os.path.exists(LIB_PATH) and os.path.exists(stamp)):
        return False
    with open(stamp) as f:
        return f.read().strip() == digest


def build() -> float:
    """Compile the kernels unless the stamp matches the sources; returns the
    seconds spent compiling (0.0 when the library was current, also when
    another process built it while this one waited for the lock). The
    compiler's report (registers, shared memory, spills) goes to
    ``build.log``."""
    digest = sources_hash()
    if _current(digest):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if _current(digest):
            return 0.0
        return _compile(digest)


def _compile(digest: str) -> float:
    """One build of the library (under the lock); returns its seconds."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        jobs = []
        try:
            for src in (s for s in _sources() if s.endswith(".cu")):
                stem = os.path.join(work, os.path.basename(src)[:-3])
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", stem + ".o", src]
                with open(stem + ".log", "w") as out:
                    jobs.append((cmd, stem, subprocess.Popen(
                        cmd, stdout=out, stderr=subprocess.STDOUT)))
        finally:
            for _, _, proc in jobs:   # every compiler started has ended
                proc.wait()
        report, failed = [], []
        for cmd, stem, proc in jobs:
            with open(stem + ".log") as f:
                report.append(" ".join(cmd) + "\n" + f.read())
            if proc.returncode != 0:
                failed.append(report[-1])
        tmp = os.path.join(work, "lib.so")
        if not failed:
            cmd = [nvcc, *LINK_FLAGS, "-o", tmp,
                   *(stem + ".o" for _, stem, _ in jobs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            report.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(report[-1])
        with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
            f.write("\n".join(report))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        os.replace(tmp, LIB_PATH)   # atomic: a concurrent loader sees old or new
    stamp = LIB_PATH + ".sha256"
    with open(stamp + f".tmp{os.getpid()}", "w") as f:
        f.write(digest)
    os.replace(stamp + f".tmp{os.getpid()}", stamp)
    return time.perf_counter() - t0


_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [*args, _I32, _P]
                fn.restype = _I32
            lib.gomel_error_string.argtypes = [_I32]
            lib.gomel_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(symbol: str, device: torch.device, *args) -> None:
    """Call entry point ``symbol`` on ``device``'s current stream; raise if
    the launch failed."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, symbol)(*args, device.index, stream)
    if rc != 0:
        msg = lib.gomel_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {symbol} failed: {msg} ({rc})")


def require_device(device, what: str,
                   hint: str = 'pass device="cpu"') -> torch.device:
    """``device`` as a ``torch.device``; raise when it names CUDA and none is
    available, so an entry point never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what}: device {str(dev)!r} is not available "
            f"(torch.cuda.is_available() is False); {hint} to run on the CPU")
    return dev


def check_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Require every tensor to be contiguous and on one CUDA device; return
    that device. Wrappers call this for any tensor not on the CPU, so a
    non-CUDA device raises here instead of reaching a plain fallback."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
    return dev
