"""Compatibility layer: drop-in module surfaces of the reference APIs.

Counterpart of ``gomel_tpu/compat/``. ``gomel_tpu_torch.compat.phase``
mirrors the reference Python port's module (the PyPI ``phase-spectrogram``
package, installed as the top-level module ``phase``), so its users switch
imports without code changes while the compute runs on the port's CUDA
kernels. For code that does ``import phase`` / ``from phase import Phase``
verbatim, call :func:`install` once at startup. Imports neither JAX nor
gomel_tpu.
"""
import sys

from . import phase
from . import pypng


def install(register_pypng: bool = True) -> None:
    """Register the compat modules under the names the reference ecosystem
    imports: ``phase`` (the PyPI port's top-level module) and, optionally,
    ``png`` (pypng, used by the port's HDR path)."""
    sys.modules.setdefault("phase", phase)
    if register_pypng:
        sys.modules.setdefault("png", pypng)


__all__ = ["phase", "pypng", "install"]
