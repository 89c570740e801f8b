"""The ctypes signatures of the CUDA entry points against their C declarations.

``ops/_cuda._SIGNATURES`` lists each ``GOMEL_API`` function's parameters but
the trailing (device, stream), which ``_cuda.launch`` adds. A list that drifts
from the C declaration passes garbage on the card and shows nowhere else, so
this file parses every ``GOMEL_API`` declaration in ``gomel_tpu_torch/csrc/*.cu``
and holds the number and the kind of each parameter (pointer, 32-bit int,
64-bit int, float) to the list. No CUDA and no JAX.
"""
import ctypes
import os
import re

import pytest

from gomel_tpu_torch.ops import _cuda

_DECL = re.compile(r"GOMEL_API\s+([\w\s\*]+?)\b(gomel_\w+)\s*\(([^)]*)\)",
                   re.S)
_KINDS = {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
          "long long": ctypes.c_longlong, "float": ctypes.c_float}


def _kind(param: str) -> str:
    """The kind of one C parameter declaration."""
    text = " ".join(param.replace("const", " ").split())
    if "*" in text:
        return "pointer"
    base = text.rsplit(" ", 1)[0]            # drop the parameter's name
    if base not in _KINDS:
        raise ValueError(f"unexpected parameter type: {param!r}")
    return base


def _declarations() -> dict[str, tuple[str, list[str]]]:
    """symbol -> (return type, parameter kinds) of every GOMEL_API function."""
    out = {}
    for name in sorted(os.listdir(_cuda.CSRC_DIR)):
        if not name.endswith(".cu"):
            continue
        with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
            text = f.read()
        for ret, symbol, params in _DECL.findall(text):
            kinds = [_kind(p) for p in params.split(",") if p.strip()]
            out[symbol] = (" ".join(ret.split()), kinds)
    return out


DECLS = _declarations()


def test_every_entry_point_has_a_signature():
    """Each kernel entry point has a ctypes list and each list an entry
    point; gomel_error_string is bound on its own."""
    kernels = set(DECLS) - {"gomel_error_string"}
    assert kernels and kernels == set(_cuda._SIGNATURES)


@pytest.mark.parametrize("symbol", sorted(_cuda._SIGNATURES))
def test_signature_matches_declaration(symbol):
    ret, kinds = DECLS[symbol]
    assert ret == "int"
    assert kinds[-2:] == ["int", "pointer"]   # (device, stream): launch adds
    assert [_KINDS[k] for k in kinds[:-2]] == _cuda._SIGNATURES[symbol]


def test_parser_reads_kinds():
    """The parser on declarations of each kind, as the sources write them."""
    assert _kind("const void* x") == "pointer"
    assert _kind(" void *out") == "pointer"
    assert _kind("long long batch") == "long long"
    assert _kind("int device") == "int"
    assert _kind("float max_val") == "float"
    with pytest.raises(ValueError):
        _kind("double x")
