"""The port's call surface held to the JAX package's.

Every module ``gomel_tpu.X`` has a counterpart ``gomel_tpu_torch.X``. Every
class and function that a JAX module defines itself, or that a package's
``__init__`` lists in ``__all__``, exists in the counterpart with the same
parameter names, the same positional order and the same defaults (a class
by its ``__init__`` and its public methods). A default that is a JAX dtype
is held by its name (``jnp.float32`` -> ``torch.float32``). Where the port
takes a parameter the JAX function lacks, it must be keyword-only or come
after the JAX parameters, so a JAX-style positional call still lines up.

``DEPARTURES`` lists each difference that is kept, with its reason. Any
other difference fails, and so does an entry that matches no difference
any more, so the list cannot go stale. A JAX caller switches packages by
the import alone, apart from these entries.
"""
import fnmatch
import importlib
import inspect
import pathlib
import tomllib

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (JAX module, qualified name, parameter, kind) -> reason; "*" and shell
# patterns match several. Kinds: "absent" (no counterpart), "missing" (a JAX
# parameter the port lacks), "default", "extra" (a port parameter the JAX
# function lacks).
DEPARTURES = {
    ("*", "*", "dtype", "dtype"):
        "dtype defaults are torch dtypes of the JAX dtype's name",
    ("gomel_tpu.serving", "export_*", "platforms", "missing"):
        "the export functions take device= in place of platforms= "
        "(gomel_tpu_torch/serving.py module docstring)",
    ("gomel_tpu.serving", "export_*", "device", "extra"):
        "the export functions' device= replaces platforms=",
    ("gomel_tpu.serving", "export_*", "*fft_backend", "default"):
        "the export functions default to auto, which resolves as on the card; the "
        "JAX defaults (mxu, mm, xla) were chosen on a TPU",
    ("gomel_tpu.serving", "export_longform_mel_decoder", "interior_mm",
     "default"):
        "None runs the exact interior iteration, as fft_backend=auto; the "
        "bf16 matmul interior is the TPU's optimum, not the card's",
    ("gomel_tpu.parallel*", "sharded_*_encode_fn", "frame_chunk",
     "default"):
        "None: the chunked host loop (K18) measured slower than one launch "
        "on the card (PERF.md section 6)",
    ("gomel_tpu.parallel.mesh", "data_sharding", None, "absent"):
        "builds a NamedSharding; a Sharded carries its layout in the port",
    ("gomel_tpu.parallel.mesh", "batch_frame_sharding", None, "absent"):
        "builds a NamedSharding; a Sharded carries its layout in the port",
    ("gomel_tpu.parallel.mesh", "replicated", None, "absent"):
        "builds a NamedSharding; a Sharded carries its layout in the port",
    ("gomel_tpu.parallel.mesh", "virtual_cpu_devices", None, "absent"):
        "sets an XLA flag for CPU test meshes; no torch meaning",
    ("gomel_tpu.parallel", "data_sharding", None, "absent"):
        "re-export of the parallel/mesh entry",
    ("gomel_tpu.parallel", "batch_frame_sharding", None, "absent"):
        "re-export of the parallel/mesh entry",
    ("gomel_tpu.parallel", "replicated", None, "absent"):
        "re-export of the parallel/mesh entry",
    ("gomel_tpu.parallel*", "host_to_global", "spec", "default"):
        "the port defaults spec to (data, frame); a JAX caller passes it",
    ("gomel_tpu.parallel*", "local_rows_to_global", "spec", "default"):
        "the port defaults spec to (data,); a JAX caller passes it",
    ("*", "*", "device", "extra"):
        "the port's device keyword: every entry point defaults to cuda and "
        "raises without a card",
    ("gomel_tpu.ops.fftbackend", "resolve", "device_type", "extra"):
        "a route depends on the tensor's device; JAX resolves per process",
    ("gomel_tpu.parallel*", "initialize_multihost", "backend", "extra"):
        "torch.distributed's backend (nccl or gloo)",
    ("gomel_tpu.parallel*", "initialize_multihost", "timeout_s", "extra"):
        "torch.distributed's rendezvous timeout",
    ("gomel_tpu.parallel*", "Batched*.__init__", "mel", "extra"):
        "a Mel (Mel.from_numpy) in place of config, dtype and device",
    ("gomel_tpu.parallel*", "Batched*.__init__", "phase", "extra"):
        "a Phase (Phase.from_numpy) in place of config, dtype and device",
    ("gomel_tpu.ops.griffinlim", "griffin_lim", "key", "default"):
        "key may be None where init= gives the start",
    ("gomel_tpu.ops.mel_ops", "mel_decode", "key", "default"):
        "key may be None where init= gives the start",
    ("gomel_tpu.ops.mel_ops", "mel_decode", "init", "extra"):
        "a given start in place of the key's draw (tests of one iteration)",
    ("*", "*", "pcm16", "extra"):
        "the fused PCM-16 conversion of the decodes' last kernel",
    ("gomel_tpu.ops.istft", "chunked_irfft_overlap_add", "real_frames",
     "extra"):
        "a prefix frame_mask given as its length (KG's real-frame count)",
    ("gomel_tpu.ops.mel_ops", "mel_encode*", "pcm_scale", "extra"):
        "the divisor of an int16 source (KA, or the fused launch's int16 mode)",
    ("gomel_tpu.utils*", "StageTimer*", None, "absent"):
        "the span record (utils/profiling.annotate, recorded) replaces it "
        "and never synchronises the card",
}


def _module_names(package: str) -> list[str]:
    base = ROOT / package
    names = []
    for path in sorted(base.rglob("*.py")):
        parts = (package,) + path.relative_to(base).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


JAX_MODULES = _module_names("gomel_tpu")


def _port_name(jax_module: str) -> str:
    return "gomel_tpu_torch" + jax_module[len("gomel_tpu"):]


def _is_entry(v) -> bool:
    """A class, or a function behind any wrappers (``functools.lru_cache``
    and ``functools.wraps`` keep it as ``__wrapped__``)."""
    return inspect.isclass(v) or (callable(v)
                                  and inspect.isfunction(inspect.unwrap(v)))


def _public(module) -> dict:
    """The classes and functions ``module`` defines, and those its
    ``__all__`` lists when it is a package."""
    out = {k: v for k, v in vars(module).items()
           if not k.startswith("_") and _is_entry(v)
           and v.__module__ == module.__name__}
    if hasattr(module, "__path__"):
        for k in getattr(module, "__all__", ()):
            v = getattr(module, k)
            if _is_entry(v):
                out[k] = v
    return out


def _callables(jax_module: str) -> list[str]:
    """The qualified name of every entry to compare: functions, classes,
    each class's __init__ and its public methods."""
    out = []
    for name, obj in _public(importlib.import_module(jax_module)).items():
        out.append(name)
        if inspect.isclass(obj):
            out += [f"{name}.{meth}" for meth, val in vars(obj).items()
                    if meth == "__init__" or (not meth.startswith("_") and (
                        inspect.isfunction(val)
                        or isinstance(val, (classmethod, staticmethod))))]
    return out


CASES = [(m, q) for m in JAX_MODULES for q in _callables(m)]


def _resolve(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = inspect.getattr_static(obj, part, None) \
            if inspect.isclass(obj) else getattr(obj, part, None)
        if isinstance(obj, (classmethod, staticmethod)):
            obj = obj.__func__
        if obj is None:
            return None
    return obj


def _dtype_name(value):
    """The name of a dtype default (JAX, numpy or torch), else None."""
    import torch
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, type) and value is not inspect.Parameter.empty:
        try:
            return np.dtype(value).name
        except TypeError:
            return None
    return None


def _same(a, b) -> bool:
    if a is b:
        return True
    try:
        return bool(a == b)
    except Exception:
        return False


def differences(jax_module: str, qualname: str) -> list[tuple]:
    """Each difference of ``qualname`` between ``jax_module`` and its port
    counterpart as (parameter, kind); kinds as in DEPARTURES, plus "order"
    (a JAX positional parameter at another place), "placement" (a port
    extra among the JAX positional parameters) and "signature" (a
    signature that cannot be read, so nothing can be compared)."""
    jobj = _resolve(jax_module, qualname)
    tobj = _resolve(_port_name(jax_module), qualname)
    if tobj is None:
        return [(None, "absent")]
    if inspect.isclass(jobj):
        if not inspect.isclass(tobj):
            return [(None, "kind")]
        return []
    try:
        jsig = inspect.signature(inspect.unwrap(jobj))
        tsig = inspect.signature(inspect.unwrap(tobj))
    except (TypeError, ValueError):
        return [(None, "signature")]
    jp, tp = jsig.parameters, tsig.parameters
    positional = (inspect.Parameter.POSITIONAL_ONLY,
                  inspect.Parameter.POSITIONAL_OR_KEYWORD)
    jpos = [n for n, p in jp.items() if p.kind in positional]
    tpos = [n for n, p in tp.items() if p.kind in positional]
    out = []
    for i, name in enumerate(jpos):
        if name in tp and (i >= len(tpos) or tpos[i] != name):
            out.append((name, "order"))
    for i, name in enumerate(tpos[:len(jpos)]):
        if name not in jp:
            out.append((name, "placement"))
    for name, p in jp.items():
        if p.kind in (inspect.Parameter.VAR_POSITIONAL,
                      inspect.Parameter.VAR_KEYWORD):
            if not any(q.kind == p.kind for q in tp.values()):
                out.append((name, "missing"))
            continue
        q = tp.get(name)
        if q is None:
            out.append((name, "missing"))
            continue
        jd, td = _dtype_name(p.default), _dtype_name(q.default)
        if jd is not None and p.default is not q.default:
            out.append((name, "dtype" if jd == td else "default"))
        elif not _same(p.default, q.default):
            out.append((name, "default"))
    for name, q in tp.items():
        if name not in jp and q.kind not in (inspect.Parameter.VAR_POSITIONAL,
                                             inspect.Parameter.VAR_KEYWORD):
            out.append((name, "extra"))
    return out


def _departure(jax_module: str, qualname: str, param, kind):
    for key, reason in DEPARTURES.items():
        km, kq, kp, kk = key
        if (kk == kind and fnmatch.fnmatchcase(jax_module, km)
                and fnmatch.fnmatchcase(qualname, kq)
                and (kp == param or (kp is not None and param is not None
                                     and fnmatch.fnmatchcase(param, kp)))):
            return key
    return None


def test_every_departure_has_a_reason():
    for key, reason in DEPARTURES.items():
        assert len(key) == 4 and key[3] in ("absent", "missing", "default",
                                            "extra", "dtype"), key
        assert reason and "\n" not in reason, key


@pytest.mark.parametrize("jax_module", JAX_MODULES)
def test_module_has_counterpart(jax_module):
    """Every module of the JAX package has a counterpart in the port."""
    assert importlib.import_module(_port_name(jax_module))


@pytest.mark.parametrize("jax_module,qualname", CASES)
def test_signature_matches_jax(jax_module, qualname):
    """Names, positional order and defaults of one JAX function, class or
    method against the port's; only DEPARTURES may differ."""
    unlisted = [(param, kind) for param, kind in
                differences(jax_module, qualname)
                if _departure(jax_module, qualname, param, kind) is None]
    assert not unlisted, (f"{jax_module}.{qualname}: {unlisted}; the port "
                          f"must take the JAX parameters in the JAX order")


def test_departures_are_not_stale():
    """Every entry of DEPARTURES names a difference that still exists."""
    used = set()
    for jax_module, qualname in CASES:
        for param, kind in differences(jax_module, qualname):
            key = _departure(jax_module, qualname, param, kind)
            if key is not None:
                used.add(key)
    assert not set(DEPARTURES) - used, sorted(
        map(str, set(DEPARTURES) - used))


def test_differences_sees_a_reordered_call():
    """The comparison itself: swapped and shifted parameters, an extra
    among the positional ones and changed defaults are each reported."""
    def f(a, b, c=1, d=2):
        pass

    def g(a, c, b, extra=None, d=3):
        pass
    assert _differences_of(f, g) == {
        ("b", "order"), ("c", "order"), ("d", "order"),
        ("extra", "placement"), ("c", "default"), ("d", "default"),
        ("extra", "extra")}


@pytest.mark.parametrize("jax_module,qualname", [
    ("gomel_tpu.core.filterbank", "mel_weights"),
    ("gomel_tpu.core.filterbank", "inverse_mel_weights"),
    ("gomel_tpu.ops.stft", "hann_window"),
])
def test_cached_functions_are_compared(jax_module, qualname):
    """A function behind ``functools.lru_cache`` is one of the cases, and
    its signature is read through the cache wrapper."""
    assert (jax_module, qualname) in CASES
    assert not isinstance(_resolve(jax_module, qualname), type(lambda: 0))
    assert differences(jax_module, qualname) == []


def _differences_of(f, g) -> set:
    """differences() between f as a JAX module's entry and g as the port's."""
    import sys
    import types
    jax_mod, port_mod = types.ModuleType("gomel_tpu.x"), \
        types.ModuleType("gomel_tpu_torch.x")
    f.__module__, g.__module__ = jax_mod.__name__, port_mod.__name__
    jax_mod.f, port_mod.f = f, g
    sys.modules[jax_mod.__name__] = jax_mod
    sys.modules[port_mod.__name__] = port_mod
    try:
        assert "f" in _public(jax_mod)
        return set(differences("gomel_tpu.x", "f"))
    finally:
        del sys.modules[jax_mod.__name__], sys.modules[port_mod.__name__]


@pytest.mark.parametrize("wrap", ["plain", "lru_cache", "wraps"])
def test_differences_sees_a_wrapped_function(wrap):
    """A function behind a wrapper on either side is compared by the
    wrapped function's signature, not the wrapper's."""
    import functools

    def f(n, m=1):
        pass

    def g(n, m=2):
        pass
    if wrap == "lru_cache":
        f, g = functools.lru_cache(f), functools.lru_cache(g)
    elif wrap == "wraps":
        def deco(fn):
            @functools.wraps(fn)
            def inner(*args, **kwargs):
                return fn(*args, **kwargs)
            return inner
        f, g = deco(f), deco(g)
    assert _differences_of(f, g) == {("m", "default")}


def test_unreadable_signature_is_a_difference():
    """A callable whose signature cannot be read is reported, not passed."""
    def f(a):
        pass

    def g(a):
        pass
    g.__signature__ = "unreadable"
    assert _differences_of(f, g) == {(None, "signature")}


def test_console_script_names_the_port():
    """pyproject.toml binds ``gomel-tpu-torch`` to the port's multiplexed
    CLI, a callable of gomel_tpu_torch, beside the JAX scripts."""
    with open(ROOT / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    target = scripts["gomel-tpu-torch"]
    module, _, attr = target.partition(":")
    assert module.startswith("gomel_tpu_torch.")
    fn = getattr(importlib.import_module(module), attr)
    assert callable(fn)
    assert fn(["no-such-tool"]) == 1
    assert scripts["gomel-tpu"] == "gomel_tpu.cli.tools:main"
