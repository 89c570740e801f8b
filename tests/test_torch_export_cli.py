"""The port's ``export`` and ``info`` tools (gomel_tpu_torch/cli/export.py)
on the CPU, against the JAX package's (gomel_tpu/cli/export.py): each of
the nine subcommands writes an artifact that loads and runs and whose
header carries the JAX tool's fields and values."""
import conftest  # noqa: F401  (forces CPU)

import json

import numpy as np
import pytest
import torch

from gomel_tpu import serving as js
from gomel_tpu.cli import tools as jtools
from gomel_tpu_torch import MelConfig
from gomel_tpu_torch import serving as ts
from gomel_tpu_torch.cli import tools

# each subcommand's size flags: short signals, few frames
SIZES = {"mel-enc": ["--seconds", "0.2"],
         "mel-dec": ["--n-frames", "3", "--momentum", "0.99"],
         "phase-enc": ["--seconds", "0.2"],
         "phase-dec": ["--n-frames", "3"],
         "mel-enc-q": ["--seconds", "0.2"],
         "phase-enc-q": ["--seconds", "0.2"],
         "mel-dec-q": ["--n-frames", "3"],
         "phase-dec-q": ["--n-frames", "3"],
         "phase-rt": ["--seconds", "0.2"]}


def _inputs(exp):
    """Seeded inputs of an artifact's input shapes and dtypes (batch 2)."""
    rng = np.random.default_rng(0)
    out = []
    for shape, dtype in zip(exp.in_shapes, exp.in_dtypes):
        shape = [2 if d == "b" else int(d) for d in shape]
        if dtype.startswith("float"):
            out.append(torch.from_numpy(rng.standard_normal(shape)
                                        .astype(np.float32)))
        elif dtype == "int32":      # key words
            out.append(torch.from_numpy(rng.integers(
                0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
                .view(np.int32)))
        else:
            out.append(torch.from_numpy(rng.integers(
                0, 256, shape, dtype=np.uint8)).to(getattr(torch, dtype)))
    if len(out) >= 3 and exp.in_dtypes[1] == "float32" and \
            not exp.in_dtypes[0].startswith("float"):
        hi, lo = out[1].abs() + 1.0, -out[2].abs()    # extrema: max > min
        out[1], out[2] = hi, lo
    return out


@pytest.mark.parametrize("kind", list(SIZES))
def test_export_subcommand_matches_the_jax_tool(kind, tmp_path):
    out, jout = str(tmp_path / "a.gmexp"), str(tmp_path / "a.jaxexp")
    assert tools.main(["export", kind, out, *SIZES[kind], "--device",
                       "cpu"]) == 0
    assert jtools.main(["export", kind, jout, *SIZES[kind], "--platforms",
                        "cpu"]) == 0
    meta, jmeta = ts.read_artifact_meta(out), js.read_artifact_meta(jout)
    # the keys' uint32 bits go in as int32 (gomel_tpu_torch/serving.py)
    jmeta["in_dtypes"] = ["int32" if d == "uint32" else d
                          for d in jmeta["in_dtypes"]]
    for key in jmeta:
        assert meta[key] == jmeta[key], key
    art = ts.load_exported(out)
    got = art.call(*_inputs(art))
    got = got if isinstance(got, tuple) else (got,)
    assert all(t.shape[0] == 2 for t in got)
    for t in got:
        if t.dtype.is_floating_point:
            assert bool(torch.isfinite(t).all())


def test_export_cli_builds_a_runnable_artifact(tmp_path):
    out = str(tmp_path / "enc.gmexp")
    rc = tools.main(["export", "mel-enc", out, "--seconds", "0.2",
                     "--sample-rate", "48000", "--preset", "lib",
                     "--device", "cpu", "--batch", "2"])
    assert rc == 0
    art = ts.load_exported(out)
    n = int(art.in_shapes[0][1])
    x = torch.from_numpy(np.random.RandomState(0).randn(2, n)
                         .astype(np.float32))
    got = art.call(x)
    assert got.shape[0] == 2 and got.shape[2] == MelConfig().num_mels
    assert bool(torch.isfinite(got).all())
    with pytest.raises(ValueError):
        art.call(x[:1])     # the batch was pinned at 2


def test_info_prints_the_header(tmp_path, capsys):
    out = str(tmp_path / "enc.gmexp")
    assert tools.main(["export", "mel-enc", out, "--seconds", "0.2",
                       "--preset", "lib", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert tools.main(["info", out]) == 0
    meta = json.loads(capsys.readouterr().out)
    assert meta == ts.read_artifact_meta(out)
    assert meta["kind"] == "mel-enc" and meta["platforms"] == ["cpu"]
    assert meta["config"]["num_mels"] == MelConfig().num_mels
    assert meta["seconds"] == 0.2 and meta["sample_rate"] == 48000
    assert meta["in_shapes"][0][0] == "b"


def test_info_and_export_refuse_bad_input(tmp_path, capsys):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"PNG\x00junk")
    assert tools.main(["info", str(junk)]) == 1
    assert "not a gomel_tpu_torch serving artifact" in capsys.readouterr().err
    if not torch.cuda.is_available():
        # the default device is the card: without one the tool exits 1
        assert tools.main(["export", "mel-enc", str(tmp_path / "c.gmexp"),
                           "--seconds", "0.2"]) == 1
        assert not (tmp_path / "c.gmexp").exists()
    with pytest.raises(SystemExit):
        tools.main(["export", "mel-dec", str(tmp_path / "d.gmexp")])


def test_tools_list_export_and_info(capsys):
    assert tools.main([]) == 1
    usage = capsys.readouterr().err
    assert "export" in usage and "info" in usage
