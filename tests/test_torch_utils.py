"""The port's utils (gomel_tpu_torch/utils): metrics, timers, profiling,
logging; counterparts of tests/test_utils.py, and the Griffin-Lim quality
metric against the JAX package's."""
import conftest  # noqa: F401  (forces CPU)

import json
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomel_tpu.utils import spectral_convergence as jax_spectral_convergence
from gomel_tpu_torch.utils import (ThroughputResult, get_logger, log_event,
                                   measure_throughput, scaling_efficiency,
                                   spectral_convergence)
from gomel_tpu_torch.utils import logging as tlog
from gomel_tpu_torch.utils import metrics


def test_measure_throughput_counts():
    res = measure_throughput(lambda x: x * 2.0, (torch.ones(1000),),
                             audio_seconds_per_call=2.0, min_seconds=0.05)
    assert res.iters >= 3
    assert res.audio_seconds == 2.0 * res.iters
    assert res.audio_seconds_per_second > 0
    assert set(res.json()) == {"audio_seconds_per_second", "per_chip",
                               "iters", "n_devices", "wall_seconds"}


def test_measure_throughput_alternates_args():
    seen = []

    def fn(x):
        seen.append(float(x[0]))
        return x
    res = measure_throughput(fn, (torch.zeros(4),), 1.0,
                             alt_args=(torch.ones(4),), min_seconds=0.01,
                             max_iters=4, trials=1)
    assert res.iters >= 3 and {0.0, 1.0} <= set(seen)


def test_force_takes_pytrees_of_cpu_tensors():
    metrics._force((torch.ones(3), {"a": [torch.zeros(2)]}, None))
    metrics._force(torch.ones(3))


def test_scaling_efficiency():
    a = ThroughputResult(audio_seconds=100, wall_seconds=1.0, iters=1,
                         n_devices=1)
    b = ThroughputResult(audio_seconds=720, wall_seconds=1.0, iters=1,
                         n_devices=8)
    assert scaling_efficiency(a, b) == 0.9
    assert b.per_chip == 90.0


def test_logger_is_one_per_process():
    logger = get_logger()
    assert logger.name == "gomel_tpu_torch"
    log_event("test_event", foo=1)
    assert get_logger() is logger


def test_json_lines_carry_the_rank_and_fields():
    record = logging.LogRecord("gomel_tpu_torch", logging.INFO, __file__, 1,
                               "encode_done", (), None)
    record.fields = {"frames": 128}
    assert tlog._ProcessFilter().filter(record)
    assert record.process_rank == 0     # no process group
    payload = json.loads(tlog._JsonFormatter().format(record))
    assert payload["msg"] == "encode_done" and payload["frames"] == 128
    assert payload["process"] == 0 and payload["level"] == "INFO"


def test_save_wav_rejects_nonfinite(tmp_path):
    from gomel_tpu_torch.io.audio import save_wav
    bad = np.zeros(100)
    bad[50] = np.nan
    with pytest.raises(ValueError, match="NaN/Inf"):
        save_wav(str(tmp_path / "bad.wav"), bad, 16000)
    bad[50] = np.inf
    with pytest.raises(ValueError, match="NaN/Inf"):
        save_wav(str(tmp_path / "bad2.wav"), bad, 16000)


def test_device_trace_writes_profile(tmp_path):
    from gomel_tpu_torch.utils.profiling import annotate, device_trace
    logdir = str(tmp_path / "trace")
    with device_trace(logdir):
        with annotate("test_region"):
            torch.ones(128).sum()
    names = os.listdir(logdir)
    assert len(names) == 1 and names[0].endswith(".json")
    with open(os.path.join(logdir, names[0])) as f:
        trace = json.load(f)
    assert any(e.get("name") == "test_region"
               for e in trace["traceEvents"])


@pytest.mark.parametrize("scale_invariant", [True, False])
def test_spectral_convergence_matches_jax(scale_invariant):
    rng = np.random.default_rng(4)
    n, hop = 256, 64
    sig = rng.standard_normal(n + 20 * hop)
    frames = np.lib.stride_tricks.sliding_window_view(sig, n)[::hop]
    target = np.abs(np.fft.rfft(frames * np.hanning(n), axis=-1))
    target = target * (1.0 + 0.1 * rng.standard_normal(target.shape))
    want = jax_spectral_convergence(jnp.asarray(sig), jnp.asarray(target), n,
                                    hop, scale_invariant=scale_invariant)
    got = spectral_convergence(torch.from_numpy(sig),
                               torch.from_numpy(target), n, hop,
                               scale_invariant=scale_invariant)
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
    # a scaled copy of the signal: the gain is factored out
    if scale_invariant:
        assert abs(spectral_convergence(torch.from_numpy(3.0 * sig),
                                        torch.from_numpy(target), n, hop)
                   - got) <= 1e-12


def test_spectral_convergence_of_silence_is_finite():
    target = torch.rand(21, 129, dtype=torch.float64) + 0.1
    got = spectral_convergence(torch.zeros(256 + 20 * 64,
                                           dtype=torch.float64),
                               target, 256, 64)
    assert got == pytest.approx(1.0)
