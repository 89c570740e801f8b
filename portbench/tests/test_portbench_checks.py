"""The check that decides ``correct``, driven through the rest of a run on
the CPU at tiny sizes (the harness's look for a card skipped): the program
passes; the control (the bf16 reference in the program's place) and each
fault a cell can have, planted in the timed path, fail."""
import pytest
import torch
from conftest import CPU_SEED, HostClock, drive

from gomel_tpu_torch.parallel import sharded
from portbench import calibrate
from portbench.harness import cell
from portbench.harness.manifest import Manifest

CELLS = ["mel-encode-dev", "phase-roundtrip-dev", "mel-longform-4card"]
CPU = torch.device("cpu")


def run(tiny, workload, patch=None):
    man = Manifest()
    return drive(man, workload, tiny(man, workload), patch=patch)


@pytest.mark.parametrize("workload", CELLS)
def test_program_is_correct(tiny, workload):
    r = run(tiny, workload)
    assert r.correct, r.checks
    assert r.window.attempted > 0
    assert not any(f is not None and not f.all() for f in r.window.flags)
    assert set(cell.report(r.context, False)) == {
        f"audio_s_per_s.{workload}", f"call_p95_ms.{workload}", "setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, workload):
    man = Manifest()
    w = man.workload(workload)
    tr = tiny(man, workload)
    ent = man.entry(tr["entry"]).Entry(man.config(w["config"]), tr,
                                          CPU_SEED, CPU)
    numbers = calibrate.control_numbers(ent, HostClock(),
                                        tr["check"]["sample_calls"])
    assert any(not numbers[k] <= v for k, v in tr["limits"].items()), numbers


def _rows_half(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _altered(out):
    out = out.contiguous().clone()
    flat = out.view(-1)
    flat[flat.numel() // 2] += 100 if out.dtype == torch.int16 else (
        3 if out.dtype == torch.uint8 else 1.0)
    return out


def _quiet_bands_off(out):
    """Log-mel bands more than 66 dB below their frame's peak made 25%
    too loud: a fault of the quiet bands alone."""
    peak = out.amax(dim=(-2, -1), keepdim=True)
    quiet = out < peak - 3.3 * torch.log(torch.tensor(10.0))
    assert quiet.any()
    return torch.where(quiet, out + torch.log(torch.tensor(1.25)), out)


def wrap(ent, method, fault, index):
    """Make ``ent.codec.<method>`` apply ``fault`` to output ``index``
    (None: the only output)."""
    real = getattr(ent.codec, method)

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        if index is None:
            return fault(out)
        out = list(out)
        out[index] = fault(out[index])
        return tuple(out)
    setattr(ent.codec, method, broken)


ENTRY = {"mel-encode-dev": ("encode", None),
         "phase-roundtrip-dev": ("decode_quantized", 0),
         "mel-longform-4card": ("decode", None)}
# the faults each cell can have (a long-form call is one row: no half)
FAULTS = [(w, f) for w in CELLS for f in (_rows_half, _altered)
          if not (w == "mel-longform-4card" and f is _rows_half)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_fault_is_not_correct(tiny, workload, fault):
    method, index = ENTRY[workload]
    r = run(tiny, workload, patch=lambda d: wrap(d, method, fault, index))
    assert not r.correct, r.checks


def test_quiet_band_fault_is_caught_in_the_log_domain(tiny):
    """A fault confined to the quiet bands passes the linear-domain gap and
    fails the share of values a quantizer step off."""
    r = run(tiny, "mel-encode-dev",
            patch=lambda d: wrap(d, "encode", _quiet_bands_off, None))
    c = r.checks
    assert c["logmel_gap"]["value"] <= c["logmel_gap"]["limit"]
    assert c["logmel_step_share"]["value"] > c["logmel_step_share"]["limit"]


def test_exchange_between_cards_left_out_is_not_correct(tiny, monkeypatch):
    def no_pull(exts, mesh, plan):
        for e in exts:
            if e is not None:
                e[:, plan.chunk:].zero_()

    monkeypatch.setattr(sharded, "_pull_right_halo", no_pull)
    monkeypatch.setattr(sharded, "_push_tail_right",
                        lambda sig_exts, mesh, plan: [None] * len(sig_exts))
    r = run(tiny, "mel-longform-4card")
    assert not r.correct, r.checks


@pytest.mark.parametrize("fault", [_rows_half, _altered],
                         ids=["half_the_rows_left_out", "answer_altered"])
def test_phase_plane_fault_is_not_correct(tiny, fault):
    r = run(tiny, "phase-roundtrip-dev",
            patch=lambda d: wrap(d, "encode_quantized", fault, 0))
    assert not r.correct, r.checks


def test_griffin_lim_step_unchanged_is_not_correct(tiny, monkeypatch):
    """The long form's Griffin-Lim returning its start: no iteration run."""
    real = sharded.sharded_griffin_lim_fn

    def no_step(mesh, plan, n_iter, *args, **kwargs):
        return real(mesh, plan, 0, *args, **kwargs)
    monkeypatch.setattr(sharded, "sharded_griffin_lim_fn", no_step)
    r = run(tiny, "mel-longform-4card")
    assert not r.correct, r.checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    """The control at the cell's own size on the card, three seeds."""
    man = Manifest()
    w = man.workload(workload)
    if torch.cuda.device_count() < w["chips"]:
        pytest.skip(f"needs {w['chips']} cards")
    limits = man.traffic(w["traffic"])["limits"]
    for k in range(3):
        numbers = calibrate.control_at(workload, CPU_SEED + k)
        assert any(not numbers[n] <= v for n, v in limits.items()), numbers
