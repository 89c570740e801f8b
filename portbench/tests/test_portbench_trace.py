"""The trace reduction on a hand-made timeline, and a roofline share read
from it."""
import pytest

from portbench.harness import cell, loop, trace, yardstick
from portbench.harness.manifest import Manifest

KERNEL = "void stft_mel_log_pow2_kernel<11>(float const*, float*)"


def summary():
    events = [trace.DeviceEvent(KERNEL, 0, 0.1, 0.2),
              trace.DeviceEvent("Memcpy HtoD (Pinned -> Device)", 0, 0.15,
                                0.3),
              trace.DeviceEvent("mel_to_mag_kernel(...)", 0, 0.5, 0.6)]
    spans = [(trace.STRETCH, 0.0, 1.0), ("pb.submit", 0.3, 0.45),
             ("pb.wait", 0.6, 0.95), ("pb.copy_out", 0.35, 0.42)]
    return trace.Summary((0.0, 1.0), [0], events, spans)


def test_merge_and_gaps():
    assert trace.merge([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]
    assert trace.gaps([(0.1, 0.3), (0.5, 0.6)], 0.0, 1.0) == [
        (0.0, 0.1), (0.3, 0.5), (0.6, 1.0)]


def test_busy_copies_and_idle_by_span():
    s = summary()
    assert s.busy_s() == pytest.approx(0.3)
    assert s.copy_s() == pytest.approx(0.15)
    idle = s.idle_by_span()
    # the innermost span open at each gap's midpoint names it
    assert idle == pytest.approx({"host_other": 0.1, "pb.copy_out": 0.2,
                                  "pb.wait": 0.4})
    assert trace.copy_kind("Memcpy DtoH (Device -> Pinned)") == "DtoH"
    assert trace.copy_kind(KERNEL) is None


def test_breakdown_names_stages_and_unmapped():
    b = cell.breakdown(Manifest(), summary())
    names = [n for n, _ in b["device_ops"]]
    assert "mel_encode: stft_mel_log_pow2_kernel" in names
    assert "unmapped: mel_to_mag_kernel" in names
    assert b["idle_gaps"][0] == ["pb.wait", pytest.approx(0.4)]


def test_roofline_share():
    man = Manifest()
    cfg = man.config("gomel-mel-cli")
    shape = {"rows": 64, "samples": 480000, "frames": 372}
    done = loop.Done(640.0, 1.0, 1e-4, shape)
    win = loop.Window(1.0, [done], 1, [None])
    ctx = cell.Context(man, {}, cfg, {}, 0.0, win, {}, summary(), win)
    least = yardstick.least_seconds(*man.stage("mel_encode")[1].work(shape,
                                                                    cfg))
    assert ctx.roofline_pct("mel_encode") == pytest.approx(100 * least / 0.1)
    assert ctx.roofline_pct("phase_decode") is None
