"""The numbers a check compares: each a gap between the program's outputs
and the float64 reference's, larger is worse, NaN where the program's
output is not finite."""
from __future__ import annotations

import math

import torch


def _max(t: torch.Tensor) -> float:
    v = float(t.max()) if t.numel() else 0.0
    return v if math.isfinite(v) else math.nan


def logmel_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of a log-mel [B, F, mels, 2] in the linear domain, as a
    share of its frame's peak: max |e^p - e^r| / max_frame e^r."""
    p = torch.exp(prog.to(torch.float64))
    r = torch.exp(ref.to(torch.float64))
    peak = r.flatten(2).amax(dim=-1)
    gap = (p - r).abs().flatten(2).amax(dim=-1) / peak
    return _max(torch.nan_to_num(gap, nan=math.inf))


def _log_steps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|p - r| of a log-mel [B, F, mels, 2] over its row's log range (the
    span the PNG quantizer maps to 255 steps), [B, F * mels * 2]."""
    p, r = prog.to(torch.float64).flatten(1), ref.to(torch.float64).flatten(1)
    span = r.amax(dim=-1, keepdim=True) - r.amin(dim=-1, keepdim=True)
    return torch.nan_to_num((p - r).abs() / span, nan=math.inf)


def logmel_log_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of a log-mel in the log domain, as a share of its row's
    log range: it holds the quiet bands, which ``logmel_gap`` scales by
    their frame's peak."""
    return _max(_log_steps(prog, ref))


def logmel_step_share(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Share of a log-mel's values more than one 8-bit step of their row's
    log range from the reference's."""
    return float((_log_steps(prog, ref) > 1.0 / 255).to(torch.float64)
                 .mean())


def _exact_pcm(sig: torch.Tensor) -> torch.Tensor:
    return torch.clip(sig.to(torch.float64) * 32768.0, -32768.0, 32767.0)


def pcm_gap_lsb(pcm: torch.Tensor, sig_ref: torch.Tensor) -> float:
    """Widest distance, in steps of PCM-16, from the program's samples to
    the reference's exact (unrounded, saturated) values."""
    d = (pcm.to(torch.float64) - _exact_pcm(sig_ref)).abs()
    return _max(torch.nan_to_num(d, nan=math.inf))


def pcm_rms_rel(pcm: torch.Tensor, sig_ref: torch.Tensor) -> float:
    """Worst row's RMS gap to the reference's exact values over the RMS of
    those values."""
    exact = _exact_pcm(sig_ref)
    d = pcm.to(torch.float64) - exact
    rel = d.pow(2).mean(dim=-1).sqrt() / exact.pow(2).mean(dim=-1).sqrt()
    return _max(torch.nan_to_num(rel, nan=math.inf))


def plane_steps(prog: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(widest step, share of pixels off) between integer planes."""
    d = (prog.to(torch.int32) - ref.to(torch.int32)).abs()
    return float(d.max()), float((d > 0).to(torch.float64).mean())


def extrema_gap(mx, mn, ref_mx, ref_mn) -> float:
    """Widest gap of the quantizer's extrema over the reference's range."""
    f = torch.float64
    mx, mn = torch.as_tensor(mx).to(f).cpu(), torch.as_tensor(mn).to(f).cpu()
    rmx, rmn = ref_mx.to(f).cpu(), ref_mn.to(f).cpu()
    span = rmx - rmn
    gap = torch.maximum((mx - rmx).abs(), (mn - rmn).abs()) / span
    return _max(torch.nan_to_num(gap, nan=math.inf))


def worst(*values: float) -> float:
    """The largest value, NaN if any is NaN."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def signal_gap_lsb(sig: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest gap of a float signal to the reference's, in steps of PCM-16
    (1/32768)."""
    d = (sig.to(torch.float64) - ref.to(torch.float64)).abs() * 32768.0
    return _max(torch.nan_to_num(d, nan=math.inf))


def signal_rms_rel(sig: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst row's RMS gap to the reference over the reference's RMS."""
    ref = ref.to(torch.float64)
    d = sig.to(torch.float64) - ref
    rel = d.pow(2).mean(dim=-1).sqrt() / ref.pow(2).mean(dim=-1).sqrt()
    return _max(torch.nan_to_num(rel, nan=math.inf))
