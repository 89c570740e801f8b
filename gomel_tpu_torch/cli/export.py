"""``export`` and ``info``: build serving artifacts from the command line
and print their headers.

Counterpart of ``gomel_tpu/cli/export.py`` over gomel_tpu_torch/serving.py:

    python -m gomel_tpu_torch.cli.tools export mel-enc out.gmexp --seconds 30
    python -m gomel_tpu_torch.cli.tools export mel-dec out.gmexp \\
        --n-frames 1122 --momentum 0.99
    python -m gomel_tpu_torch.cli.tools export phase-enc out.gmexp \\
        --seconds 30 --sample-rate 48000
    python -m gomel_tpu_torch.cli.tools info out.gmexp

Mel tools default to the reference CLI preset (192 mels, what ``tomel`` and
``towav`` write); ``--preset lib`` selects the bare defaults (160). Phase
tools take ``--sample-rate`` (num_freqs derived from it) or ``--preset cli``
for the ``tophase``/``fromphase`` parameters. ``--batch 0`` (the default)
exports a symbolic batch: one artifact serves every batch size; a positive
value pins it. ``--device`` (``cuda`` by default; ``cpu``) is the device the
artifact is built for and runs on: without a card, ``cuda`` exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("output", help="artifact path to write")
    p.add_argument("--batch", type=int, default=0,
                   help="pinned batch size; 0 = symbolic (any batch)")
    p.add_argument("--device", default="cuda",
                   help="the device the artifact runs on: cuda or cpu")


def _mel_cfg(a):
    from ..core.config import MelConfig
    return MelConfig.cli_default() if a.preset == "cli" else MelConfig()


def _phase_cfg(a):
    from ..core.config import PhaseConfig
    if a.preset == "cli":
        return PhaseConfig.cli_default()
    return PhaseConfig.for_sample_rate(a.sample_rate)


def info_tool(argv: Optional[Sequence[str]] = None) -> int:
    """``info <artifact>``: print an artifact's JSON header (reads only the
    header; needs no device)."""
    p = argparse.ArgumentParser(prog="gomel_tpu_torch info")
    p.add_argument("artifact", help="artifact path")
    a = p.parse_args(argv)
    from .. import serving
    try:
        meta = serving.read_artifact_meta(a.artifact)
    except (OSError, ValueError) as e:
        print(f"info: {e}", file=sys.stderr)
        return 1
    print(json.dumps(meta, indent=2))
    return 0


# subcommand -> (help, input kind, preset choices)
_KINDS = {
    "mel-enc": ("[B,T] audio -> [B,F,M,2] log-mel", "seconds", "mel"),
    "mel-dec": ("([B,F,M,2] log-mel, [B,2] keys) -> [B,L] audio", "frames",
                "mel"),
    "phase-enc": ("[B,T] audio -> [B,F,NF,2] phase", "seconds", "phase"),
    "phase-dec": ("[B,F,NF,2] phase -> [B,L] audio", "frames", "phase"),
    "mel-enc-q": ("[B,T] audio -> (uint8 planes, extrema): mel encode with "
                  "the PNG quantizer fused in", "seconds", "mel"),
    "phase-enc-q": ("[B,T] audio -> (uint8/16 planes, extrema): phase encode "
                    "with the PNG quantizer fused in", "seconds", "phase"),
    "mel-dec-q": ("(uint8 planes, extrema, keys) -> int16 PCM: dequantize + "
                  "Griffin-Lim + PCM-16 in one program", "frames", "mel"),
    "phase-dec-q": ("(planes, extrema) -> int16 PCM: dequantize + iSTFT + "
                    "PCM-16 in one program", "frames", "phase"),
    "phase-rt": ("[B,T] audio -> [B,L] audio: encode and decode in one "
                 "program", "seconds", "phase"),
}


def export_tool(argv: Optional[Sequence[str]] = None) -> int:
    """``export <kind> <output> ...``: build, save and describe one
    artifact."""
    parser = argparse.ArgumentParser(prog="gomel_tpu_torch export")
    sub = parser.add_subparsers(dest="kind", required=True)
    for kind, (text, size, family) in _KINDS.items():
        p = sub.add_parser(kind, help=text)
        _common(p)
        if size == "seconds":
            p.add_argument("--seconds", type=float, required=True)
        else:
            p.add_argument("--n-frames", type=int, required=True)
        if family == "phase" or size == "seconds":
            p.add_argument("--sample-rate", type=int, default=48000)
        if kind in ("mel-dec", "mel-dec-q"):
            p.add_argument("--momentum", type=float, default=0.0,
                           help="fast-GL momentum baked into the artifact "
                                "(ops/griffinlim.recommended_gl)")
        # the presets each family's config reader understands
        p.add_argument("--preset", choices=("cli", "lib") if family == "mel"
                       else ("cli", "sr"),
                       default="cli" if family == "mel" else "sr")

    a = parser.parse_args(argv)
    from .. import serving
    batch = a.batch if a.batch > 0 else None
    cfg = _mel_cfg(a) if _KINDS[a.kind][2] == "mel" else _phase_cfg(a)
    common = {"batch": batch, "device": a.device}
    builders = {
        "mel-enc": serving.export_mel_encoder,
        "mel-dec": serving.export_mel_decoder,
        "phase-enc": serving.export_phase_encoder,
        "phase-dec": serving.export_phase_decoder,
        "mel-enc-q": serving.export_mel_encoder_quantized,
        "phase-enc-q": serving.export_phase_encoder_quantized,
        "mel-dec-q": serving.export_mel_decoder_quantized,
        "phase-dec-q": serving.export_phase_decoder_quantized,
        "phase-rt": serving.export_phase_roundtrip,
    }
    if _KINDS[a.kind][1] == "seconds":
        extra = {"seconds": a.seconds, "sample_rate": a.sample_rate}
    else:
        extra = {"n_frames": a.n_frames}
    if hasattr(a, "momentum"):
        extra["momentum"] = a.momentum
    try:
        exp = builders[a.kind](cfg, **common, **extra)
    except RuntimeError as e:       # the device is absent
        print(f"export: {e}", file=sys.stderr)
        return 1
    serving.save_exported(exp, a.output, meta=serving.artifact_meta(
        exp, cfg, kind=a.kind, **extra))
    print(f"wrote {a.output}: in {exp.in_shapes}, device {exp.device}",
          file=sys.stderr)
    return 0
