"""Command-line tools ``tomel`` (audio -> mel spectrogram PNG), ``towav``
(mel PNG -> WAV by Griffin-Lim), ``tophase`` (audio -> phase spectrogram
PNG) and ``fromphase`` (phase PNG -> WAV).

Counterparts of ``gomel_tpu/cli/tools.py`` (reference Go CLIs
cmd/tomel/main.go:11-60, cmd/towav/main.go:10-48,
cmd/tophase/main.go:11-56, cmd/fromphase/main.go:10-36): the same baked-in
parameters, file routing and flags, plus ``--device``. Run as::

    python -m gomel_tpu_torch.cli.tools tomel input.wav [--device cuda|cpu]
    python -m gomel_tpu_torch.cli.tools towav input.wav.png [sample_rate] \
        [--seed S] [--gl-momentum M] [--device cuda|cpu]
    python -m gomel_tpu_torch.cli.tools tophase input.wav [--device cuda|cpu]
    python -m gomel_tpu_torch.cli.tools fromphase input.wav.png [--device ...]
    python -m gomel_tpu_torch.cli.tools batch-tomel|batch-tophase|\
        batch-fromphase|batch-towav DIR... [--out-dir D] [--device ...]

``--device`` defaults to ``cuda``. Without a CUDA device a tool prints an
error naming the missing device and exits 1; the CPU path runs only when
``--device cpu`` asks for it.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import torch

from ..core.config import MelConfig, PhaseConfig
from ..pipelines.mel import Mel
from ..pipelines.phase import Phase


def _route_audio_input(filename: str) -> tuple[str, str]:
    """Reference routing: .flac -> flac, .wav -> wav, bare name -> name.wav
    (cmd/tomel/main.go:33-59)."""
    if filename.endswith(".flac"):
        return filename, "flac"
    if filename.endswith(".wav"):
        return filename, "wav"
    return filename + ".wav", "wav"


def _add_device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device-quantize", dest="device_quantize",
                   action="store_true", default=True,
                   help="(de)quantize the PNG planes on the device, with "
                        "raw int16 samples crossing to and from it "
                        "(default; byte-near the host quantizer)")
    p.add_argument("--host-quantize", dest="device_quantize",
                   action="store_false",
                   help="byte-exact host-side float64 PNG quantization")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")


def _missing_device(prog: str, device: str) -> bool:
    """Print an error and return True when ``device`` asks for CUDA and none
    is available: the tool never falls back to the CPU on its own."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: device {device!r} is not available "
              f"(torch.cuda.is_available() is False); pass --device cpu to "
              f"run on the CPU", file=sys.stderr)
        return True
    return False


def _mel_parser(prog: str, png_input: bool) -> argparse.ArgumentParser:
    """The flags of ``tomel`` and ``towav``, shared as in the JAX package
    (gomel_tpu/cli/tools.py:36-74), plus ``--device``."""
    d = MelConfig.cli_default()   # single source of the reference CLI params
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("filename",
                   help="PNG file" if png_input else
                   "audio file (.wav/.flac; bare name implies .wav)")
    if png_input:
        p.add_argument("sample_rate", nargs="?", type=int, default=44100,
                       help="output sample rate (default 44100)")
        p.add_argument("--seed", type=int, default=0,
                       help="Griffin-Lim seed of the initial signal")
        p.add_argument("--gl-momentum", type=float, default=0.0,
                       help="fast-Griffin-Lim momentum (0 = reference "
                            "behaviour); ops/griffinlim.recommended_gl gives "
                            "the JAX package's measured equal-quality pairs, "
                            "e.g. 0.99 at 24 iterations for plain 64")
    p.add_argument("--output", "-o", default=None, help="output path")
    p.add_argument("--num-mels", type=int, default=d.num_mels)
    p.add_argument("--window", type=int, default=d.window)
    p.add_argument("--resolut", type=int, default=d.resolut)
    p.add_argument("--fmax", type=float, default=d.mel_fmax)
    p.add_argument("--griffin-lim-iterations", type=int,
                   default=d.griffin_lim_iterations)
    p.add_argument("--volume-boost", type=float, default=d.volume_boost)
    _add_device_flags(p)
    return p


def _mel_from_args(a, sample_rate: int = 0) -> Mel:
    return Mel(MelConfig(
        num_mels=a.num_mels, mel_fmin=0.0, mel_fmax=a.fmax, y_reverse=True,
        window=a.window, resolut=a.resolut,
        griffin_lim_iterations=a.griffin_lim_iterations,
        volume_boost=a.volume_boost, sample_rate=sample_rate),
        device_quantize=a.device_quantize, device=a.device)


def tomel(argv: Optional[Sequence[str]] = None) -> int:
    """audio -> <file>.png mel spectrogram (cmd/tomel/main.go)."""
    a = _mel_parser("tomel", png_input=False).parse_args(argv)
    if _missing_device("tomel", a.device):
        return 1
    infile, kind = _route_audio_input(a.filename)
    outfile = a.output or a.filename + ".png"
    m = _mel_from_args(a)
    try:
        if kind == "flac":
            m.to_mel_flac(infile, outfile)
        else:
            m.to_mel_wav(infile, outfile)
    except Exception as e:  # reference prints and exits 1
        print(f"Error generating mel spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def towav(argv: Optional[Sequence[str]] = None) -> int:
    """mel PNG -> <file>.wav (cmd/towav/main.go; argv[2] = sample rate)."""
    a = _mel_parser("towav", png_input=True).parse_args(argv)
    if _missing_device("towav", a.device):
        return 1
    outfile = a.output or a.filename + ".wav"
    m = _mel_from_args(a, sample_rate=a.sample_rate)
    try:
        m.to_wav_png(a.filename, outfile, seed=a.seed, momentum=a.gl_momentum)
    except Exception as e:
        print(f"Error generating wave from spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def _phase_parser(prog: str, png_input: bool) -> argparse.ArgumentParser:
    d = PhaseConfig.cli_default()  # single source of the reference CLI params
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("filename",
                   help="PNG file" if png_input else
                   "audio file (.wav/.flac; bare name implies .wav)")
    p.add_argument("--output", "-o", default=None, help="output path")
    p.add_argument("--num-freqs", type=int, default=d.num_freqs)
    p.add_argument("--window", type=int, default=d.window)
    p.add_argument("--resolut", type=int, default=d.resolut)
    p.add_argument("--volume-boost", type=float, default=d.volume_boost)
    p.add_argument("--ihs", action="store_true")
    p.add_argument("--hdr", action="store_true")
    _add_device_flags(p)
    if png_input:
        p.add_argument("--sample-rate", type=int, default=0,
                       help="override output rate (reference fromphase "
                            "documents but never parses this)")
        p.add_argument("--metadata-layout", choices=("auto", "go", "py"),
                       default="auto",
                       help="metadata layout of the input PNG: 'go' 16-byte, "
                            "'py' 12-byte port layout; 'auto' detects")
    return p


def _phase_from_args(a, sample_rate: int = 0) -> Phase:
    return Phase(PhaseConfig(
        num_freqs=a.num_freqs, window=a.window, resolut=a.resolut,
        y_reverse=True, volume_boost=a.volume_boost, ihs=a.ihs, hdr=a.hdr,
        sample_rate=sample_rate),
        device_quantize=a.device_quantize, device=a.device)


def tophase(argv: Optional[Sequence[str]] = None) -> int:
    """audio -> <file>.png phase spectrogram (cmd/tophase/main.go)."""
    a = _phase_parser("tophase", png_input=False).parse_args(argv)
    if _missing_device("tophase", a.device):
        return 1
    infile, kind = _route_audio_input(a.filename)
    outfile = a.output or a.filename + ".png"
    m = _phase_from_args(a)
    try:
        if kind == "flac":
            m.to_phase_flac(infile, outfile)
        else:
            m.to_phase_wav(infile, outfile)
    except Exception as e:  # the reference's message, kept as it is
        print(f"Error generating mel spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def fromphase(argv: Optional[Sequence[str]] = None) -> int:
    """phase PNG -> <file>.wav (cmd/fromphase/main.go)."""
    a = _phase_parser("fromphase", png_input=True).parse_args(argv)
    if _missing_device("fromphase", a.device):
        return 1
    outfile = a.output or a.filename + ".wav"
    m = _phase_from_args(a, sample_rate=a.sample_rate)
    try:
        m.to_wav_png(a.filename, outfile, layout=a.metadata_layout)
    except Exception as e:
        print(f"Error generating wave from spectrogram: {e}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Multiplexed entry: ``python -m gomel_tpu_torch.cli.tools <tool> ...``
    (the batch tools are in cli/batch.py, ``export`` and ``info`` in
    cli/export.py)."""
    from .batch import (batch_fromphase, batch_tomel, batch_tophase,
                        batch_towav)
    from .export import export_tool, info_tool
    argv = list(sys.argv[1:] if argv is None else argv)
    tools = {"tomel": tomel, "towav": towav, "tophase": tophase,
             "fromphase": fromphase, "batch-tomel": batch_tomel,
             "batch-tophase": batch_tophase,
             "batch-fromphase": batch_fromphase, "batch-towav": batch_towav,
             "export": export_tool, "info": info_tool}
    if not argv or argv[0] not in tools:
        print(f"Usage: gomel_tpu_torch.cli.tools {{{','.join(tools)}}} <args>",
              file=sys.stderr)
        return 1
    return tools[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
