"""Batch CLIs: encode and decode whole directories with the batched pipeline.

Counterpart of ``gomel_tpu/cli/batch.py``, with the JAX flags plus
``--device`` (default ``cuda``; without CUDA a tool prints an error and exits
1, and the CPU path runs only when ``--device cpu`` asks for it)::

    python -m gomel_tpu_torch.cli.tools batch-tomel DIR... [--out-dir D]
    python -m gomel_tpu_torch.cli.tools batch-tophase DIR... [--hdr] [--ihs]
    python -m gomel_tpu_torch.cli.tools batch-fromphase PNGDIR... [--out-dir D]
    python -m gomel_tpu_torch.cli.tools batch-towav PNGDIR... [--seed S]

``batch-tomel`` / ``batch-tophase`` decode WAV and FLAC files with the
prefetching dataset loader, group them into length buckets, run the batched
device pipeline and write the PNGs the single-file tools write (each file's
true-length metadata kept). ``batch-fromphase`` / ``batch-towav`` decode PNG
directories back to WAV, one device batch per group of equal (frames, bins)
shape: decode frame counts cannot be padded, since the window-sum
normalisation depends on the true frame count.

Write/dispatch overlap (:class:`_Overlap`): each call's outputs are copied
into pinned host buffers without blocking and an event is recorded; the next
call is dispatched; only then does the host wait on the event and write the
files, so PNG and WAV writing overlaps the next batch on the card.
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.config import (MelConfig, PhaseConfig, num_freqs_for_sample_rate,
                           pad_shift)
from ..core.framing import frames_for_padded, is_padded
from ..io import imagecodec
from ..io.audio import save_wav, save_wav_pcm16
from ..io.dataset import (AudioDataset, list_audio_files, pcm_scale_for,
                          shard_files_for_process)
from ..ops.resample import zero_stuff_upsample
from ..parallel.batch import BatchedMel, BatchedPhase, make_buckets
from .tools import _missing_device


def _stage(result):
    """Start copying a device call's outputs to the host: (host tensors,
    event). CUDA tensors go to pinned buffers without blocking, and the
    event records when the copies are done; CPU tensors pass through."""
    host, event = [], None
    for t in result:
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            host.append(buf)
            event = torch.cuda.Event()
        else:
            host.append(t)
    if event is not None:
        event.record()
    return host, event


class _Overlap:
    """One-deep dispatch/write pipeline for the device-quantize batch loops:
    :meth:`push` stages call i+1's outputs (:func:`_stage`), then writes call
    i's once their copies are done; :meth:`flush` writes the last one. The
    caller dispatches call i+1 before pushing it, so host PNG/WAV I/O
    overlaps the next batch's device work; a ``.cpu()`` instead would wait
    for call i+1 too, on the same stream."""

    def __init__(self):
        self._pending = None

    def push(self, result, writer) -> None:
        staged = _stage(result)
        self.flush()
        self._pending = (staged, writer)

    def flush(self) -> None:
        if self._pending is not None:
            (host, event), writer = self._pending
            self._pending = None
            if event is not None:
                event.synchronize()
            writer(*(t.numpy() for t in host))


# Engine cache: one BatchedMel/BatchedPhase per (config, device), shared
# across invocations in one process. A CLI process uses one, but library
# callers invoking these entry points repeatedly would otherwise rebuild the
# filterbanks and the kernels' host tables each time.
_ENGINES: dict = {}


def _batched_mel(cfg: MelConfig, device: str,
                 gl_momentum: float = 0.0) -> BatchedMel:
    key = ("mel", cfg, str(torch.device(device)), float(gl_momentum))
    if key not in _ENGINES:
        _ENGINES[key] = BatchedMel(cfg, gl_momentum=gl_momentum,
                                   device=device)
    return _ENGINES[key]


def _batched_phase(cfg: PhaseConfig, device: str) -> BatchedPhase:
    key = ("phase", cfg, str(torch.device(device)))
    if key not in _ENGINES:
        _ENGINES[key] = BatchedPhase(cfg, device=device)
    return _ENGINES[key]


def _add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--out-dir", default=None)
    p.add_argument("--process-shard", nargs=2, type=int, default=None,
                   metavar=("INDEX", "COUNT"),
                   help="process only the INDEX-th of every COUNT files "
                        "(strided split, io.dataset.shard_files_for_process)"
                        " — run the same command on COUNT hosts/array jobs "
                        "to split a directory across them")
    p.add_argument("--max-batch", type=int, default=4,
                   help="rows per device call (default 4); a longer batch "
                        "amortises launches and host overhead, a shorter "
                        "one keeps the bucket padding and the memory per "
                        "call small")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")


def _add_devq_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device-quantize", dest="device_quantize",
                   action="store_true", default=True,
                   help="fuse PNG (de)quantization into the batched device "
                        "work (the default: only integer planes cross the "
                        "host boundary; per-row extrema masked to each "
                        "file's true frames; byte-near output)")
    p.add_argument("--host-quantize", dest="device_quantize",
                   action="store_false",
                   help="byte-exact host-side float64 PNG quantization "
                        "(the reference-oracle personality; slower)")


def _apply_shard(files: List[str], a) -> List[str]:
    """Strided per-process split. An EMPTY shard of a non-empty file list is
    a success for array jobs (COUNT may exceed the file count) — signalled
    by returning [] while files was non-empty; the tools print a note and
    exit 0 in that case."""
    if a.process_shard is None:
        return files
    idx, cnt = a.process_shard
    try:
        return shard_files_for_process(files, idx, cnt)
    except ValueError as e:
        print(f"--process-shard: {e}", file=sys.stderr)
        raise SystemExit(2)


def _empty_ok(a) -> int:
    """Exit status for an empty (post-shard) work list."""
    if a.process_shard is not None:
        print("no files in this process shard (ok)", file=sys.stderr)
        return 0
    print("no input files", file=sys.stderr)
    return 1


def _collect(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            files.extend(list_audio_files(p))
        else:
            files.append(p)
    return files


def _collect_pngs(paths: Sequence[str]) -> List[str]:
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, _, names in os.walk(p):
                files.extend(os.path.join(dirpath, n) for n in sorted(names)
                             if n.lower().endswith(".png"))
        else:
            files.append(p)
    return sorted(set(files))


def _out_path(path: str, out_dir: Optional[str], used: Optional[set],
              suffix: str) -> str:
    """``path + suffix``; with --out-dir, basename collisions between inputs
    from different directories are disambiguated (name-1.png, ...)."""
    base = path + suffix
    if not out_dir:
        return base
    os.makedirs(out_dir, exist_ok=True)
    name = os.path.basename(base)
    if used is not None:
        candidate, k = name, 0
        while candidate in used:
            k += 1
            stem, ext = os.path.splitext(name)
            candidate = f"{stem}-{k}{ext}"
        if k:
            print(f"warning: basename collision, writing {candidate}",
                  file=sys.stderr)
        used.add(candidate)
        name = candidate
    return os.path.join(out_dir, name)


def _trim(wave: np.ndarray, samples, hop: int) -> np.ndarray:
    """Cut the reference padding off a decoded wave (mel/mel.go:230-234)."""
    samples_i = int(samples)
    if samples_i > 0 and is_padded(samples_i, len(wave), hop) \
            and len(wave) > samples_i:
        return wave[:samples_i]
    return wave


def _frames_of(bucket, cfg) -> np.ndarray:
    return np.asarray([frames_for_padded(int(n), cfg.window, cfg.resolut)
                       for n in bucket.lengths], np.int32)


def batch_tomel(argv: Optional[Sequence[str]] = None) -> int:
    """Directory/file list -> mel PNGs via the batched pipeline."""
    p = argparse.ArgumentParser(prog="batch-tomel")
    p.add_argument("inputs", nargs="+", help="audio files or directories")
    _add_common_flags(p)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--num-mels", type=int, default=192)
    p.add_argument("--window", type=int, default=1280)
    p.add_argument("--resolut", type=int, default=4096)
    p.add_argument("--fmax", type=float, default=16000.0)
    _add_devq_flag(p)
    a = p.parse_args(argv)
    if _missing_device("batch-tomel", a.device):
        return 1

    cfg = MelConfig(num_mels=a.num_mels, mel_fmax=a.fmax, y_reverse=True,
                    window=a.window, resolut=a.resolut)
    files = _apply_shard(_collect(a.inputs), a)
    if not files:
        return _empty_ok(a)
    ds = AudioDataset(files, mono="go_concat", flac_scaling="mel",
                      num_workers=a.workers, raw_pcm16=a.device_quantize)
    items = [(path, buf, sr) for path, buf, sr in ds]
    bm = _batched_mel(cfg, a.device)
    n_done = 0
    used: set = set()
    # 16-bit streams arrive as raw int16 and go up as int16 with per-row
    # power-of-two scales; deeper streams come as float rows. Each class is
    # bucketed on its own.
    i16_idx = [i for i, (_, buf, _) in enumerate(items)
               if a.device_quantize and buf.dtype == np.int16]
    _i16 = set(i16_idx)
    flt_idx = [i for i in range(len(items)) if i not in _i16]
    ov = _Overlap()

    def _write_mel(img2b, mxb, mnb, *, subset, frames, indices):
        nonlocal n_done
        for row, j in enumerate(indices):
            path, buf, sr = items[subset[j]]
            f = int(frames[row])
            imagecodec.save_mel_image_quantized(
                _out_path(path, a.out_dir, used, ".png"), img2b[row][:, :f],
                float(mxb[row]), float(mnb[row]), cfg.y_reverse,
                float(len(buf)) / f, float(sr))
            n_done += 1

    try:
        for subset, dtype in ((i16_idx, np.int16), (flt_idx, np.float32)):
            if not subset:
                continue
            utts = [items[i][1] for i in subset]
            for bucket in make_buckets(utts, cfg.window,
                                       max_batch=a.max_batch, dtype=dtype):
                frames = _frames_of(bucket, cfg)
                if a.device_quantize:
                    if dtype == np.int16:
                        scales = np.asarray(
                            [pcm_scale_for(items[subset[j]][0],
                                           items[subset[j]][1], "mel")
                             for j in bucket.indices], np.float32)
                        res = bm.encode_quantized(bucket.audio, frames,
                                                  scales=scales)
                    else:
                        res = bm.encode_quantized(bucket.audio, frames)
                    # overlap: write the PREVIOUS bucket while this runs
                    ov.push(res, functools.partial(
                        _write_mel, subset=subset, frames=frames,
                        indices=bucket.indices))
                    continue
                spec_np = bm.encode(bucket.audio).cpu().numpy().astype(
                    np.float64)
                for row, j in enumerate(bucket.indices):
                    path, buf, sr = items[subset[j]]
                    f = int(frames[row])
                    imagecodec.save_mel_image(
                        _out_path(path, a.out_dir, used, ".png"),
                        spec_np[row, :f], cfg.y_reverse,
                        float(len(buf)) / f, float(sr))
                    n_done += 1
    finally:
        # a mid-run failure must not lose the last COMPLETED batch's files
        # (partial-output guarantee for resumable array jobs)
        ov.flush()
    print(f"encoded {n_done} files", file=sys.stderr)
    return 0


def batch_tophase(argv: Optional[Sequence[str]] = None) -> int:
    """Directory/file list -> phase PNGs (files grouped per sample-rate
    family; zero-stuff upsampling applied per file on the host)."""
    p = argparse.ArgumentParser(prog="batch-tophase")
    p.add_argument("inputs", nargs="+", help="audio files or directories")
    _add_common_flags(p)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--window", type=int, default=1280)
    p.add_argument("--resolut", type=int, default=4096)
    p.add_argument("--hdr", action="store_true")
    p.add_argument("--ihs", action="store_true")
    _add_devq_flag(p)
    a = p.parse_args(argv)
    if _missing_device("batch-tophase", a.device):
        return 1

    files = _apply_shard(_collect(a.inputs), a)
    if not files:
        return _empty_ok(a)
    ds = AudioDataset(files, mono="go_concat", flac_scaling="phase",
                      num_workers=a.workers, raw_pcm16=a.device_quantize)
    groups: dict[int, list] = {}
    for path, buf, sr in ds:
        try:
            nf = num_freqs_for_sample_rate(int(sr), hdr=a.hdr)
        except Exception as e:
            print(f"skipping {path}: {e}", file=sys.stderr)
            continue
        zp, zs = pad_shift(int(sr))
        original = len(buf)
        if zp > 0:
            # the host upsample needs floats (the boost multiply overflows
            # int16); zp = 0 int16 rows stay raw for the int16 upload
            if buf.dtype == np.int16:
                buf = buf.astype(np.float64) / 32768.0
            buf = np.asarray(zero_stuff_upsample(buf, zp, zs))
        groups.setdefault(nf, []).append((path, buf, original, sr))

    n_done = 0
    used: set = set()
    ov = _Overlap()

    def _write_phase(img2b, mxb, mnb, *, items, subset, frames, indices, cfg):
        nonlocal n_done
        for row, j in enumerate(indices):
            path, buf, original, sr = items[subset[j]]
            f = int(frames[row])
            imagecodec.save_phase_image_quantized(
                _out_path(path, a.out_dir, used, ".png"), img2b[row][:, :f],
                mxb[row], mnb[row], cfg.y_reverse, float(original) / f,
                float(sr), cfg.hdr, layout="go")
            n_done += 1

    try:
        for nf, items in groups.items():
            cfg = PhaseConfig(num_freqs=nf, window=a.window,
                              resolut=a.resolut, y_reverse=True, ihs=a.ihs,
                              hdr=a.hdr)
            bp = _batched_phase(cfg, a.device)
            i16_idx = [i for i, (_, buf, _, _) in enumerate(items)
                       if buf.dtype == np.int16]
            _i16 = set(i16_idx)
            flt_idx = [i for i in range(len(items)) if i not in _i16]
            for subset, dtype in ((i16_idx, np.int16), (flt_idx, np.float32)):
                if not subset:
                    continue
                utts = [items[i][1] for i in subset]
                for bucket in make_buckets(utts, cfg.window,
                                           max_batch=a.max_batch, dtype=dtype):
                    frames = _frames_of(bucket, cfg)
                    if a.device_quantize:
                        res = bp.encode_quantized(bucket.audio, frames)
                        # overlap: write the PREVIOUS bucket while this runs
                        ov.push(res, functools.partial(
                            _write_phase, items=items, subset=subset,
                            frames=frames, indices=bucket.indices, cfg=cfg))
                        continue
                    spec_np = bp.encode(bucket.audio).cpu().numpy().astype(
                        np.float64)
                    for row, j in enumerate(bucket.indices):
                        path, buf, original, sr = items[subset[j]]
                        f = int(frames[row])
                        # samples_in_mel uses the PRE-upsample length (Go
                        # semantics, phase/phase.go:202-215)
                        imagecodec.save_phase_image(
                            _out_path(path, a.out_dir, used, ".png"),
                            spec_np[row, :f], cfg.y_reverse,
                            float(original) / f, float(sr), cfg.ihs_passes,
                            cfg.hdr, layout="go")
                        n_done += 1
    finally:
        ov.flush()  # keep the last completed batch on a mid-run failure
    print(f"encoded {n_done} files", file=sys.stderr)
    return 0


def batch_fromphase(argv: Optional[Sequence[str]] = None) -> int:
    """Phase-PNG directory/file list -> WAVs via the batched decoder."""
    p = argparse.ArgumentParser(prog="batch-fromphase")
    p.add_argument("inputs", nargs="+", help="phase PNG files or directories")
    _add_common_flags(p)
    p.add_argument("--window", type=int, default=1280)
    p.add_argument("--resolut", type=int, default=4096)
    p.add_argument("--volume-boost", type=float, default=0.0)
    p.add_argument("--ihs", action="store_true")
    p.add_argument("--hdr", action="store_true")
    p.add_argument("--metadata-layout", choices=("auto", "go", "py"),
                   default="auto",
                   help="metadata layout of the input PNGs: 'go' 16-byte, "
                        "'py' 12-byte port layout; 'auto' detects")
    _add_devq_flag(p)
    a = p.parse_args(argv)
    if _missing_device("batch-fromphase", a.device):
        return 1

    files = _apply_shard(_collect_pngs(a.inputs), a)
    if not files:
        return _empty_ok(a)
    ihs_passes = 2 if (a.ihs and not a.hdr) else 0
    groups: dict[tuple, list] = {}
    for path in files:
        try:
            if a.device_quantize:
                planes, maxs, mins, samples, sr, nf = \
                    imagecodec.load_phase_image_raw(
                        path, True, a.hdr, layout=a.metadata_layout)
                groups.setdefault((nf, planes.shape[1]), []).append(
                    (path, (planes, maxs, mins), samples, sr))
            else:
                spec, samples, sr, nf = imagecodec.load_phase_image(
                    path, True, ihs_passes, a.hdr, layout=a.metadata_layout)
                groups.setdefault((nf, spec.shape[0]), []).append(
                    (path, spec, samples, sr))
        except Exception as e:
            print(f"skipping {path}: {e}", file=sys.stderr)
            continue

    n_done = 0
    used: set = set()
    ov = _Overlap()

    def _write_wavs(wavs, finite_rows, *, chunk, cfg):
        nonlocal n_done
        for row, (path, _, samples, sr) in enumerate(chunk):
            if not finite_rows[row]:
                # per-row flag: one bad PNG skips that file only
                print(f"skipping {path}: audio contains NaN/Inf samples",
                      file=sys.stderr)
                continue
            save_wav_pcm16(_out_path(path, a.out_dir, used, ".wav"),
                           _trim(wavs[row], samples, cfg.window),
                           cfg.family_main_rate)
            n_done += 1

    try:
        for (nf, _), items in groups.items():
            cfg = PhaseConfig(num_freqs=nf, window=a.window,
                              resolut=a.resolut, y_reverse=True,
                              volume_boost=a.volume_boost, ihs=a.ihs,
                              hdr=a.hdr)
            bp = _batched_phase(cfg, a.device)
            for s in range(0, len(items), a.max_batch):
                chunk = items[s:s + a.max_batch]
                if a.device_quantize:
                    res = bp.decode_quantized(
                        np.stack([q[0] for _, q, _, _ in chunk]),
                        np.stack([q[1] for _, q, _, _ in chunk]),
                        np.stack([q[2] for _, q, _, _ in chunk]),
                        pcm16=True)
                    # overlap: write the PREVIOUS chunk while this decodes
                    ov.push(res, functools.partial(_write_wavs, chunk=chunk,
                                                   cfg=cfg))
                    continue
                batch = np.stack([spec for _, spec, _, _ in chunk])
                wavs = bp.decode(batch).cpu().numpy().astype(np.float64)
                for row, (path, _, samples, sr) in enumerate(chunk):
                    save_wav(_out_path(path, a.out_dir, used, ".wav"),
                             _trim(wavs[row], samples, cfg.window),
                             cfg.family_main_rate)
                    n_done += 1
    finally:
        ov.flush()  # keep the last completed chunk on a mid-run failure
    print(f"decoded {n_done} files", file=sys.stderr)
    return 0


def batch_towav(argv: Optional[Sequence[str]] = None) -> int:
    """Mel-PNG directory/file list -> WAVs via the batched Griffin-Lim
    decoder (row r of each chunk starts from the key
    parallel.batch.row_keys(seed)[r], the JAX package's, deterministic per
    --seed)."""
    p = argparse.ArgumentParser(prog="batch-towav")
    p.add_argument("inputs", nargs="+", help="mel PNG files or directories")
    _add_common_flags(p)
    p.add_argument("--sample-rate", type=int, default=44100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-mels", type=int, default=192)
    p.add_argument("--window", type=int, default=1280)
    p.add_argument("--resolut", type=int, default=4096)
    p.add_argument("--fmax", type=float, default=16000.0)
    p.add_argument("--griffin-lim-iterations", type=int, default=2)
    p.add_argument("--gl-momentum", type=float, default=0.0,
                   help="fast-Griffin-Lim momentum (0 = reference "
                        "behaviour); ops/griffinlim.recommended_gl gives the "
                        "JAX package's measured equal-quality pairs, e.g. "
                        "0.99 at 24 iterations for plain 64")
    p.add_argument("--volume-boost", type=float, default=0.0)
    _add_devq_flag(p)
    a = p.parse_args(argv)
    if _missing_device("batch-towav", a.device):
        return 1

    files = _apply_shard(_collect_pngs(a.inputs), a)
    if not files:
        return _empty_ok(a)
    cfg = MelConfig(num_mels=a.num_mels, mel_fmax=a.fmax, y_reverse=True,
                    window=a.window, resolut=a.resolut,
                    griffin_lim_iterations=a.griffin_lim_iterations)
    groups: dict[int, list] = {}
    for path in files:
        try:
            if a.device_quantize:
                planes, mx, mn, samples, sr = imagecodec.load_mel_image_raw(
                    path, True)
                if planes.shape[0] != cfg.num_mels:
                    print(f"skipping {path}: {planes.shape[0]} mels != "
                          f"{cfg.num_mels}", file=sys.stderr)
                    continue
                groups.setdefault(planes.shape[1], []).append(
                    (path, (planes, mx, mn), samples, sr))
                continue
            spec, samples, sr = imagecodec.load_mel_image(path, True)
        except Exception as e:
            print(f"skipping {path}: {e}", file=sys.stderr)
            continue
        if spec.shape[1] != cfg.num_mels:
            print(f"skipping {path}: {spec.shape[1]} mels != {cfg.num_mels}",
                  file=sys.stderr)
            continue
        if a.volume_boost != 0.0:
            spec = spec + a.volume_boost
        groups.setdefault(spec.shape[0], []).append((path, spec, samples, sr))

    n_done = 0
    used: set = set()
    bm = _batched_mel(cfg, a.device, gl_momentum=a.gl_momentum)
    ov = _Overlap()

    def _write_wavs(wavs, finite_rows, *, chunk):
        nonlocal n_done
        for row, (path, _, samples, sr) in enumerate(chunk):
            if not finite_rows[row]:
                print(f"skipping {path}: audio contains NaN/Inf samples",
                      file=sys.stderr)
                continue
            out_sr = a.sample_rate if a.sample_rate else int(sr)
            save_wav_pcm16(_out_path(path, a.out_dir, used, ".wav"),
                           _trim(wavs[row], samples, cfg.window), out_sr)
            n_done += 1

    try:
        for _, items in groups.items():
            for s in range(0, len(items), a.max_batch):
                chunk = items[s:s + a.max_batch]
                if a.device_quantize:
                    res = bm.decode_quantized(
                        np.stack([q[0] for _, q, _, _ in chunk]),
                        np.asarray([q[1] for _, q, _, _ in chunk]),
                        np.asarray([q[2] for _, q, _, _ in chunk]),
                        seed=a.seed, boost=a.volume_boost, pcm16=True)
                    # overlap: write the PREVIOUS chunk while this decodes
                    ov.push(res, functools.partial(_write_wavs, chunk=chunk))
                    continue
                batch = np.stack([spec for _, spec, _, _ in chunk])
                wavs = bm.decode(batch, seed=a.seed).cpu().numpy().astype(
                    np.float64)
                for row, (path, _, samples, sr) in enumerate(chunk):
                    out_sr = a.sample_rate if a.sample_rate else int(sr)
                    save_wav(_out_path(path, a.out_dir, used, ".wav"),
                             _trim(wavs[row], samples, cfg.window), out_sr)
                    n_done += 1
    finally:
        ov.flush()  # keep the last completed chunk on a mid-run failure
    print(f"decoded {n_done} files", file=sys.stderr)
    return 0
