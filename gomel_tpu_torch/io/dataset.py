"""Prefetching audio dataset loader — host ingest for batched pipelines.

Copy of ``gomel_tpu/io/dataset.py`` without the mesh (``shard_files_for_group``
waits for the multi-process slice): the port cannot import ``gomel_tpu``,
whose package __init__ imports JAX. tests/test_torch_host.py pins the copy to
the original.

The reference processes one file per CLI invocation; a batched pipeline
needs host-side decode (WAV/FLAC -> float buffers) overlapped with device
compute. This loader decodes files in a background thread pool and yields
buffers for parallel.batch.BatchedMel/Phase, so the card does not wait on
the filesystem.

Single-writer design: one background producer pool, one consumer (the
training/serving loop) — consistent with the repo's host-threading policy
(SURVEY.md §5: keep host code single-writer).
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from ..core.config import GomelError
from . import audio as audio_io

AUDIO_EXTENSIONS = (".wav", ".flac")


def list_audio_files(root: str, recursive: bool = True) -> List[str]:
    """Enumerate .wav/.flac files under ``root`` (sorted, deterministic)."""
    out: List[str] = []
    if recursive:
        for dirpath, _, names in os.walk(root):
            out.extend(os.path.join(dirpath, n) for n in names
                       if n.lower().endswith(AUDIO_EXTENSIONS))
    else:
        out = [os.path.join(root, n) for n in os.listdir(root)
               if n.lower().endswith(AUDIO_EXTENSIONS)]
    return sorted(out)


def shard_files_for_process(files: Sequence[str], process_index: int = 0,
                            process_count: int = 1) -> List[str]:
    """Per-process file shard for multi-host ingest: process ``p`` takes
    files ``p, p+P, p+2P, ...`` (stride = process count), which keeps the
    per-process counts within one file of each other. The index and count
    are explicit (``--process-shard INDEX COUNT`` on the batch CLIs); the
    default, rank 0 of 1, is the identity."""
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} not in "
                         f"[0, {process_count})")
    return list(files[process_index::process_count])


def load_audio(path: str, mono: str = "left",
               flac_scaling: str = "phase",
               raw_pcm16: bool = False) -> tuple[np.ndarray, int]:
    """Decode one file by extension (WAV via the in-tree io/wavcodec.py,
    FLAC via the native decoder).

    ``raw_pcm16=True`` returns RAW int16 samples for 16-bit streams (the
    device-quantize pipelines convert on device; the scale divisor is
    derivable from dtype + extension + ``flac_scaling``) and falls back to
    the float decode otherwise."""
    if path.lower().endswith(".flac"):
        return audio_io.load_flac_any(path, mono=mono,
                                      scaling=flac_scaling,
                                      raw_pcm16=raw_pcm16)
    return audio_io.load_wav_any(path, mono=mono, raw_pcm16=raw_pcm16)


def pcm_scale_for(path: str, buf: np.ndarray,
                  flac_scaling: str = "phase") -> float | None:
    """Scale divisor for a raw int16 buffer from :func:`load_audio`
    (None for already-scaled float buffers): 32768 for WAV/phase-FLAC,
    65536 for mel-scaled FLAC (mel/impl.go:290)."""
    if buf.dtype != np.int16:
        return None
    if path.lower().endswith(".flac") and flac_scaling == "mel":
        return 65536.0
    return 32768.0


class AudioDataset:
    """Prefetching iterator over decoded audio buffers.

    Yields ``(path, buffer, sample_rate)`` in input order; decoding runs in
    ``num_workers`` background threads with a bounded prefetch queue.
    Decode failures are reported per file (skip or raise via ``on_error``).
    """

    def __init__(self, files: Sequence[str], mono: str = "left",
                 flac_scaling: str = "phase", num_workers: int = 2,
                 prefetch: int = 8, on_error: str = "skip",
                 transform: Optional[Callable] = None,
                 raw_pcm16: bool = False):
        if on_error not in ("skip", "raise"):
            raise ValueError("on_error must be 'skip' or 'raise'")
        self.files = list(files)
        self.mono = mono
        self.flac_scaling = flac_scaling
        # raw_pcm16: yield int16 buffers for 16-bit streams (float
        # fallback otherwise) — see load_audio / pcm_scale_for
        self.raw_pcm16 = raw_pcm16
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.on_error = on_error
        self.transform = transform

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self) -> Iterator[tuple[str, np.ndarray, int]]:
        # ordered hand-off: worker w decodes files w, w+W, w+2W, ...; the
        # consumer pops per-slot queues round-robin to preserve input order.
        slots = [queue.Queue(maxsize=self.prefetch) for _ in range(self.num_workers)]
        stop = threading.Event()

        def worker(w: int):
            for idx in range(w, len(self.files), self.num_workers):
                if stop.is_set():
                    return
                path = self.files[idx]
                try:
                    buf, sr = load_audio(path, self.mono,
                                         self.flac_scaling,
                                         raw_pcm16=self.raw_pcm16)
                    if self.transform is not None:
                        buf = self.transform(buf, sr)
                    item = (idx, path, buf, sr, None)
                except Exception as e:  # propagate to consumer thread
                    item = (idx, path, None, 0, e)
                slots[w].put(item)
            slots[w].put(None)  # sentinel

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        done = [False] * self.num_workers
        try:
            i = 0
            while not all(done):
                w = i % self.num_workers
                i += 1
                if done[w]:
                    continue
                item = slots[w].get()
                if item is None:
                    done[w] = True
                    continue
                _, path, buf, sr, err = item
                if err is not None:
                    if self.on_error == "raise":
                        raise GomelError(f"failed to load {path!r}") from err
                    continue
                yield path, buf, sr
        finally:
            stop.set()
            # drain so workers blocked on put() can exit
            for s in slots:
                while True:
                    try:
                        s.get_nowait()
                    except queue.Empty:
                        break


def batched_buffers(dataset: AudioDataset, batch_size: int
                    ) -> Iterator[List[tuple[str, np.ndarray, int]]]:
    """Group dataset items into lists of ``batch_size`` (last may be short)."""
    batch: List[tuple[str, np.ndarray, int]] = []
    for item in dataset:
        batch.append(item)
        if len(batch) == batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
