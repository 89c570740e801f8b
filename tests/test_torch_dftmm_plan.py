"""The matmul DFT kernels KN and KO (csrc/dft_mm.cu), replayed on the CPU.

No CUDA kernel runs here, so this file replays the kernels' index
arithmetic in numpy: the host weight layout (``dft_mm._kernel_layout``: KN's
interleaved columns, KO's re block then im block with its zero padding, the
bf16 contraction's permutation within each 16), the producer's copies of the
A operand into the swizzled stage (16-byte copies where every row base is
aligned, 4-byte copies where not; the ragged edges zero-filled), the
consumers' reads of it (the wgmma register fragment in the bf16 mode, the
8 x 8 micro-tile in the float32 mode), the stage partition with its
promotion of each 64-deep stage into a float32 sum, the accumulator
fragments' rows and columns, the persistent tile order and the stores'
bounds, and the shared-memory footprint of each configuration. The replays
are held to the float64 masters (``_fwd_np``, ``_inv_np``, ``_fold_*``)
and to ``frame_signal``'s samples. The kernel's constants are read from the
source. No JAX.
"""
import functools
import os
import re

import numpy as np
import pytest
import torch

from gomel_tpu_torch.ops import _cuda, dft_mm
from gomel_tpu_torch.ops.stft import frame_signal, hann_window

SIZES = [2, 64, 512, 3000, 4096, 8192]
EPILOGUES = ["planes", "mag", "pairs", "project"]
SMS = 132                        # SMs of an H100 SXM: the persistent grid


def _constants() -> dict[str, int]:
    with open(os.path.join(_cuda.CSRC_DIR, "dft_mm.cu")) as f:
        text = f.read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


K = _constants()
TILE_M, TILE_N = K["kTileM"], K["kTileN"]
PRODUCERS, CONSUMERS = K["kProducers"], K["kConsumers"]


def test_constants_match_the_wrapper():
    """The wrapper lays the weights out for the kernel's tile, stage depths
    and promotion depth."""
    assert TILE_M == TILE_N == dft_mm.TILE == PRODUCERS == 128
    assert K["kDepth16"] == dft_mm.DEPTH["bf16"] == 64
    assert K["kDepth32"] == dft_mm.DEPTH["f32"] == 32
    assert K["kPromote"] == dft_mm.PROMOTE == 64
    assert CONSUMERS == 256 and K["kSmemLimit"] == 232_448


def _stages(depth: int, a_bytes: int, b_bytes: int,
            out_bytes: int) -> tuple[int, int]:
    """Config<kBf16, TA>: (stages, dynamic shared memory bytes)."""
    stage = TILE_M * depth * a_bytes + TILE_N * depth * b_bytes
    stages = min(8, (K["kSmemLimit"] - out_bytes - 3072) // stage)
    return stages, (stages * stage + 16 * stages + 8 * TILE_M + out_bytes
                    + 1024)


@pytest.mark.parametrize("mode,a_bytes,want", [
    ("bf16", 4, 4), ("bf16", 2, 6), ("f32", 4, 7)])
def test_shared_memory_fits(mode, a_bytes, want):
    """Every configuration's ring fits 227 KB with its barriers, row bases,
    the bf16 mode's epilogue tile (two bf16 planes of 128 x 64 bins) and
    1024-byte alignment slack, and keeps at least 4 stages in flight."""
    depth = dft_mm.DEPTH[mode]
    out = 2 * TILE_M * TILE_N if mode == "bf16" else 0
    stages, smem = _stages(depth, a_bytes, 2 if mode == "bf16" else 4, out)
    assert stages == want
    assert smem <= 232_448
    # the B stages sit first, 1024-byte aligned, for the 128-byte swizzle
    assert (TILE_N * depth * 2) % 1024 == 0


# -- the host layout ----------------------------------------------------------

def _natural(layout: np.ndarray, bf16: bool) -> np.ndarray:
    """The layout as [depth, cols], the bf16 permutation undone."""
    if not bf16:
        return layout
    cols, depth = layout.shape
    inv = np.argsort(dft_mm.PERM16)
    return layout.reshape(cols, depth // 16, 16)[:, :, inv].reshape(
        cols, depth).T


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("n", SIZES)
def test_layout_holds_the_master(n, direction, bf16):
    """KN: column 2j is cos of bin j, 2j + 1 is -sin, the samples in order;
    KO: rows 0..n/2 of the contraction are the re weights, rows kh.. the im
    weights (zero at DC and Nyquist); everything else zero, the depth a
    multiple of the stage, the columns of the tile; the bf16 mode
    [cols, depth] with each 16 of the contraction permuted so the register
    fragment's k = 2t, 2t+1, 2t+8, 2t+9 hold samples 4t..4t+3."""
    half = n // 2 + 1
    window = hann_window(n) if n > 2 else None
    master = dft_mm._master(direction, n, window)
    lay = dft_mm._kernel_layout(direction, master, n, bf16)
    nat = _natural(lay, bf16)
    depth, cols = nat.shape
    d = dft_mm.DEPTH["bf16" if bf16 else "f32"]
    assert depth % d == 0 and cols % TILE_N == 0
    m32 = master.astype(np.float32)
    want = np.zeros_like(nat)
    if direction == "fwd":
        assert depth == -(-n // d) * d and cols >= 2 * half
        want[:n, 0:2 * half:2] = m32[:, :half]
        want[:n, 1:2 * half:2] = m32[:, half:]
    else:
        kh = depth // 2
        assert kh % d == 0 and kh >= half and cols >= n
        want[:half, :n] = m32[:half]
        want[kh:kh + half, :n] = m32[half:]
        assert not want[kh, :].any() and not want[kh + half - 1, :].any()
    assert np.array_equal(nat, want)
    if bf16:
        p = np.arange(16)
        t, h, q = (p % 8) // 2, p % 2, p // 8
        np.testing.assert_array_equal(dft_mm.PERM16, 4 * t + 2 * q + h)


# -- the producer's copies and the consumers' reads ---------------------------

def a_chunk(r, c, elem: int):
    """a_chunk<TA>: where A's 16-byte chunk c of row r lies in its stage."""
    return c ^ ((r & 1) << 2) if elem == 4 else c ^ ((r & 3) << 1)


def load_a(src: np.ndarray, rowbase: np.ndarray, koff: int, extent: int,
           depth: int, elem: int, vec: bool) -> np.ndarray:
    """The stage [128, depth] that load_a's copies leave: producer thread p
    copies chunk p % chunks of rows p // chunks + i * (128 / chunks); the
    chunk's valid elements (none past the extent or for a row past the
    last) and zeros after them. Every element is written exactly once."""
    per = 16 // elem
    chunks = depth // per
    step = PRODUCERS // chunks
    p = np.arange(PRODUCERS)
    c = (p % chunks)[:, None]
    r = (p // chunks)[:, None] + step * np.arange(chunks)[None, :]
    c = np.broadcast_to(c, r.shape)
    e0 = koff + c * per
    valid = np.clip(extent - e0, 0, per)
    rb = rowbase[r]
    v = np.where(rb < 0, 0, valid)
    if vec:   # cp.async.cg: a 16-byte aligned source, or nothing read
        assert np.all(((rb + e0) % per == 0) | (v == 0))
    e = np.arange(per)
    idx = (rb + e0)[..., None] + e
    live = e < v[..., None]
    vals = np.where(live, src[np.where(live, idx, 0)], 0.0)
    stage = np.zeros((TILE_M, depth))
    count = np.zeros((TILE_M, depth), int)
    col = (a_chunk(r, c, elem) * per)[..., None] + e
    np.add.at(stage, (np.broadcast_to(r[..., None], col.shape), col), vals)
    np.add.at(count, (np.broadcast_to(r[..., None], col.shape), col), 1)
    assert np.all(count == 1)
    return stage


@functools.lru_cache(maxsize=None)
def _wgmma_reads(elem: int) -> np.ndarray:
    """a_frag's map: the stage column [128 rows, 64 fragment k positions]
    each register of the two warpgroups' wgmma fragments reads (4 k-steps
    of 16); every stage element is read exactly once."""
    src = np.full((TILE_M, 64), -1)
    reads = np.zeros((TILE_M, 64), int)
    for warp in range(CONSUMERS // 32):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            r = warp * 16 + g
            for j in range(4):
                if elem == 4:
                    off = a_chunk(r, 4 * j + t, 4) * 4
                else:
                    off = a_chunk(r, 2 * j + (t >> 1), 2) * 8 + (t & 1) * 4
                for rr in (r, r + 8):
                    reads[rr, off:off + 4] += 1
                    # a[0]/a[1]: k 2t, 2t+1; a[2]/a[3]: k 2t+8, 2t+9
                    src[rr, 16 * j + 2 * t:16 * j + 2 * t + 2] = \
                        [off, off + 1]
                    src[rr, 16 * j + 8 + 2 * t:16 * j + 10 + 2 * t] = \
                        [off + 2, off + 3]
    assert np.all(reads == 1) and np.all(src >= 0)
    return src


@functools.lru_cache(maxsize=None)
def _simt_reads() -> np.ndarray:
    """fma_stage's map: the stage column [128 rows, 32 k] each micro-tile
    register reads, k in order."""
    src = np.full((TILE_M, 32), -1)
    for ty in range(16):
        for q in range(8):
            for i in range(8):
                r = ty * 8 + i
                c = q ^ ((i & 1) << 2)
                assert c == a_chunk(r, q, 4)
                src[r, 4 * q:4 * q + 4] = range(4 * c, 4 * c + 4)
    assert np.all(np.sort(src, axis=1) == np.arange(32))
    return src


def wgmma_a(stage: np.ndarray, elem: int) -> np.ndarray:
    """The 64-deep stage as the wgmma fragments see it."""
    return np.take_along_axis(stage, _wgmma_reads(elem), axis=1)


def simt_a(stage: np.ndarray) -> np.ndarray:
    """The 32-deep float32 stage as the micro-tiles read it, in k order."""
    return np.take_along_axis(stage, _simt_reads(), axis=1)


def frame_rowbase(rows0: int, rows: int, frames: int, length: int, hop: int):
    """FrameOperand::row for the tile at rows0: -1 past the last row."""
    r = rows0 + np.arange(TILE_M)
    b = r // frames
    return np.where(r < rows, b * length + (r - b * frames) * hop, -1)


def plane_rowbase(rows0: int, rows: int, ld: int):
    r = rows0 + np.arange(TILE_M)
    return np.where(r < rows, r * ld, -1)


def replay_a(direction: str, src, rowbase, n: int, depth: int, bf16: bool,
             elem: int = 4, vec: bool = True) -> np.ndarray:
    """A [128, depth] of one row tile in the layout's contraction order
    (the bf16 fragment positions, or k order), through every stage's copies
    and reads. KN reads one signal; KO reads the re plane for the first
    half of the contraction, the im plane for the second."""
    d = dft_mm.DEPTH["bf16" if bf16 else "f32"]
    half = n // 2 + 1
    out = np.zeros((TILE_M, depth))
    for k0 in range(0, depth, d):
        if direction == "fwd":
            plane, koff, extent = src, k0, n
        else:
            kh = depth // 2
            plane = src[0] if k0 < kh else src[1]
            koff, extent = (k0 if k0 < kh else k0 - kh), half
        stage = load_a(plane, rowbase, koff, extent, d, elem, vec)
        out[:, k0:k0 + d] = wgmma_a(stage, elem) if bf16 else simt_a(stage)
    return out


def _b_natural_order(layout: np.ndarray, bf16: bool) -> np.ndarray:
    """B as the kernel contracts it: [depth, cols], the bf16 layout in its
    permuted order, as TMA copies it and wgmma reads it."""
    return layout.T if bf16 else layout


def _signal(n: int, hop: int, lead: int, frames: int, extra: int, seed=0):
    rng = np.random.default_rng(seed + n)
    length = n + (frames - 1) * hop + extra
    return rng.standard_normal((lead, length)), length


@pytest.mark.parametrize("extra", [0, 1, 2, 3])
@pytest.mark.parametrize("framed", [True, False])
@pytest.mark.parametrize("n", [64, 512, 3000])
def test_gather_reads_the_frames(n, framed, extra):
    """KN's A at row bases of every alignment (length % 4 from 0 to 3; hop
    = n, framed input, and hop < n): the 16-byte route wherever every row
    base is aligned (the kernel's test: length % 4 == hop % 4 == 0), the
    4-byte route elsewhere; either reads exactly frame_signal's samples,
    zeros past n and past the last row."""
    hop = n if framed else max(1, n // 4 + 3)
    frames = 3 if n > 512 else 70
    x, length = _signal(n, hop, 2, frames, extra)
    frames = (length - n) // hop + 1
    rows = 2 * frames
    want = frame_signal(torch.from_numpy(x), n, hop).reshape(rows, n).numpy()
    vec = length % 4 == 0 and hop % 4 == 0
    depth = -(-n // 64) * 64
    for rows0 in range(0, rows, TILE_M):
        rb = frame_rowbase(rows0, rows, frames, length, hop)
        got = replay_a("fwd", x.reshape(-1), rb, n, depth, False, 4, vec)
        live = min(TILE_M, rows - rows0)
        # the float32 stages read in k order: the frames' samples
        np.testing.assert_array_equal(got[:live, :n],
                                      want[rows0:rows0 + live])
        assert not got[:live, n:].any() and not got[live:].any()
        if not vec:   # the 4-byte route reads the same values
            got4 = replay_a("fwd", x.reshape(-1), rb, n, depth, False, 4,
                            False)
            np.testing.assert_array_equal(got, got4)


def signal_bf16(x: np.ndarray) -> tuple[np.ndarray, int]:
    """signal_bf16_kernel: each row of x in bf16 (round to nearest even),
    padded with zeros to ld, a multiple of 8 samples (16 bytes)."""
    batch, length = x.shape
    ld = -(-length // 8) * 8
    out = np.zeros((batch, ld))
    out[:, :length] = _round_bf16(x)
    return out, ld


@pytest.mark.parametrize("extra", [0, 1, 3, 5, 7])
@pytest.mark.parametrize("n,hop", [(64, 16), (512, 512), (3000, 1280),
                                   (4096, 1280)])
def test_bf16_signal_gather(n, hop, extra):
    """KN's bf16 mode at hop % 8 == 0 reads the bf16 copy of the signal in
    rows of ld (16-byte aligned, whatever the length): 16-byte copies of 8
    samples into the bf16 stage, and the wgmma fragments see exactly what the
    float32 route sees after its rounding in registers: the rounded frames,
    zeros past n and past the last row."""
    frames = 3 if n > 512 else 20
    x, length = _signal(n, hop, 2, frames, extra)
    frames = (length - n) // hop + 1
    rows = 2 * frames
    low, ld = signal_bf16(x)
    depth = -(-n // 64) * 64
    rounded = _round_bf16(x)
    perm = np.concatenate([16 * b + dft_mm.PERM16 for b in range(depth // 16)])
    want = np.zeros((rows, depth))
    want[:, :n] = frame_signal(torch.from_numpy(rounded), n, hop).reshape(
        rows, n).numpy()
    for rows0 in range(0, rows, TILE_M):
        got = replay_a("fwd", low.reshape(-1), frame_rowbase(
            rows0, rows, frames, ld, hop), n, depth, True, 2, True)
        via32 = replay_a("fwd", rounded.reshape(-1), frame_rowbase(
            rows0, rows, frames, length, hop), n, depth, True, 4,
            length % 4 == 0)
        np.testing.assert_array_equal(got, via32)
        live = min(TILE_M, rows - rows0)
        # fragment position p of each 16 holds sample PERM16[p]
        np.testing.assert_array_equal(got[:live],
                                      want[rows0:rows0 + live][:, perm])
        assert not got[live:].any()


# -- the product, with the promotion ------------------------------------------

def _trunc32(x: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero (the tensor cores' adds)."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def promoted(a: np.ndarray, b: np.ndarray, bf16: bool) -> np.ndarray:
    """mma_stage's sum of a [R, K] x b [K, C]: the bf16 mode adds each
    k-step (16) into a fresh float32 accumulator with truncation, and folds
    each PROMOTE-deep slice into the running sum with a rounded float32 add;
    the float32 mode is a chain of rounded multiply-adds in k order."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    if not bf16:
        for k in range(a.shape[1]):
            acc = (acc.astype(np.float64) + np.outer(a[:, k], b[k])).astype(
                np.float32)
        return acc
    step = dft_mm.PROMOTE
    for k0 in range(0, a.shape[1], step):
        part = np.zeros_like(acc)
        for j in range(k0, k0 + step, 16):
            part = _trunc32(part.astype(np.float64)
                            + a[:, j:j + 16] @ b[j:j + 16])
        acc = (acc.astype(np.float64) + part).astype(np.float32)
    return acc


def _round_bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)


def _fwd_replay(n: int, x: np.ndarray, length: int, hop: int, frames: int,
                bf16: bool, round_operands: bool):
    """KN through the replayed copies, reads and promotion: [rows, 2h]
    accumulators (re, im interleaved), and the float64 reference product
    of the same operands."""
    window = hann_window(n) if n > 2 else None
    master = dft_mm._master("fwd", n, window)
    lay = dft_mm._kernel_layout("fwd", master, n, bf16)
    b = _b_natural_order(lay, bf16)
    rows, half = x.shape[0] * frames, n // 2 + 1
    vec = length % 4 == 0 and hop % 4 == 0
    a = np.concatenate([replay_a("fwd", x.reshape(-1), frame_rowbase(
        r0, rows, frames, length, hop), n, b.shape[0], bf16, 4, vec)
        for r0 in range(0, rows, TILE_M)])[:rows]
    if round_operands:
        a, b = _round_bf16(a), _round_bf16(b)
    frames_ = frame_signal(torch.from_numpy(x), n, hop).reshape(rows, n)
    m = master.astype(np.float32).astype(np.float64)
    if round_operands:
        frames_, m = _round_bf16(frames_.numpy()), _round_bf16(m)
    ref = np.asarray(frames_) @ m
    got = promoted(a, b.astype(np.float64), bf16)[:, :2 * half]
    return got[:, 0::2], got[:, 1::2], ref[:, :half], ref[:, half:]


def _peak_err(got, want):
    peak = np.abs(want).max(axis=-1, keepdims=True)
    return float((np.abs(got - want) / np.maximum(peak, 1e-300)).max())


@pytest.mark.parametrize("epilogue", EPILOGUES)
@pytest.mark.parametrize("n", SIZES)
def test_forward_replay_matches_float64(n, epilogue):
    """KN's bf16 mode through the replayed stages with float32 operands:
    every epilogue within 1e-5 of each frame's peak of float64 (the
    promotion keeps the truncating accumulators' bias down); with the
    operands rounded to bf16, within 2e-5 of the float64 product of the
    rounded operands (the bf16-operand plain version's bound)."""
    hop = max(1, n // 3)
    frames = 3 if n >= 4096 else 5
    x, length = _signal(n, hop, 2, frames, 1)
    frames = (length - n) // hop + 1
    re, im, rre, rim = _fwd_replay(n, x, length, hop, frames, True, False)
    mag = np.random.default_rng(n).random(re.shape) * 3
    first, count = 1 % (n // 2 + 1), max(1, n // 3)

    def epi(r, i):
        if epilogue == "mag":
            return (np.hypot(r, i),)
        if epilogue == "pairs":
            return (np.stack([i[:, first:first + count],
                              r[:, first:first + count]], -1).reshape(
                                  r.shape[0], -1),)
        if epilogue == "project":
            out = dft_mm.unit_project(*(torch.from_numpy(v) for v in (
                r, i, mag)))
            return tuple(o.numpy() for o in out)
        return r, i

    peak = np.hypot(rre, rim).max(axis=-1, keepdims=True)
    for g, w in zip(epi(re, im), epi(rre, rim)):
        if epilogue == "project":   # unit phase: relative L2 a frame
            rel = np.linalg.norm(g - w, axis=-1) / np.linalg.norm(w, axis=-1)
            assert rel.max() <= 1e-4, rel.max()
        else:
            err = np.abs(g - w).max(axis=-1, keepdims=True) / peak
            assert err.max() <= 1e-5, err.max()
    if n <= 4096:
        re, im, rre, rim = _fwd_replay(n, x, length, hop, frames, True, True)
        peak = np.hypot(rre, rim).max(axis=-1, keepdims=True)
        err = np.maximum(np.abs(re - rre), np.abs(im - rim)) / peak
        assert err.max() <= 2e-5, err.max()


@pytest.mark.parametrize("n", [64, 512, 3000])
def test_forward_float32_mode_replay(n):
    """KN's float32 mode through its 32-deep stages and micro-tile reads:
    within 1e-5 of each frame's peak of float64."""
    hop = n // 4
    x, length = _signal(n, hop, 1, 4, 2)
    re, im, rre, rim = _fwd_replay(n, x, length, hop, (length - n) // hop + 1,
                                   False, False)
    peak = np.hypot(rre, rim).max(axis=-1, keepdims=True)
    assert max(np.abs(re - rre).max(), np.abs(im - rim).max()) <= \
        1e-5 * peak.min()


@pytest.mark.parametrize("bf16,planes_bf16", [(True, False), (True, True),
                                              (False, False)])
@pytest.mark.parametrize("n", SIZES)
def test_inverse_replay_matches_float64(n, bf16, planes_bf16):
    """KO through the replayed stages: the re plane for the first half of
    the contraction, the im plane for the second, rows ld apart (float32
    planes of n/2 + 1 bins: the 4-byte route; KN's bf16 planes padded to 8
    bins: 16-byte copies); within 1e-5 of each frame's peak of float64
    (irfft ignoring imag(DC), imag(Nyquist)), and the bf16 planes read the
    same values as float32 planes rounded on the way."""
    half = n // 2 + 1
    frames = 3
    rng = np.random.default_rng(n + 5)
    re, im = rng.standard_normal((2, frames, half))
    window = hann_window(n) if n > 2 else None
    master = dft_mm._master("inv", n, window)
    lay = dft_mm._kernel_layout("inv", master, n, bf16)
    b = _b_natural_order(lay, bf16).astype(np.float64)
    ld = -(-half // dft_mm.LOW_ALIGN) * dft_mm.LOW_ALIGN if planes_bf16 \
        else half
    elem = 2 if planes_bf16 else 4
    vec = ld % (16 // elem) == 0

    def padded(p):
        out = np.zeros((frames, ld))
        out[:, :half] = _round_bf16(p) if planes_bf16 else p
        return out.reshape(-1)
    a = replay_a("inv", (padded(re), padded(im)),
                 plane_rowbase(0, frames, ld), n, b.shape[0], bf16, elem,
                 vec)[:frames]
    got = promoted(a, b, bf16)[:, :n]
    im0 = im.copy()
    im0[:, 0] = im0[:, -1] = 0.0
    want = np.fft.irfft(re + 1j * im0, n=n, axis=-1)
    peak = np.abs(want).max(axis=-1, keepdims=True)
    if window is not None:
        want = want * window
    tol = 1e-2 if planes_bf16 else 1e-5
    assert np.abs(got - want).max() <= tol * peak.min()
    if planes_bf16:
        a32 = replay_a("inv", (np.asarray(_round_bf16(re)).reshape(-1),
                               np.asarray(_round_bf16(im)).reshape(-1)),
                       plane_rowbase(0, frames, half), n, b.shape[0], bf16,
                       4, False)[:frames]
        np.testing.assert_array_equal(a, a32)


# -- the accumulators, the stores and the persistent tile order ---------------

def wgmma_fragment(lane: int, i: int, warp: int) -> tuple[int, int]:
    """Accumulator i of a consumer thread: (row, column) in the tile."""
    g, t = lane >> 2, lane & 3
    return warp * 16 + g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


def simt_fragment(tid: int, i: int, j: int) -> tuple[int, int]:
    """acc[i][j] of consumer thread tid in the float32 mode."""
    ty, tx = tid >> 4, tid & 15
    return ty * 8 + i, 64 * (j >> 2) + 4 * tx + (j & 3)


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_fragments_cover_the_tile_once(mode):
    """Each 128 x 128 tile output is one consumer thread's accumulator, and
    the pairs a store takes (c, c + 1) sit side by side in one thread with
    c even: (re, im) of one bin, or two adjacent samples."""
    count = np.zeros((TILE_M, TILE_N), int)
    for tid in range(CONSUMERS):
        if mode == "bf16":
            cells = [wgmma_fragment(tid & 31, i, tid >> 5) for i in range(64)]
        else:
            cells = [simt_fragment(tid, i, j) for i in range(8)
                     for j in range(8)]
        for (r0, c0), (r1, c1) in zip(cells[0::2], cells[1::2]):
            assert r0 == r1 and c0 % 2 == 0 and c1 == c0 + 1
        for r, c in cells:
            count[r, c] += 1
    assert np.all(count == 1)


def _bank_conflicts(addrs: list[int], width: int) -> int:
    """Extra wavefronts of one warp's shared load of ``width`` bytes a lane
    (8: two half-warp phases, 16: four quarter-warp phases)."""
    per = 128 // width
    extra = 0
    for q in range(0, 32, per):
        banks: dict[int, set] = {}
        for a in addrs[q:q + per]:
            for w in range(width // 4):
                banks.setdefault((a // 4 + w) % 32, set()).add(a // 4 + w)
        extra += max(len(v) for v in banks.values()) - 1
    return extra


def test_fragment_reads_free_of_bank_conflicts():
    """The consumers' A reads (the wgmma fragments from float32 stages of
    256-byte rows and bf16 stages of 128-byte rows, the micro-tile's A and B
    reads of the float32 mode) take one wavefront a phase."""
    for warp in range(8):
        for j in range(4):
            for half in (0, 8):
                f32, b16 = [], []
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    r = warp * 16 + g + half
                    f32.append(r * 256 + a_chunk(r, 4 * j + t, 4) * 16)
                    b16.append(r * 128 + a_chunk(r, 2 * j + (t >> 1), 2) * 16
                               + (t & 1) * 8)
                assert _bank_conflicts(f32, 16) == 0
                assert _bank_conflicts(b16, 8) == 0
    for warp in range(8):
        lanes = [warp * 32 + lane for lane in range(32)]
        for q in range(8):
            for i in range(8):
                a = [((tid >> 4) * 8 + i) * 128 + (q ^ ((i & 1) << 2)) * 16
                     for tid in lanes]
                assert _bank_conflicts(a, 16) == 0
        for h in (0, 64):
            b = [(h + 4 * (tid & 15)) * 4 for tid in lanes]
            assert _bank_conflicts(b, 16) == 0


def _tiles(rows: int, cols: int):
    """The persistent grid's walk: block b takes tiles b, b + G, ... (G =
    min(tiles, SMs)); tile t is row tile t % mtiles of column panel
    t // mtiles."""
    mtiles = -(-rows // TILE_M)
    tiles = mtiles * (cols // TILE_N)
    grid = min(tiles, SMS)
    for b in range(grid):
        for t in range(b, tiles, grid):
            yield (t % mtiles) * TILE_M, (t // mtiles) * TILE_N


@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("direction", ["fwd", "inv"])
@pytest.mark.parametrize("n,rows,frames,real", [
    (2, 1, 1, 1), (64, 63, 7, 5), (512, 65, 13, 0), (3000, 130, 65, 64),
    (4096, 2244, 1122, 1000), (8192, 257, 257, 257)])
def test_stores_write_each_output_once(n, rows, frames, real, direction,
                                       mode):
    """Over the persistent tile order and every consumer's fragment, each
    output inside the rows and the n/2 + 1 bins (KN) or n samples (KO) is
    stored exactly once and nothing past them; KO's frames at or past the
    real-frame count of their row are stored as zeros."""
    half = n // 2 + 1
    bf16 = mode == "bf16"
    cols = -(-(2 * half if direction == "fwd" else n) // TILE_N) * TILE_N
    width = half if direction == "fwd" else n
    count = np.zeros((rows, width), int)
    zero = np.zeros((rows, width), bool)
    if bf16:
        cells = [(wgmma_fragment(tid & 31, i, tid >> 5)) for tid in
                 range(CONSUMERS) for i in range(0, 64, 2)]
    else:
        cells = [simt_fragment(tid, i, j) for tid in range(CONSUMERS)
                 for i in range(8) for j in range(0, 8, 2)]
    cells = np.array(cells)
    for row0, col0 in _tiles(rows, cols):
        r = row0 + cells[:, 0]
        c = col0 + cells[:, 1]
        if direction == "fwd":   # ForwardStore::put: bin c / 2
            keep = (r < rows) & (c // 2 < half)
            np.add.at(count, (r[keep], c[keep] // 2), 1)
        else:                    # InverseStore::put: samples c, c + 1
            keep = (r < rows) & (c < n)
            np.add.at(count, (r[keep], c[keep]), 1)
            np.add.at(count, (r[keep], c[keep] + 1), 1)
            masked = keep & (r % frames >= real)
            zero[r[masked], c[masked]] = zero[r[masked], c[masked] + 1] = True
    assert np.all(count == 1)
    if direction == "inv":
        np.testing.assert_array_equal(
            zero, (np.arange(rows) % frames >= real)[:, None]
            & np.ones((1, width), bool))


def out_offset(r, j):
    """out_offset: bin j of row r of a plane of the epilogue tile."""
    return r * 128 + ((((j >> 3) ^ r) & 7) << 4) + ((j & 7) << 1)


def test_staged_bf16_planes_map():
    """stage_low: each warpgroup's fragments write its 64 rows x 64 bins of
    each plane once, 2 bytes a bin, without bank conflicts; the 16-byte
    reads of the copy-out take each chunk once, a row to every 8 lanes,
    without bank conflicts."""
    writes = np.zeros(64 * 128, int)
    for warp in range(4):
        for j in range(16):
            for h in range(2):
                addrs = []
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    off = out_offset(warp * 16 + g + 8 * h, 4 * j + t)
                    writes[off:off + 2] += 1
                    addrs.append(off - off % 4)
                assert _bank_conflicts(addrs, 4) == 0
    assert np.all(writes == 1)
    reads = np.zeros(2 * 64 * 128, int)
    for i in range(8):
        addrs = []
        for tid in range(128):
            e = i * 128 + tid
            plane, row, c = e >> 9, (e >> 3) & 63, e & 7
            off = plane * 64 * 128 + out_offset(row, 8 * c)
            assert off % 16 == 0
            reads[off:off + 16] += 1
            addrs.append(off)
        for w in range(4):
            assert _bank_conflicts(addrs[32 * w:32 * w + 32], 16) == 0
    assert np.all(reads == 1)


@pytest.mark.parametrize("n,rows", [(2, 1), (64, 63), (512, 65),
                                    (3000, 130), (4096, 2244), (8192, 257)])
def test_staged_bf16_stores_each_bin_once(n, rows):
    """Over the persistent tile order, the copy-out's 8-bin chunks (bins
    col0 / 2 + 8 c of each row) cover every bin of the padded bf16 rows
    (ld = n/2 + 1 rounded up to 8) exactly once and nothing past them or
    past the last row; the bins from n/2 + 1 to ld hold the zero columns'
    projection, zeros."""
    half = n // 2 + 1
    ld = -(-half // dft_mm.LOW_ALIGN) * dft_mm.LOW_ALIGN
    cols = -(-2 * half // TILE_N) * TILE_N
    count = np.zeros((rows, ld), int)
    for row0, col0 in _tiles(rows, cols):
        for wg in range(2):
            for row in range(64):
                r = row0 + wg * 64 + row
                for c in range(8):
                    j = col0 // 2 + 8 * c
                    if r < rows and j < ld:   # ForwardStore::put8
                        count[r, j:j + 8] += 1
    assert np.all(count == 1)
