"""The hop-row walk of kernels KH and KM, replayed on the CPU.

csrc/overlap_add.cuh walks an overlap-add's output by hop-row and column:
a thread owns a group of 4 adjacent columns of a hop-row (the vector path)
or one (the scalar path), a block covers ``threads // groups`` hop-rows at
once when a row is narrower than the block, and block x of the grid walks
passes x, x + blocks, ... (``ola_thread``, ``ola_threads``, ``ola_blocks``).
KH (csrc/phase_decode.cu ``overlap_normalize_kernel``) sums each group's
taps k_lo <= k < k_hi in ascending k from 0.0f and normalises by the window
sum read by row class; KM (csrc/shard_epilogue.cu ``shard_epilogue_kernel``)
indexes global hop-rows from the shard's (start // hop, start % hop). No
CUDA kernel runs here, so this file replays that walk in numpy float32, one
rounded operation at a time, at every grid size the launch can give, and
checks that every output sample is written exactly once, that the kernels'
entry points pick the path the shapes and pointers allow (overlap_add.cuh
``ola_vector`` on the extents each entry point lists), and that both paths
give the bits of overlap_add_plain, overlap_normalize_plain and
shard_epilogue_plain. No JAX.
"""
import os
import re

import numpy as np
import pytest
import torch

from gomel_tpu_torch.ops import _cuda, istft
from gomel_tpu_torch.ops.stft import hann_window

F32 = np.float32
MAX_THREADS = 512      # kOlaMaxThreads
SMS = 132              # an H100's SMs
GL_ROW = 1024          # kOlaPlainRow: KM's row in its Griffin-Lim modes


def ola_threads(groups: int) -> int:
    return min(MAX_THREADS, -(-groups // 32) * 32)


def ola_blocks(threads: int, groups: int, rows: int, batch: int,
               per_sm: int) -> int:
    per_pass = threads // groups if groups < threads else 1
    passes = -(-rows // per_pass)
    return max(1, min(SMS * per_sm // batch, passes))


def grids(hop: int, lanes: int, rows: int, batch: int) -> list[int]:
    """The grid sizes to replay: one block, a few, and what the launch
    gives at 1, 4 and 16 resident blocks an SM."""
    groups = hop // lanes
    threads = ola_threads(groups)
    return sorted({1, 3} | {ola_blocks(threads, groups, rows, batch, k)
                            for k in (1, 4, 16)})


def ola_vector(extents, tensors=()) -> bool:
    """overlap_add.cuh ola_vector: the vector path when every extent is a
    multiple of 4 and every tensor (None passes) starts on 16 bytes."""
    return (all(e % 4 == 0 for e in extents)
            and all(t.data_ptr() % 16 == 0 for t in tensors if t is not None))


def kh_vector(n: int, hop: int, *tensors) -> bool:
    """gomel_overlap_normalize's path: n and hop."""
    return ola_vector((n, hop), tensors)


def km_vector(hop: int, ext_len: int, chunk: int, recv_stride: int,
              out_stride: int, start: int, *tensors) -> bool:
    """gomel_shard_epilogue's path: hop, the row strides, the chunk and the
    first sample's column (start % hop)."""
    return ola_vector((hop, ext_len, chunk, recv_stride, out_stride,
                       start % hop), tensors)


def walk(hop: int, lanes: int, rows: int, blocks: int):
    """(hop-row r, first column c) of every item of the walk, over all
    threads of all blocks: ola_thread, then the kernels' loops over the
    thread's column groups and its hop-rows."""
    groups = hop // lanes
    threads = ola_threads(groups)
    rs, cs = [], []
    for tid in range(threads):
        per_pass, sub, g0 = 1, 0, tid
        if groups < threads:
            per_pass = threads // groups
            sub = tid // groups
            g0 = tid - sub * groups
        if sub >= per_pass:
            continue
        step = blocks * per_pass
        first = np.arange(blocks) * per_pass + sub
        r = first[:, None] + step * np.arange(-(-rows // step) + 1)[None, :]
        r = r[r < rows]
        for g in range(g0, groups, threads):
            rs.append(r)
            cs.append(np.full(r.shape, g * lanes))
    return np.concatenate(rs), np.concatenate(cs)


def window_sum_at(table, i, c, frames, taps, short):
    """overlap_add.cuh window_sum_at on arrays of hop-rows and columns."""
    rows_out = frames + taps - 1
    if short:
        top = table[np.minimum(i, taps - 1), c]
        s = i - frames
        sub = np.where(s >= 0, table[np.clip(s, 0, taps - 1), c], F32(0))
        return (top - sub).astype(F32)
    full = table[taps - 1, c]
    head = table[np.clip(i, 0, taps - 1), c]
    tail = (full - table[np.clip(i - (rows_out - (taps - 1)), 0, taps - 1),
                         c]).astype(F32)
    return np.where(i < taps - 1, head,
                    np.where(i < rows_out - (taps - 1), full, tail))


def window_sum_lanes(table, i, cols, frames, taps, short):
    """window_sum_lanes: the table's last row in the periodic middle, the
    branches elsewhere (all rows in the short form)."""
    mid_lo, mid_hi = (0, 0) if short else (taps - 1, frames)
    ii = np.broadcast_to(i[:, None], cols.shape)
    edge = window_sum_at(table, ii, cols, frames, taps, short)
    mid = (ii >= mid_lo) & (ii < mid_hi)
    return np.where(mid, table[taps - 1, cols], edge)


def normalize(t, ws, threshold):
    thr = F32(threshold)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ws > thr, t / ws,
                        np.where(ws > F32(1e-21), t / thr, t)).astype(F32)


def pcm16(y):
    q = np.where(np.isnan(y), F32(0), np.clip(y, F32(-1), F32(1)))
    q = np.clip(np.rint(q * F32(32768)), -32768, 32767)
    return q.astype(np.int16)


def table_of(window: np.ndarray, hop: int) -> np.ndarray:
    """The [taps, hop] prefix table, as the wrappers build it."""
    prefix = istft._prefix_rows(torch.from_numpy(window), hop)
    return prefix.numpy()


def replay_kh(fw, hop, window, boost, lanes, blocks):
    """KH on frames_w [B, F, n]: (float32 out, int16 PCM, finite flags,
    writes per sample)."""
    B, F, n = fw.shape
    taps = -(-n // hop)
    rows = F + taps - 1
    length = n + (F - 1) * hop
    table = short = threshold = None
    if window is not None:
        table = table_of(window, hop)
        short = rows <= 2 * (taps - 1)
        threshold = istft.window_sum_threshold(torch.from_numpy(table), F)
    r, c = walk(hop, lanes, rows, blocks)
    t0 = r * hop + c
    keep = t0 < length                      # the last hop-row's tail
    r, c, t0 = r[keep], c[keep], t0[keep]
    cols = c[:, None] + np.arange(lanes)[None, :]
    kc = np.minimum(taps, np.maximum(0, -(-(n - c) // hop)))
    k_lo = np.where(r >= F, r - (F - 1), 0)
    k_hi = np.minimum(kc, r + 1)
    out = np.zeros((B, length), F32)
    pcm = np.zeros((B, length), np.int16)
    count = np.zeros((B, length), np.int64)
    finite = np.ones(B, bool)
    for b in range(B):
        acc = np.zeros(cols.shape, F32)
        for k in range(taps):
            live = ((k >= k_lo) & (k < k_hi))[:, None]
            fi = np.clip(r - k, 0, F - 1)[:, None]
            v = fw[b, fi, np.clip(k * hop + cols, 0, n - 1)]
            acc = np.where(live, acc + v, acc)
        y = acc
        if table is not None:
            ws = window_sum_lanes(table, r, cols, F, taps, short)
            y = normalize(acc, ws, threshold)
        if boost != 0.0:
            y = (y * F32(boost)).astype(F32)
        at = t0[:, None] + np.arange(lanes)[None, :]
        np.add.at(count[b], at.ravel(), 1)
        out[b, at] = y
        pcm[b, at] = pcm16(y)
        finite[b] = bool(np.isfinite(y).all())
    return out, pcm, finite, count


def replay_km(sig_ext, recv, chunk, lanes, blocks, *, window=None, hop=0,
              start=0, n_frames=0, boost=0.0, t_prev=None, momentum=0.0):
    """KM on sig_ext [B, chunk + halo]: (y, t, PCM-16, finite, writes per
    sample)."""
    B, ext_len = sig_ext.shape
    halo = ext_len - chunk
    table = None
    if window is None:
        hop, start = GL_ROW, 0
    else:
        table = table_of(window, hop)
        taps = table.shape[0]
        short = n_frames + taps - 1 <= 2 * (taps - 1)
        threshold = istft.window_sum_threshold(torch.from_numpy(table),
                                               n_frames)
    row0, col0 = start // hop, start % hop
    rows = -(-(col0 + chunk) // hop)
    r, c = walk(hop, lanes, rows, blocks)
    j0 = r * hop + c - col0
    keep = (j0 >= 0) & (j0 < chunk)          # before col0, past the chunk
    r, c, j0 = r[keep], c[keep], j0[keep]
    cols = c[:, None] + np.arange(lanes)[None, :]
    at = j0[:, None] + np.arange(lanes)[None, :]
    ys, ts = np.zeros((B, chunk), F32), np.zeros((B, chunk), F32)
    pcm = np.zeros((B, chunk), np.int16)
    count = np.zeros((B, chunk), np.int64)
    finite = np.ones(B, bool)
    for b in range(B):
        t = sig_ext[b, at]
        if recv is not None:
            in_halo = (j0 < halo)[:, None]   # lane 0 decides, as the kernel
            t = np.where(in_halo, t + recv[b, np.minimum(at, halo - 1)], t)
        y = t
        if table is not None:
            i = row0 + r
            ws = np.where((i < n_frames + taps - 1)[:, None],
                          window_sum_lanes(table, i, cols, n_frames, taps,
                                           short), F32(0))
            y = normalize(t, ws, threshold)
            if boost != 0.0:
                y = (y * F32(boost)).astype(F32)
        if t_prev is not None:
            m = F32(momentum)
            y = (t + (m * (t - t_prev[b, at])).astype(F32)).astype(F32)
        np.add.at(count[b], at.ravel(), 1)
        ys[b, at], ts[b, at], pcm[b, at] = y, t, pcm16(y)
        finite[b] = bool(np.isfinite(y).all())
    return ys, ts, pcm, finite, count


def bits(a) -> np.ndarray:
    return np.asarray(a, F32).view(np.uint32)


# (n, hop, frames, boost, batch): the CLI shape, one frame, the short
# window-sum form, n < hop, hop not a multiple of 4, n % 4 == 2 (resolut
# 514), hop 1 (a block over 32 hop-rows at once), hop 4 with 64 taps
KH_SHAPES = [
    (4096, 1280, 37, 0.0, 2),
    (4096, 1280, 5, 1.5, 1),
    (4096, 1280, 1, 0.0, 2),
    (4096, 1280, 2, 0.0, 1),
    (64, 16, 3, -2.0, 2),
    (256, 320, 6, 0.0, 2),
    (4096, 1279, 9, 0.0, 1),
    (514, 128, 20, 0.0, 2),
    (6, 1, 9, 0.5, 3),
    (256, 4, 70, 0.0, 1),
]


def _frames(shape, seed):
    n, hop, frames, _, batch = shape
    rng = np.random.default_rng(seed)
    fw = (rng.standard_normal((batch, frames, n)) * 0.3).astype(F32)
    return fw, hann_window(n).astype(F32)


@pytest.mark.parametrize("shape", KH_SHAPES)
def test_kh_walk_once_and_bit_exact(shape):
    """Every sample written once, at every grid size, on the path the
    wrapper takes and on the scalar path, bit-equal to the plain versions
    (normalised with boost, PCM-16 with its flags, and the plain
    overlap-add)."""
    n, hop, _, boost, _ = shape
    fw, win = _frames(shape, n + hop)
    fw_t, win_t = torch.from_numpy(fw), torch.from_numpy(win)
    want = istft.overlap_normalize_plain(fw_t, hop, win_t, boost).numpy()
    want_pcm, want_ok = istft.overlap_normalize_plain(fw_t, hop, win_t, boost,
                                                      pcm16=True)
    want_ola = istft.overlap_add_plain(fw_t, hop).numpy()
    paths = {4, 1} if kh_vector(n, hop) else {1}
    for lanes in paths:
        taps = -(-n // hop)
        for blocks in grids(hop, lanes, fw.shape[1] + taps - 1, fw.shape[0]):
            out, pcm, ok, count = replay_kh(fw, hop, win, boost, lanes, blocks)
            assert (count == 1).all(), (lanes, blocks)
            np.testing.assert_array_equal(bits(out), bits(want))
            np.testing.assert_array_equal(pcm, want_pcm.numpy())
            np.testing.assert_array_equal(ok, want_ok.numpy())
        ola, _, _, count = replay_kh(fw, hop, None, 0.0, lanes, blocks)
        assert (count == 1).all()
        np.testing.assert_array_equal(bits(ola), bits(want_ola))


def test_kh_finite_flag():
    """A NaN or an infinity in a row clears that row's flag and stores 0
    (NaN) or the saturated value, as the plain version does."""
    fw = np.zeros((3, 6, 512), F32)
    fw[1, 2, 100] = np.nan
    fw[2, 0, 7] = np.inf
    win = hann_window(512).astype(F32)
    _, pcm, ok, _ = replay_kh(fw, 128, win, 0.0, 4, 2)
    want_pcm, want_ok = istft.overlap_normalize_plain(
        torch.from_numpy(fw), 128, torch.from_numpy(win), pcm16=True)
    assert ok.tolist() == want_ok.tolist() == [True, False, False]
    np.testing.assert_array_equal(pcm, want_pcm.numpy())


# KM decode: (n, hop, frames a shard, shard, offset of start past
# shard * chunk, n_frames, boost, pcm16). The CLI shape on the first, a
# middle and the last shard and past the real frames; a start that is not a
# multiple of hop (vector: 640; scalar: 2, 1283); hop not a multiple of 4;
# n < hop; one real frame and the short window-sum form
KM_DECODE = [
    (4096, 1280, 12, 0, 0, 40, 0.0, False),
    (4096, 1280, 12, 1, 0, 40, 1.5, True),
    (4096, 1280, 12, 3, 0, 40, 0.0, True),
    (4096, 1280, 12, 2, 0, 9, 0.0, False),
    (4096, 1280, 12, 1, 640, 40, 0.0, False),
    (4096, 1280, 12, 1, 2, 40, 1.5, True),
    (4096, 1280, 12, 2, 1283, 40, 0.0, False),
    (4096, 1279, 12, 1, 0, 40, 0.0, True),
    (256, 320, 8, 1, 0, 30, 0.0, False),
    (1024, 320, 5, 0, 0, 1, 0.0, False),
    (1024, 320, 5, 0, 0, 3, 0.0, True),
]


def _shard(shape, seed):
    n, hop, f_loc, shard = shape[:4]
    chunk, halo = f_loc * hop, max(n - hop, 0)
    rng = np.random.default_rng(seed)
    sig = (rng.standard_normal((2, chunk + halo)) * 0.3).astype(F32)
    recv = None if shard == 0 or halo == 0 else (
        rng.standard_normal((2, halo)) * 0.3).astype(F32)
    return sig, recv, chunk


@pytest.mark.parametrize("shape", KM_DECODE)
def test_km_decode_walk_once_and_bit_exact(shape):
    n, hop, f_loc, shard, offset, n_frames, boost, pcm = shape
    sig, recv, chunk = _shard(shape, 23 + shard + offset)
    win = hann_window(n).astype(F32)
    start = shard * chunk + offset
    kw = dict(window=torch.from_numpy(win), hop=hop, start=start,
              n_frames=n_frames, volume_boost=boost)
    recv_t = None if recv is None else torch.from_numpy(recv)
    want = istft.shard_epilogue_plain(torch.from_numpy(sig), recv_t, chunk,
                                      **kw)
    want_pcm, want_ok = istft.shard_epilogue_plain(
        torch.from_numpy(sig), recv_t, chunk, pcm16=True, **kw)
    vec = km_vector(hop, sig.shape[1], chunk,
                    0 if recv is None else recv.shape[1], chunk, start)
    assert vec == (hop % 4 == 0 and start % 4 == 0)
    for lanes in ({4, 1} if vec else {1}):
        rows = -(-(start % hop + chunk) // hop)
        for blocks in grids(hop, lanes, rows, 2):
            y, _, p, ok, count = replay_km(
                sig, recv, chunk, lanes, blocks, window=win, hop=hop,
                start=start, n_frames=n_frames, boost=boost)
            assert (count == 1).all(), (lanes, blocks)
            np.testing.assert_array_equal(bits(y), bits(want))
            np.testing.assert_array_equal(p, want_pcm.numpy())
            np.testing.assert_array_equal(ok, want_ok.numpy())


@pytest.mark.parametrize("chunk,momentum", [(1600, 0.99), (1600, 0.0),
                                            (1601, 0.99), (5 * 1024, 0.5)])
def test_km_gl_walk_once_and_bit_exact(chunk, momentum):
    """The Griffin-Lim modes walk rows of 1024 samples: the momentum step
    (c, t) and the plain carry, vector and scalar, bit-exact."""
    halo = 704
    rng = np.random.default_rng(chunk)
    sig = rng.standard_normal((3, chunk + halo)).astype(F32)
    recv = rng.standard_normal((3, halo)).astype(F32)
    t_prev = rng.standard_normal((3, chunk)).astype(F32) if momentum else None
    kw = {} if t_prev is None else dict(t_prev=torch.from_numpy(t_prev),
                                        momentum=momentum)
    want = istft.shard_epilogue_plain(torch.from_numpy(sig),
                                      torch.from_numpy(recv), chunk, **kw)
    want_c, want_t = want if t_prev is not None else (want, want)
    vec = km_vector(GL_ROW, chunk + halo, chunk, chunk + halo,
                    chunk + halo, 0)
    assert vec == (chunk % 4 == 0)
    for lanes in ({4, 1} if vec else {1}):
        for blocks in grids(GL_ROW, lanes, -(-chunk // GL_ROW), 3):
            y, t, _, _, count = replay_km(sig, recv, chunk, lanes, blocks,
                                          t_prev=t_prev, momentum=momentum)
            assert (count == 1).all()
            np.testing.assert_array_equal(bits(y), bits(want_c))
            np.testing.assert_array_equal(bits(t), bits(want_t))


def test_paths_split_on_the_shapes():
    """The vector path needs every extent a multiple of 4 and every
    tensor on 16 bytes; anything else takes the scalar path."""
    assert kh_vector(4096, 1280)                 # the CLI shape
    assert kh_vector(3000, 1280)                 # --resolut 3000
    assert not kh_vector(4096, 1279)
    assert not kh_vector(514, 128)               # Phase at resolut 514
    buf = torch.zeros(64)
    assert kh_vector(16, 4, buf, None)
    assert not kh_vector(16, 4, buf[1:])         # 4 bytes past the start
    chunk, halo = 16875 * 1280, 2816             # one long-form shard
    ext = chunk + halo
    assert km_vector(1280, ext, chunk, ext, chunk, 3 * chunk)
    assert km_vector(1280, ext, chunk, ext, ext, 3 * chunk + 640)
    assert not km_vector(1280, ext, chunk, ext, chunk, 2)
    assert not km_vector(1279, ext, chunk, ext, chunk, 0)
    assert not km_vector(1280, ext + 2, chunk + 2, ext + 2, chunk + 2, 0)
    assert not km_vector(1280, ext, chunk, ext, chunk, 0, buf[2:])
    # the Griffin-Lim modes: rows of GL_ROW from 0, the chunk decides
    assert km_vector(GL_ROW, 1600 + 704, 1600, 1600 + 704, 1600 + 704, 0)
    assert not km_vector(GL_ROW, 1601 + 704, 1601, 1601 + 704, 1601, 0)


def _source(name: str) -> str:
    with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
        return f.read()


def test_walk_constants_match_the_source():
    """The replay's block limit, Griffin-Lim row and path choices are the
    kernels': the constants of overlap_add.cuh, and the extents each entry
    point hands ola_vector, in the order kh_vector and km_vector take
    them."""
    text = _source("overlap_add.cuh")
    assert re.search(r"constexpr int kOlaMaxThreads = (\d+);",
                     text).group(1) == str(MAX_THREADS)
    assert re.search(r"constexpr int kOlaPlainRow = (\d+);",
                     text).group(1) == str(GL_ROW)
    assert "if (e % 4 != 0) return false;" in text
    assert "if (!aligned16(p)) return false;" in text
    assert "ola_vector({n, hop}, {src, tb, of, op})" in _source(
        "phase_decode.cu")
    km = re.sub(r"\s+", " ", _source("shard_epilogue.cu"))
    assert ("ola_vector({hop, ext_len, chunk, recv_stride, out_stride, "
            "col0}, {sig, rv, tb, tp, of, ot, op})") in km
    assert "hop = kOlaPlainRow; start = 0;" in km
