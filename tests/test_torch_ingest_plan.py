"""The index plan of kernel KA (csrc/ingest.cu) and of the fused KB + KC's
int16 frame loads (csrc/fft_core.cuh Pcm16Samples), replayed on the CPU.

KA cuts each output row into slots of 4 samples whose first one sits on a
16-byte boundary of the output (slot k of row r starts at 4 k - b_r, b_r
the row's start past 16 bytes in floats): one float4 store a slot, a warp's
stores 512 contiguous bytes. The slot's samples come from one 8-byte load
of 4 mono int16 or one 16-byte load of 4 stereo frames where the row's
slots sit on that boundary of the input and the slot lies inside it, else
from scalar loads (the zero-stuff mode's kept samples always). A grid of
the slots (capped at kMaxBlocks) walks rows x slots: thread t holds
kIngestUnroll slots a grid stride apart, finds their rows once by a
division and, past the cap, moves them on by adds with a carry. A slot
wholly inside the row stores a float4; the head and tail slots store
floats.

No CUDA kernel runs here, so this file replays that walk in numpy at the
bench, zero-stuff, per-row, batch-bucket and odd shapes, with the input and
output bases off 16 bytes and with a small grid that takes many trips:
every slot is visited once, every output sample written once, every vector
access aligned and inside its row, and the values equal KA's plain version
(ops/quantize.pcm16_ingest_plain) bit for bit. The fused launch's int16
frames are replayed the same way against KA's output. The constants are
the sources'. No JAX.
"""
import os
import re

import numpy as np
import pytest
import torch

from gomel_tpu_torch.core.config import PAD_SHIFT_TABLE
from gomel_tpu_torch.core.framing import pad_length, zero_stuff_output_length
from gomel_tpu_torch.ops import _cuda
from gomel_tpu_torch.ops.quantize import pcm16_ingest_plain
from gomel_tpu_torch.ops.stft import num_frames_of


def _source(name: str) -> str:
    with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
        return f.read()


INGEST = _source("ingest.cu")


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", INGEST)
    assert m, f"{name} not in ingest.cu"
    return int(m.group(1))


THREADS = _const("kIngestThreads")
UNROLL = _const("kIngestUnroll")
MONO_SLOT = _const("kMonoSlot")
MAX_BLOCKS = 1 << 20
HOP = 1280
BENCH = 1_440_000                 # 30 s at 48 kHz


def slot_width(channels: int, zp: int) -> int:
    """kV: output samples a slot (SlotShape)."""
    return MONO_SLOT if zp == 0 and channels == 1 else 4


def launch_grid(rows: int, n_out: int, kv: int, max_blocks: int = MAX_BLOCKS
                ) -> tuple[int, int, int]:
    """(slots a row, blocks, step) as launch_walk sizes them: enough blocks
    for kIngestUnroll slots a thread, at most ``max_blocks``; step =
    kIngestUnroll grid strides."""
    slots = (n_out + 3 + kv - 1) // kv
    per_block = THREADS * UNROLL
    blocks = max(1, min(max_blocks, -(-rows * slots // per_block)))
    return slots, blocks, blocks * per_block


def walk(rows: int, slots: int, blocks: int, step: int) -> np.ndarray:
    """Every (row, slot) the threads visit, trip by trip, as the kernel moves
    them: a division for the first slots, then adds with a carry, which must
    equal the division at every trip."""
    stride = blocks * THREADS
    ids = (np.arange(stride, dtype=np.int64)[:, None]
           + np.arange(UNROLL, dtype=np.int64)[None, :] * stride)
    r, k = ids // slots, ids % slots
    step_r, step_k = step // slots, step % slots
    seen = []
    while (r[:, 0] < rows).any():
        live = r < rows
        # the trip runs while the thread's lowest slot is live: r[0] first
        assert not (live & (r[:, :1] >= rows)).any()
        seen.append(np.stack([r[live], k[live]], axis=1))
        ids = ids + step
        k = k + step_k
        r = r + step_r
        carry = k >= slots
        k[carry] -= slots
        r[carry] += 1
        assert (r == ids // slots).all() and (k == ids % slots).all()
    return np.concatenate(seen)


def replay(pcm: np.ndarray, n_out: int, scales: np.ndarray, zp: int, zs: int,
           pcm_phase: int = 0, out_phase: int = 0,
           max_blocks: int = MAX_BLOCKS) -> np.ndarray:
    """KA on int16 [rows, n_in, channels] -> float32 [rows, n_out], slot by
    slot as the kernel runs them, with the checks above; ``pcm_phase``
    (int16 elements) and ``out_phase`` (floats) place the bases past a
    16-byte boundary."""
    rows, n_in, ch = pcm.shape
    kv = slot_width(ch, zp)
    slots, blocks, step = launch_grid(rows, n_out, kv, max_blocks)
    rk = walk(rows, slots, blocks, step)
    assert len(rk) == rows * slots
    assert len(np.unique(rk[:, 0] * slots + rk[:, 1])) == rows * slots
    r, k = rk[:, 0], rk[:, 1]
    b = (r * n_out + out_phase) & 3
    t0 = k * kv - b
    whole = (t0 >= 0) & (t0 + kv <= n_out)
    # a whole slot's float4 stores start on 16 bytes
    assert ((out_phase + r * n_out + t0)[whole] % 4 == 0).all()
    t = t0[:, None] + np.arange(kv)[None, :]
    inside = (t >= 0) & (t < n_out)
    mono = pcm.astype(np.float32)
    mono = mono[..., 0] if ch == 1 else (mono[..., 0] + mono[..., 1]) * 0.5
    divided = mono / scales[:, None].astype(np.float32)
    vals = np.zeros(t.shape, np.float32)
    if zp == 0:
        row_in = r * n_in * ch
        aligned = ((pcm_phase + row_in - b * ch) & (kv * ch - 1)) == 0
        vec = aligned & (t0 >= 0) & (t0 + kv <= n_in)
        # the vector load (kV ch int16): on its width and inside the row
        assert ((pcm_phase + row_in + ch * t0)[vec] % (kv * ch) == 0).all()
        assert (t0[vec] + kv <= n_in).all()
        src = (t >= 0) & (t < n_in)
        vals[src] = divided[np.broadcast_to(r[:, None], t.shape)[src], t[src]]
    else:
        group = zp + zs
        g = np.where(inside, t, 0) // group
        pos = np.where(inside, t, 0) - g * group
        i = g * zp + pos
        kept = inside & (pos < zp) & (i < n_in)
        # at most 3 kept samples (int16 loads) a slot of 4
        assert kept.sum(axis=1).max() <= 3
        rows_of = np.broadcast_to(r[:, None], t.shape)
        vals[kept] = divided[rows_of[kept], i[kept]] * np.float32(1 + zs)
    out = np.full((rows, n_out), np.nan, np.float32)
    writes = np.zeros((rows, n_out), np.int64)
    rows_of = np.broadcast_to(r[:, None], t.shape)
    np.add.at(writes, (rows_of[inside], t[inside]), 1)
    out[rows_of[inside], t[inside]] = vals[inside]
    assert (writes == 1).all()    # every output sample written once
    return out


def plain(pcm: np.ndarray, n_out: int, scales: np.ndarray, zp: int,
          zs: int) -> np.ndarray:
    """KA's plain version, row by row (stereo rows as [L, 2] signals)."""
    outs = []
    for r in range(pcm.shape[0]):
        x = torch.from_numpy(pcm[r] if pcm.shape[2] == 2 else pcm[r, :, 0])
        outs.append(pcm16_ingest_plain(x, torch.float32, float(scales[r]),
                                       n_out, zp=zp, zs=zs).numpy())
    return np.stack(outs)


def _pcm(rows: int, n: int, ch: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-32768, 32768,
                                                size=(rows, n, ch),
                                                dtype=np.int16)


def test_constants_are_the_designs():
    """256-thread blocks, one slot a thread, a grid capped at 2^20 blocks;
    a slot is one float4 of output from one 8-byte load of 4 mono int16 or
    one 16-byte load of 4 stereo frames."""
    assert (THREADS, UNROLL, MONO_SLOT) == (256, 1, 4)
    assert "constexpr long long kMaxBlocks = 1LL << 20;" in INGEST
    assert slot_width(1, 0) * 2 == 8 and slot_width(2, 0) * 4 == 16
    for ch in (1, 2):
        for zp, _ in PAD_SHIFT_TABLE.values():
            assert slot_width(ch, zp) % 4 == 0
    # one kernel a pair of the table (GOMEL_INGEST_PAIR), no other pair
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"GOMEL_INGEST_PAIR\((\d+), (\d+)\)", INGEST)}
    assert pairs == set(PAD_SHIFT_TABLE.values())
    # no division a sample by a runtime value: the kernel divides once a
    # thread (its first slots' rows, by w.slots) and by the compile-time
    # group kG; the rest is the entry point's, once a launch
    body = re.sub(r"//[^\n]*", "", INGEST[INGEST.index("namespace {"):])
    kernel = body[body.index("pcm16_ingest_kernel("):
                  body.index("int launch_walk(")]
    helpers = body[:body.index("pcm16_ingest_kernel(")]
    assert re.findall(r"/\s*([\w.]+)", kernel) == ["w.slots"]
    assert "r[u] = id / w.slots;" in kernel   # the 64-bit build only
    assert "if constexpr (sizeof(I) == 4) {" in kernel
    # compile-time: the words of a load (/ 2), its float4s (/ 4), the group
    assert sorted(set(re.findall(r"/\s*([\w.]+)", helpers))) == ["2", "4",
                                                                 "kG"]
    assert "static_cast<U>(t) / kG" in helpers and "constexpr int kG" in helpers


BENCH_PADDED = pad_length(BENCH, HOP)
ZP16, ZS16 = PAD_SHIFT_TABLE[16000]


@pytest.mark.parametrize("label,rows,n_in,ch,zp,zs,n_out,scales", [
    ("bench mono", 2, BENCH, 1, 0, 0, BENCH_PADDED, [32768.0] * 2),
    ("bench stereo", 1, BENCH // 2, 2, 0, 0, BENCH_PADDED, [65536.0]),
    ("bench zero-stuff 16 kHz", 2, BENCH // 3, 1, ZP16, ZS16,
     pad_length(BENCH // 3 * (1 + ZS16), HOP), [32768.0] * 2),
    ("per-row scales", 4, BENCH_PADDED, 1, 0, 0, BENCH_PADDED,
     [32768.0, 65536.0, 32768.0, 65536.0]),
])
def test_walk_at_the_bench_shapes(label, rows, n_in, ch, zp, zs, n_out,
                                  scales):
    """The main path's shapes on the card's grid: one trip or two, every
    slot once, KA's plain version bit for bit."""
    pcm = _pcm(rows, n_in, ch, seed=rows + ch + zp)
    sc = np.array(scales, np.float32)
    got = replay(pcm, n_out, sc, zp, zs)
    want = plain(pcm, n_out, sc, zp, zs)
    assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()


ODD = [(rows, n, ch, zp, zs, pad)
       for rows, n in ((1, 1), (1, 7), (3, 1001), (5, 37))
       for ch in (1, 2)
       for zp, zs in sorted(set(PAD_SHIFT_TABLE.values()))
       for pad in (0, 13)]


@pytest.mark.parametrize("phases", [(0, 0), (3, 1), (7, 3), (4, 2)])
@pytest.mark.parametrize("rows,n,ch,zp,zs,pad", ODD)
def test_walk_at_odd_shapes_and_bases(rows, n, ch, zp, zs, pad, phases):
    """Odd lengths, partial last groups, rows whose starts fall off 16
    bytes, bases off 16 bytes (pcm by 3, 7 or 4 int16, out by 1-3 floats),
    padding past the input, on a grid capped at 2 blocks, so a thread takes
    many trips and carries rows: every sample once, the plain version's
    bits."""
    pcm = _pcm(rows, n, ch, seed=rows * 7 + n + ch)
    sc = np.array([32768.0, 65536.0, 32768.0, 65536.0, 32768.0][:rows],
                  np.float32)
    n_out = zero_stuff_output_length(n, zp, zs) + pad
    got = replay(pcm, n_out, sc, zp, zs, *phases, max_blocks=2)
    want = plain(pcm, n_out, sc, zp, zs)
    assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()


def test_grid_is_one_trip_at_the_ports_shapes():
    """Below the cap every thread takes its kIngestUnroll slots in one trip
    (the blocks retire and the card schedules the next, which measured
    ahead of a grid of the resident blocks walking on): the bench rows, the
    batch bucket (4 rows of one padded length, the short files padded with
    zeros), a small bucket and a long-form shard."""
    for rows, n in ((2, BENCH), (4, BENCH_PADDED), (4, 230_400),
                    (1, 16_875 * HOP + 4096 - HOP)):
        slots, blocks, step = launch_grid(rows, n, MONO_SLOT)
        assert blocks < MAX_BLOCKS and step >= rows * slots
        assert step - rows * slots < THREADS * UNROLL
    # past the cap the threads walk on (the replay above checks the walk)
    assert launch_grid(64, 48000 * 3600, MONO_SLOT)[1] == MAX_BLOCKS


def slot_magic(slots: int) -> tuple[int, int]:
    """launch_walk's (magic, shift) for 32-bit ids."""
    log_slots = (slots - 1).bit_length()
    return -(-(1 << (32 + log_slots)) // slots), 32 + log_slots


@pytest.mark.parametrize("slots", [1, 2, 3, 7, 360_000, 360_001, 2 ** 20,
                                   2 ** 20 + 1, 5_400_704, 2 ** 29 - 1,
                                   2 ** 30 - 3])
def test_slot_magic_is_the_division(slots):
    """A 32-bit build finds a slot's row as (id magic) >> shift: exact for
    every id a launch forms (< 2^31), the product inside 64 bits."""
    magic, shift = slot_magic(slots)
    assert magic <= 2 ** 33
    rng = np.random.default_rng(slots)
    ids = [0, 1, slots - 1, slots, slots + 1, 2 ** 31 - 1, 2 ** 31 - slots]
    ids += rng.integers(0, 2 ** 31, 2000).tolist()
    for i in ids:
        assert i * magic < 2 ** 64 and (i * magic) >> shift == i // slots


def test_index_width():
    """32-bit indices for every shape the port runs (launch_pair's test):
    the bench shapes, the batch bucket, the long-form file's 30 minutes of
    48 kHz audio, stereo; 64-bit past it."""
    def fits32(rows, n_in, ch, n_out):
        widest = max(n_out, ch * n_in) + 16
        return (rows + 2) * widest < 2 ** 30
    assert "(rows + 2) * widest < (1LL << 30)" in INGEST
    long_form = 48000 * 1800
    for rows, n_in, ch, n_out in ((2, BENCH, 1, BENCH_PADDED),
                                  (1, BENCH, 2, BENCH_PADDED),
                                  (4, BENCH_PADDED, 1, BENCH_PADDED),
                                  (1, long_form, 1,
                                   pad_length(long_form, HOP)),
                                  (1, long_form, 2,
                                   pad_length(long_form, HOP))):
        assert fits32(rows, n_in, ch, n_out)
        # the largest offset a launch forms, with two trips' strides on top
        slots, _, step = launch_grid(rows, n_out, MONO_SLOT)
        assert (rows + 2) * max(n_out, ch * n_in) + 2 * step < 2 ** 31
    assert not fits32(64, 48000 * 600, 1, 48000 * 600)


# -- the fused KB + KC's int16 frames ----------------------------------------
RFFT = _source("rfft_mag.cu")


def int16_vec(hop: int, batch: int, n_in: int, pcm_addr: int,
              win_addr: int) -> bool:
    """gomel_stft_mel_log_pcm16's rule for 8-byte int16 loads."""
    return (hop % 4 == 0 and (batch == 1 or n_in % 4 == 0)
            and pcm_addr % 8 == 0 and win_addr % 16 == 0)


def int16_whole(vec: bool, n_in: int, frames: int, hop: int, n: int) -> bool:
    """Whether the launch runs the build without a row-end test a load."""
    return vec and n_in >= (frames - 1) * hop + n


def test_int16_rules_are_the_sources():
    assert ("hop % 4 == 0 && (batch == 1 || n_in % 4 == 0) &&\n"
            "                   reinterpret_cast<uintptr_t>(pcm) % 8 == 0 &&\n"
            "                   reinterpret_cast<uintptr_t>(window) % 16 == 0"
            in RFFT)
    assert "if (vec && n_in >= (frames - 1) * hop + n) {" in RFFT


@pytest.mark.parametrize("n,hop,rows,n_in,pad_to,base", [
    (4096, 1280, 2, BENCH, BENCH_PADDED, 0),   # the bench shape
    (4096, 1280, 4, BENCH_PADDED, 0, 0),       # the batch bucket
    (64, 16, 1, 1001, 1024, 0),                # L not a multiple of hop
    (64, 16, 1, 40, 64, 0),                    # L < n
    (256, 64, 3, 2002, 2100, 0),               # rows off 8 bytes: scalar
    (256, 50, 2, 1999, 0, 0),                  # hop % 4: scalar
    (256, 64, 2, 2000, 0, 2),                  # a base 2 bytes off 8
])
def test_int16_frames_are_kas(n, hop, rows, n_in, pad_to, base):
    """Each frame's samples as Pcm16Samples forms them, 4 at a time (off a
    multiple of 4): an 8-byte load where the rule holds and the 4 lie in
    the row, else scalar loads, zeros from n_in on; each load aligned; the
    build without a test only where every load is such a vector; and every
    frame equal to KA's output framed, bit for bit."""
    pcm = _pcm(rows, n_in, 1, seed=n + rows)[..., 0]
    scales = np.array([32768.0, 65536.0, 32768.0, 65536.0][:rows], np.float32)
    x = pcm16_ingest_plain(torch.from_numpy(pcm), torch.float32,
                           torch.from_numpy(scales), pad_to,
                           batched=True).numpy()
    frames = num_frames_of(max(n_in, pad_to), n, hop)
    vec = int16_vec(hop, rows, n_in, base, 0)
    divided = pcm.astype(np.float32) / scales[:, None]
    for bi in range(rows):
        start = np.arange(frames, dtype=np.int64) * hop
        avail = n_in - start
        off = np.arange(0, n, 4)
        j = np.arange(4)
        idx = start[:, None, None] + off[None, :, None] + j   # [F, n/4, 4]
        vector = vec & (off[None, :] + 4 <= avail[:, None])    # [F, n/4]
        # an 8-byte load: on 8 bytes and inside the row
        first = base // 2 + bi * n_in + start[:, None] + off[None, :]
        assert (first[vector] % 4 == 0).all()
        assert (idx[vector][:, -1] < n_in).all()
        assert vector.all() or not int16_whole(vec, n_in, frames, hop, n)
        got = np.where(idx < n_in, divided[bi, np.minimum(idx, n_in - 1)],
                       np.float32(0.0)).reshape(frames, n)
        want = x[bi, start[:, None] + np.arange(n)]
        assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()
