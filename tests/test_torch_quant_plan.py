"""The index plans of kernels KD, KF and KI, replayed on the CPU.

KD and KF (csrc/quantize.cu) are one two-pass design; KD folds the two
channels' extrema into one global max and min a row. Pass 1 runs on a grid
sized to the card (the SMs x the kernel's resident blocks, shared by the
rows, no more blocks a row than one trip of kPlanesUnroll quads a thread
can use): a row is a head of up to 3 floats to the first 16-byte boundary,
float4 quads a grid stride apart and a tail of up to 3 floats, float i of a
row being channel i % 2; the last block of a row folds its partials once.
Pass 2 runs 32-frame x 64-bin tiles: warp w loads the tile's 4-frame group
w, lane j its bins (2j, 2j + 1), packs each bin's 4 pixels into one
swizzled shared-memory slot, and a warp stores 4-byte words of the bin
rows: two 64-byte rows an instruction for uint8, one 128-byte row for
uint16. KI (csrc/mel_decode.cu) runs
persistent blocks over runs of kMelRun frames of one batch row: each block
stages the band table once in shared memory as planes a bin wide, reads a
run's [T, 2] sub-image of each mel row (or its T x 2M floats) into one of
two alternating buffers, and gives each frame kMagThreads / 32 / T warps,
lane l of a chunk of 128 outputs taking l, l + 32, l + 64, l + 96 and
storing them a float at a time (16-byte stores of the aligned chunks are
tools/profile_quant.py's ki_vec_stores build).

No CUDA kernel runs here, so this file replays those plans in numpy: every
input element is read once and every output element written once, with
the right channel, bank and alignment, at the bench, masked, long-form and
odd shapes, for masked counts 0, partial and full and a base one float off
16 bytes; the constants are the sources'. No JAX.
"""
import os
import re

import numpy as np
import pytest
import torch

from gomel_tpu_torch.core.config import MelConfig
from gomel_tpu_torch.core.filterbank import inverse_mel_weights
from gomel_tpu_torch.ops import _cuda, mel_ops, quantize


def _source(name: str) -> str:
    with open(os.path.join(_cuda.CSRC_DIR, name)) as f:
        return f.read()


def _const(name: str, source: str):
    m = re.search(rf"constexpr (?:int|bool) {name} = (\w+);", _source(source))
    assert m, f"{name} not in {source}"
    return {"true": True, "false": False}.get(m.group(1)) \
        if m.group(1) in ("true", "false") else int(m.group(1))


THREADS = _const("kPlanesThreads", "quantize.cu")
UNROLL = _const("kPlanesUnroll", "quantize.cu")
TILE_F = _const("kTileF", "quantize.cu")
TILE_K = _const("kTileK", "quantize.cu")
RUN = _const("kMelRun", "mel_decode.cu")
MAG_THREADS = _const("kMagThreads", "mel_decode.cu")
CHUNK = _const("kMagChunk", "mel_decode.cu")
WARPS = MAG_THREADS // 32
# an H100 SXM: 132 SMs x 5 blocks of pass 1 an SM (the occupancy query of
# tools/profile_quant.py at 47 registers a thread)
RESIDENT = 132 * 5

BENCH = (2, 1122, 1536)
MASKED = (4, 1122, 1536)
LONG = (1, 67500, 1536)


def test_constants_are_the_designs():
    """The plans below are the sources': KD's and KF's 256-thread blocks, 4
    quads in flight, 32 x 64 tiles of 32 bin pairs x 8 warps (a 4-frame
    group a warp); KI's 256-thread blocks, runs of 4 frames (2 warps a
    frame), chunks of 128 outputs (4 a lane), a float a store."""
    assert (THREADS, UNROLL, TILE_F, TILE_K) == (256, 4, 32, 64)
    assert TILE_K == 2 * 32 and TILE_F == 4 * (THREADS // 32)
    assert (MAG_THREADS, RUN, CHUNK) == (256, 4, 128)
    assert WARPS % RUN == 0 and CHUNK % 128 == 0


# -- KF pass 1 ---------------------------------------------------------------

def planes_parts(batch, row_floats, resident=RESIDENT):
    """csrc/quantize.cu planes_parts (gomel_quantize_planes_parts)."""
    parts = -(-resident // batch)
    usable = -(-(row_floats // 4) // (THREADS * UNROLL))
    return max(1, min(parts, usable))


def masked_count(row_floats, n_frames, frame_floats, frames):
    """(floats pass 1 reduces, starting max, starting min) of one row."""
    if frames is None or frames >= n_frames:
        return row_floats, -np.inf, np.inf
    big = np.finfo(np.float32).max
    return (frames * frame_floats if frames > 0 else 0), -big, big


def pass1_cover(count, base_addr, parts):
    """(quad cover counts, head floats, tail floats, swap) of pass 1's walk
    over one row of ``count`` floats starting at byte ``base_addr``: the
    quads each (block, thread, trip, u) visits, vectorised over the
    grid's threads."""
    to_16 = ((16 - base_addr % 16) % 16) // 4
    head = min(to_16, count)
    quads = (count - head) // 4
    stride = parts * THREADS
    cover = np.zeros(quads, np.uint8)
    r = np.arange(stride)                  # blockIdx.x * 256 + threadIdx.x
    q0 = r.copy()
    while q0[0] < quads:
        active = q0 < quads
        for u in range(UNROLL):
            q = q0 + u * stride
            cover[q[active & (q < quads)]] += 1
        q0 += UNROLL * stride
    heads = [t for t in range(3) if t < head]
    tails = [head + 4 * quads + t for t in range(3)
             if head + 4 * quads + t < count]
    return cover, heads, tails, bool(head & 1)


@pytest.mark.parametrize("shape", [BENCH, MASKED, LONG, (3, 41, 37),
                                   (1, 1, 1)])
def test_pass1_grid_fills_the_card(shape):
    """The card's resident blocks shared by the rows, capped where a row
    would leave a thread without one trip of quads."""
    batch, frames, bins = shape
    row = frames * bins * 2
    parts = planes_parts(batch, row)
    usable = -(-(row // 4) // (THREADS * UNROLL))
    assert 1 <= parts <= -(-RESIDENT // batch)
    # the scratch the wrapper asks for holds at most the resident blocks
    # and one partial row more
    assert parts * batch < RESIDENT + batch
    assert parts == max(1, min(-(-RESIDENT // batch), usable))
    if shape in (BENCH, MASKED, LONG):
        # the bench, masked and long-form shapes fill the card exactly
        assert parts * batch == RESIDENT
    if parts < -(-RESIDENT // batch):
        assert (parts - 1) * THREADS * UNROLL < max(row // 4, 1)


@pytest.mark.parametrize("shape,frames,offset", [
    (BENCH, None, 0), (MASKED, 843, 0), (MASKED, 0, 0), (MASKED, 1122, 1),
    (LONG, None, 0), (LONG, None, 1), ((3, 41, 37), None, 1),
    ((3, 41, 37), 17, 3), ((2, 5, 3), 1, 2), ((1, 1, 1), None, 3)])
def test_pass1_reads_each_counted_float_once(shape, frames, offset):
    """Every counted float of a row once (quads, head, tail), nothing past
    the count, each with its channel: odd nf, a base 4, 8 or 12 bytes off
    16, masked counts 0, partial and full (the long-form row, 207 M floats,
    too)."""
    batch, n_frames, bins = shape
    row = n_frames * bins * 2
    parts = planes_parts(batch, row)
    for b in range(min(batch, 2)):
        count, _, _ = masked_count(row, n_frames, 2 * bins, frames)
        base = 4096 + 4 * offset + 4 * b * row
        cover, heads, tails, swap = pass1_cover(count, base, parts)
        assert (cover == 1).all()
        head = len(heads)
        assert head == min(((16 - base % 16) % 16) // 4, count)
        assert head + 4 * cover.size + len(tails) == count
        assert heads == list(range(head))
        assert tails == list(range(head + 4 * cover.size, count))
        # quad q's lane i is float head + 4q + i: channel (head + i) % 2,
        # the kernel's (i + swap) % 2
        for i in range(4):
            assert (head + i) % 2 == (i + swap) % 2
        if cover.size:
            assert (base + 4 * head) % 16 == 0


@pytest.mark.parametrize("shape,frames,offset,ihs", [
    ((3, 41, 37), [41, 17, 0], 1, 0), ((2, 30, 64), [30, 29], 0, 1),
    ((4, 23, 65), [23, 11, 0, 30], 3, 0), ((2, 9, 8), None, 2, 2)])
def test_pass1_extrema_are_the_plain_versions(shape, frames, offset, ihs):
    """Partials over each block's floats from the masked start, folded once
    by the row's last block: the plain version's extrema bit for bit, NaN
    in a counted frame propagating and one in a pad frame not, the
    sentinels at frames 0."""
    batch, n_frames, bins = shape
    rng = np.random.default_rng(sum(shape))
    spec = (rng.standard_normal((batch, n_frames, bins, 2)) * 30).astype(
        np.float32)
    spec[0, 2, 1, 0] = np.nan                       # a counted frame
    if frames is not None and frames[1] < n_frames:
        spec[1, n_frames - 1, 0, 1] = np.nan        # a pad frame
    row = n_frames * bins * 2
    parts = planes_parts(batch, row)
    x = torch.from_numpy(spec)
    for _ in range(ihs):
        x = torch.asinh(x)
    flat = x.numpy().reshape(batch, -1)
    mx = np.empty((batch, 2), np.float32)
    mn = np.empty((batch, 2), np.float32)
    for b in range(batch):
        count, lo, hi = masked_count(row, n_frames, 2 * bins,
                                     None if frames is None else frames[b])
        cover, heads, tails, swap = pass1_cover(count, 4096 + 4 * offset,
                                                parts)
        head = len(heads)
        idx = np.concatenate([heads, head + np.arange(4 * cover.size),
                              tails]).astype(np.int64)
        for c in range(2):
            vals = flat[b, idx[idx % 2 == c]]
            # max.NaN / min.NaN: NaN wins (np.maximum propagates it)
            mx[b, c] = np.maximum.reduce(np.append(vals, lo).astype(np.float32))
            mn[b, c] = np.minimum.reduce(np.append(vals, hi).astype(np.float32))
    tf = None if frames is None else torch.tensor(frames)
    _, ref_mx, ref_mn = quantize.quantize_planes_plain(torch.from_numpy(spec),
                                                       255, ihs, tf)
    np.testing.assert_array_equal(mx, ref_mx.numpy())
    np.testing.assert_array_equal(mn, ref_mn.numpy())


def test_fold_tickets_wrap():
    """atomicInc(ticket, parts - 1) in any order of the blocks: exactly one
    block sees parts - 1 (the last), and the ticket ends at 0."""
    rng = np.random.default_rng(0)
    for parts in (1, 2, 7, 528, 1056):
        ticket, last = 0, []
        for p in rng.permutation(parts):
            old = ticket
            ticket = 0 if old >= parts - 1 else old + 1
            if old == parts - 1:
                last.append(p)
        assert len(last) == 1 and ticket == 0


# -- pass 2 (KD and KF) --------------------------------------------------------

def pass2_loads(b, bx, by, frames, bins):
    """(frame, bin) of every float2 the block's threads load."""
    out = []
    for warp in range(THREADS // 32):
        for lane in range(32):
            k = by * TILE_K + 2 * lane
            for i in range(4):
                f = bx * TILE_F + 4 * warp + i
                if f < frames and k < bins:
                    out.append((f, k))
                    if k + 1 < bins:
                        out.append((f, k + 1))
    return out


@pytest.mark.parametrize("shape", [BENCH, (2, 131, 97), (1, 1, 1),
                                   (3, 64, 64), (2, 65, 130)])
def test_pass2_tiles_read_each_input_once(shape):
    """The tile map covers every (row, frame, bin) once, F and nf not
    multiples of the tile included."""
    batch, frames, bins = shape
    gx, gy = -(-frames // TILE_F), -(-bins // TILE_K)
    if shape == BENCH:      # one row's first and last tiles stand for all
        blocks = [(0, 0), (gx - 1, gy - 1), (gx - 1, 0), (0, gy - 1)]
        for bx, by in blocks:
            got = pass2_loads(0, bx, by, frames, bins)
            want = {(f, k) for f in range(bx * TILE_F,
                                          min(frames, (bx + 1) * TILE_F))
                    for k in range(by * TILE_K, min(bins, (by + 1) * TILE_K))}
            assert len(got) == len(set(got)) and set(got) == want
        return
    hits = np.zeros((frames, bins), np.int64)
    for bx in range(gx):
        for by in range(gy):
            for f, k in pass2_loads(0, bx, by, frames, bins):
                hits[f, k] += 1
    assert (hits == 1).all()


def _banks(addrs, width):
    """The 4-byte banks a set of ``width``-byte accesses touch."""
    return [(a // 4 + w) % 32 for a in addrs for w in range(width // 4)]


def pass2_geometry(pix):
    """(row bytes, slot bytes, 4-frame slots a row, 4-byte words a row,
    rows a warp's store) of a tile."""
    row_bytes = TILE_F * pix
    words = row_bytes // 4
    return row_bytes, 4 * pix, TILE_F // 4, words, 32 // words


def pass2_tile_writes(pix):
    """{byte address: (bin row, frame)} of every pixel the block's loads
    write into the tile, and each half-warp's (uint8) or quarter-warp's
    (uint16) addresses per store instruction, in the kernel's order (the
    odd row first in lanes 8-15 of a half-warp where rows are 64 bytes)."""
    row_bytes, slot, slots, _, _ = pass2_geometry(pix)
    tile, phases = {}, []
    for warp in range(THREADS // 32):
        first, second = [], []
        for lane in range(32):
            odd_first = pix == 2 and bool(lane & slots)
            rows = (2 * lane + 1, 2 * lane) if odd_first \
                else (2 * lane, 2 * lane + 1)
            for n, r in enumerate(rows):
                base = r * row_bytes + (warp ^ (lane & (slots - 1))) * slot
                (first if n == 0 else second).append(base)
                for i in range(4):
                    assert base + i * pix not in tile
                    tile[base + i * pix] = (r, 4 * warp + i)
        phase = 128 // slot
        for addrs in (first, second):
            phases += [addrs[p0:p0 + phase] for p0 in range(0, 32, phase)]
    return tile, phases


@pytest.mark.parametrize("pix", [2, 4])
def test_pass2_transpose_swizzle(pix):
    """The packed slots written by the loads are the slots the stores read
    (each pixel of the 32 x 64 tile lands once and is read back at its own
    (bin, frame)), and no phase of a shared-memory access has two lanes on
    one bank: 8-byte writes in half-warps (uint8: 64-byte rows, so lanes
    8-15 write their odd row first), 16-byte in quarter-warps (uint16),
    4-byte reads by the whole warp (uint8: two rows an instruction)."""
    row_bytes, slot, slots, words, per = pass2_geometry(pix)
    tile, phases = pass2_tile_writes(pix)
    assert len(tile) == TILE_F * TILE_K
    for addrs in phases:
        banks = _banks(addrs, slot)
        assert len(banks) == len(set(banks))
    for warp in range(THREADS // 32):
        for it in range(TILE_K // (8 * per)):
            reads = []
            for lane in range(32):
                r = per * warp + lane // words + 8 * per * it
                s_ = (r >> 1) & (slots - 1)
                wl = lane % words
                f = 2 * wl if pix == 2 else wl
                a = r * row_bytes + ((f >> 2) ^ s_) * slot + (f & 3) * pix
                assert tile[a] == (r, f)
                if pix == 2:
                    assert tile[a + 2] == (r, f + 1)
                reads.append(a)
            banks = _banks(reads, 4)
            assert len(banks) == len(set(banks)) == 32


def pass2_store_hits(batch, frames, bins, pix):
    """Output pixels written by pass 2's stores (a count each), and the
    byte addresses of each warp store instruction whose 32 lanes all took
    the 4-byte path."""
    _, _, _, words, per = pass2_geometry(pix)
    hits = np.zeros(batch * bins * frames, np.int64)
    full = []
    for b in range(batch):
        for bx in range(-(-frames // TILE_F)):
            for by in range(-(-bins // TILE_K)):
                f0, k0 = bx * TILE_F, by * TILE_K
                for warp in range(THREADS // 32):
                    for it in range(TILE_K // (8 * per)):
                        addrs = []
                        for lane in range(32):
                            r = per * warp + lane // words + 8 * per * it
                            if k0 + r >= bins:
                                continue
                            p0 = (b * bins + k0 + r) * frames + f0
                            wl = lane % words
                            if pix == 2:
                                f = 2 * wl
                                if p0 % 2 == 0 and f0 + f + 1 < frames:
                                    hits[p0 + f: p0 + f + 2] += 1
                                    assert (2 * (p0 + f)) % 4 == 0
                                    addrs.append(2 * (p0 + f))
                                else:
                                    for d in (0, 1):
                                        if f0 + f + d < frames:
                                            hits[p0 + f + d] += 1
                            elif f0 + wl < frames:
                                hits[p0 + wl] += 1
                                addrs.append(4 * (p0 + wl))
                        if len(addrs) == 32:
                            full.append(addrs)
    return hits, full


@pytest.mark.parametrize("pix", [2, 4])
@pytest.mark.parametrize("shape", [(2, 131, 97), (1, 64, 64), (3, 7, 5),
                                   (1, 1122, 70), (2, 131, 192), (1, 70, 193),
                                   (2, 97, 37)])
def test_pass2_stores_write_each_pixel_once(shape, pix):
    """Every output pixel once, at KF's and KD's widths (192 and odd mel
    counts): uint8 two pixels in one 4-byte store where the bin's row
    starts on an even pixel and both frames exist, else one uchar2 each
    (odd F gives rows of both parities); uint16 one ushort2 a lane; a
    warp's full store is 128 contiguous bytes of one bin row (uint16) or
    64 of each of two (uint8)."""
    batch, frames, bins = shape
    hits, full = pass2_store_hits(batch, frames, bins, pix)
    assert (hits == 1).all()
    for addrs in full:
        for part in ((addrs,) if pix == 4 else (addrs[:16], addrs[16:])):
            assert part == list(range(part[0], part[0] + 4 * len(part), 4))
    if frames % 2 == 0 and frames >= 2 and bins >= 2:
        assert full


def pass2_output(pixels, pix):
    """pass 2's data path (loads, packed swizzled slots, stores) on integer
    pixels [B, X, F] laid out as the plain version's planes: the planes the
    stores leave, [B, X, F]."""
    batch, bins, frames = pixels.shape
    row_bytes, slot, slots, _, _ = pass2_geometry(pix)
    tile_map, _ = pass2_tile_writes(pix)
    out = np.zeros_like(pixels)
    for b in range(batch):
        for bx in range(-(-frames // TILE_F)):
            for by in range(-(-bins // TILE_K)):
                f0, k0 = bx * TILE_F, by * TILE_K
                tile = {}
                for a, (r, fl) in tile_map.items():
                    if f0 + fl < frames and k0 + r < bins and a % pix == 0:
                        tile[a] = pixels[b, k0 + r, f0 + fl]
                for r in range(min(TILE_K, bins - k0)):
                    s_ = (r >> 1) & (slots - 1)
                    for fl in range(min(TILE_F, frames - f0)):
                        a = r * row_bytes + ((fl >> 2) ^ s_) * slot \
                            + (fl & 3) * pix
                        out[b, k0 + r, f0 + fl] = tile[a]
    return out


@pytest.mark.parametrize("shape,max_val,mel", [
    ((2, 131, 97), 255, False), ((1, 70, 66), 65535, False),
    ((1, 200, 192), 255, True), ((2, 131, 97), 255, True),
    ((1, 70, 193), 255, True)])
def test_pass2_moves_the_plain_pixels(shape, max_val, mel):
    """The loads, the pixel packing, the swizzled slots and the stores put
    the plain version's pixel (f, k) at output (k, f): the whole data path
    of pass 2 on the plain version's values, KF's (a range a channel) and
    KD's (``mel``: one range a row; the bench's 192 mels, odd counts)."""
    batch, frames, bins = shape
    pix = 4 if max_val > 255 else 2
    spec = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (batch, frames, bins, 2)) * 20).astype(np.float32))
    ref = (quantize.quantize_mel_plane_plain(spec) if mel else
           quantize.quantize_planes_plain(spec, max_val))[0].numpy()
    q = ref.astype(np.uint32)                       # [B, nf, F, 2]
    pixels = q[..., 0] | (q[..., 1] << (4 * pix))    # [B, nf, F]
    np.testing.assert_array_equal(pass2_output(pixels, pix), pixels)


# -- KD: KF's passes with global extrema ---------------------------------------

MEL_BENCH = (2, 1122, 192)
MEL_MASKED = (4, 1122, 192)


def kd_extrema(spec, frames, offset):
    """KD's pass 1 replayed: each row's counted floats (quads, head, tail
    as pass1_cover walks them from a base ``offset`` floats past 16 bytes),
    per channel from the masked start, then the fold's merge of the two
    channels by NaN-propagating max and min."""
    batch, n_frames, mels, _ = spec.shape
    row = n_frames * mels * 2
    parts = planes_parts(batch, row)
    flat = spec.reshape(batch, -1)
    mx = np.empty(batch, np.float32)
    mn = np.empty(batch, np.float32)
    for b in range(batch):
        count, lo, hi = masked_count(row, n_frames, 2 * mels,
                                     None if frames is None else frames[b])
        cover, heads, tails, _ = pass1_cover(count, 4096 + 4 * offset, parts)
        assert (cover == 1).all()
        idx = np.concatenate([heads, len(heads) + np.arange(4 * cover.size),
                              tails]).astype(np.int64)
        ch_mx, ch_mn = [], []
        for c in range(2):
            vals = flat[b, idx[idx % 2 == c]]
            ch_mx.append(np.maximum.reduce(np.append(vals, lo).astype(
                np.float32)))
            ch_mn.append(np.minimum.reduce(np.append(vals, hi).astype(
                np.float32)))
        mx[b] = np.maximum(ch_mx[0], ch_mx[1])
        mn[b] = np.minimum(ch_mn[0], ch_mn[1])
    return mx, mn


@pytest.mark.parametrize("shape,frames,offset", [
    (MEL_BENCH, None, 0), (MEL_BENCH, None, 1),
    (MEL_MASKED, [1122, 843, 562, 0], 0), (MEL_MASKED, [1122, 843, 562, 0], 1),
    ((3, 41, 37), None, 1), ((3, 41, 37), [41, 17, 0], 3),
    ((3, 41, 37), [0, 0, 0], 2), ((2, 5, 3), [1, 9], 2)])
@pytest.mark.parametrize("nan", [None, "counted", "pad"])
def test_kd_global_fold_is_the_plain_extrema(shape, frames, offset, nan):
    """KD's extrema on KF's pass-1 plan with the channels merged in the
    fold: the plain version's max and min bit for bit at the bench, masked
    and odd shapes, frames 0, partial and full, a base one float (or 2, 3)
    off 16 bytes; a NaN in a counted frame makes the row's extrema NaN and
    every pixel 127, one in a pad frame is ignored; frames 0 give the
    -+FLT_MAX sentinels and every pixel 127."""
    batch, n_frames, mels = shape
    rng = np.random.default_rng(sum(shape) + offset)
    spec = (rng.standard_normal((batch, n_frames, mels, 2)) * 3 - 4).astype(
        np.float32)
    nan_row = None
    if nan == "counted":
        nan_row = 0 if frames is None or frames[0] > 0 else None
        if nan_row is not None:
            spec[0, 0, mels - 1, 1] = np.nan
    elif nan == "pad" and frames is not None:
        b = next((i for i, f in enumerate(frames) if f < n_frames), None)
        if b is not None:
            spec[b, n_frames - 1, 0, 0] = np.nan
    mx, mn = kd_extrema(spec, frames, offset)
    tf = None if frames is None else torch.tensor(frames)
    img, ref_mx, ref_mn = quantize.quantize_mel_plane_plain(
        torch.from_numpy(spec), 255, tf)
    np.testing.assert_array_equal(mx, ref_mx.numpy().reshape(batch))
    np.testing.assert_array_equal(mn, ref_mn.numpy().reshape(batch))
    if nan_row is not None:
        assert np.isnan(mx[nan_row]) and bool((img[nan_row] == 127).all())
    if nan == "pad":
        assert not np.isnan(mx).any()
    for b, f in enumerate(frames or []):
        if f <= 0:
            big = np.finfo(np.float32).max
            assert (mx[b], mn[b]) == (-big, big)
            assert bool((img[b] == 127).all())


# -- KI ------------------------------------------------------------------------

def ki_runs(batch, frames):
    """(b, f0, run) of every run, in the order of r = b runs_per_row + i."""
    per_row = -(-frames // RUN)
    out = []
    for r in range(batch * per_row):
        b, i = divmod(r, per_row)
        f0 = i * RUN
        out.append((b, f0, min(RUN, frames - f0)))
    return out


@pytest.mark.parametrize("frames", [1122, 843, 1, RUN - 1, RUN])
@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("grid", [1, 7, 132 * 4, 10 ** 6])
def test_ki_runs_cover_each_frame_once(frames, batch, grid):
    """Blocks g, g + grid, ... over the runs: each run once whatever the
    grid (it is min(runs, resident blocks)), each (row, frame) in one run,
    runs of kMelRun frames and a short last one of a row (F = 1122, 843, 1,
    F below one run); a run's output rows are b F + f0 ... in order."""
    runs = ki_runs(batch, frames)
    grid = min(grid, len(runs))
    taken = np.zeros(len(runs), np.int64)
    for g in range(grid):
        taken[g::grid] += 1
    assert (taken == 1).all()
    seen = np.zeros(batch * frames, np.int64)
    for b, f0, run in runs:
        assert 1 <= run <= RUN and f0 % RUN == 0
        seen[b * frames + f0 + np.arange(run)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("mels,frames,f0", [(192, 1122, 0), (192, 1122, 1120),
                                            (40, 3, 0), (160, 843, 840)])
@pytest.mark.parametrize("quantized", [True, False])
def test_ki_prologue_reads_contiguous_runs(mels, frames, f0, quantized):
    """uint8: item i is mel i / 2T, byte i % 2T of its run, so each mel
    row's run is 2 run contiguous bytes of the [B, M, F, 2] planes; float:
    the run's T x 2M floats in order; every (frame, mel, channel) of the run
    lands once in its shared-memory slot t (2M + 2) + 2m + c."""
    b = 1
    run = min(RUN, frames - f0)
    stride = 2 * mels + 2
    total = mels * 2 * RUN if quantized else run * 2 * mels
    slots, addrs = {}, {}
    for i in range(total):
        if quantized:
            m, o = divmod(i, 2 * RUN)
            if o >= 2 * run:
                continue
            t, c = o >> 1, o & 1
            addr = ((b * mels + m) * frames + f0) * 2 + o
            assert addr == ((b * mels + m) * frames + f0 + t) * 2 + c
            e = (o >> 1) * stride + 2 * m + (o & 1)
        else:
            t, j = divmod(i, 2 * mels)
            m, c = divmod(j, 2)
            addr = (b * frames + f0) * 2 * mels + i
            assert addr == ((b * frames + f0 + t) * mels + m) * 2 + c
            e = t * stride + j
        addrs.setdefault(m, []).append(addr)
        assert e not in slots
        slots[e] = (t, m, c)
    assert len(slots) == run * mels * 2
    if quantized:
        for a in addrs.values():
            assert a == list(range(a[0], a[0] + 2 * run))


def ki_frame_walk(row, bins, t, vec=False):
    """(output index, store kind, warp, instruction) of every store the
    block makes for frame t of its run (output row ``row``): warp w takes
    frame w % T and the chunks from the (w / T)-th on, lane l the outputs l,
    l + 32, ... of a chunk; with 16-byte stores (the ablation) a head first
    and each chunk's lane l stores outputs 4l .. 4l + 3."""
    outs, parts = bins + 1, WARPS // RUN
    h = (4 - (row * outs) % 4) % 4 if vec else 0
    h = min(h, outs)
    out = []
    for w in range(WARPS):
        if w % RUN != t:
            continue
        part = w // RUN
        if vec and part == 0:
            out += [(j, "f1", w, "head") for j in range(h)]
        for j0 in range(h + part * CHUNK, outs, parts * CHUNK):
            if vec:
                for lane in range(32):
                    j = j0 + 4 * lane
                    if j + 3 < outs:
                        assert (row * outs + j) % 4 == 0
                        out += [(j + q, "f4", w, j0) for q in range(4)]
                    else:
                        out += [(j + q, "f1", w, j0) for q in range(4)
                                if j + q < outs]
            else:
                for u in range(CHUNK // 32):
                    out += [(j0 + lane + 32 * u, "f1", w, (j0, u))
                            for lane in range(32) if j0 + lane + 32 * u < outs]
    return out


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("bins", [2048, 1500, 256, 8192, 20])
@pytest.mark.parametrize("rows", [(0, 1, 2, 3), (1122, 1123), (1965, 2243)])
def test_ki_store_walk_writes_each_output_once(bins, rows, vec):
    """Each of a frame's n/2 + 1 outputs once, across batch rows and any
    row offset mod 4; a float a lane: each warp instruction 32 consecutive
    outputs (128 contiguous bytes); 16-byte stores (the ablation): every
    chunk 16-byte aligned in [B F, n/2 + 1]."""
    for row in rows:
        for t in range(RUN):
            walk = ki_frame_walk(row, bins, t, vec)
            assert sorted(j for j, _, _, _ in walk) == list(range(bins + 1))
            if not vec:
                groups = {}
                for j, _, w, key in walk:
                    groups.setdefault((w, key), []).append(j)
                for js in groups.values():
                    assert js == list(range(js[0], js[0] + len(js)))
                    assert len(js) == 32 or js[-1] == bins


@pytest.mark.parametrize("cfg", [MelConfig.cli_default(),
                                 MelConfig(resolut=3000, window=750),
                                 MelConfig(num_mels=512),
                                 MelConfig(num_mels=40, resolut=512,
                                           window=128),
                                 MelConfig(num_mels=128, resolut=16384,
                                           window=4096)])
def test_ki_shared_table_is_band_tables(cfg):
    """The planes a block stages (2 first mel | count << 16, then each tap;
    2 or 4 planes as the launch picks, else the first only) are
    ``_band_table``'s, and the chain each output runs over them (Nyquist:
    bin n/2 - 1 on channel 1) visits the banded U's row: its non-zeros in
    ascending mel order."""
    u = inverse_mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                            cfg.mel_fmax).astype(np.float32)
    first, count, taps = (t.numpy() for t in
                          mel_ops._band_table(torch.from_numpy(u)))
    bins, max_taps = u.shape[0], taps.shape[1]
    k_taps = 2 if max_taps <= 2 else 4 if max_taps <= 4 else 0
    assert 2 * cfg.num_mels <= 0xffff
    hdr = (2 * first.astype(np.uint32)) | (count.astype(np.uint32) << 16)
    planes = [np.where(t < max_taps, taps[:, min(t, max_taps - 1)], 0)
              for t in range(k_taps)]
    for j in range(bins + 1):
        k = min(j, bins - 1)
        at = int(hdr[k] & 0xffff) + (j - k)
        cnt = int(hdr[k] >> 16)
        assert k_taps == 0 or cnt <= k_taps
        w = [planes[t][k] if k_taps else taps[k, t] for t in range(cnt)]
        idx = at + 2 * np.arange(cnt)          # e index: 2 mel + channel
        assert (idx % 2 == (j - k)).all()
        dense = np.zeros(cfg.num_mels, np.float32)
        dense[idx // 2] = w
        np.testing.assert_array_equal(dense, u[k])
