"""The band table and walks of kernels KC and KL, replayed on the CPU.

csrc/mel_bands.cuh sums each log-mel column over its band's span of bins
from the packed band table of ops/mel_ops.mel_band_plan: bands sorted by
width in groups of 16 (lanes 2i and 2i + 1 of a warp take band i's two
channels), the groups balanced over 4 warps, each group's weights t-major.
The block's warps walk the items (frame, group) warp, warp + warps, ...;
KC's standalone kernel (csrc/mel_log.cu) copies tiles of frames into shared
memory as 16-byte chunks of the span rounded out to 16 bytes. KL
(csrc/dequantize.cu) walks quads of 4 elements (one load, one float4
store; channel 0 on the even lanes, 1 on the odd), 4 quads a grid stride
apart a thread, then the rest one element a thread. No CUDA kernel runs
here, so this
file replays those walks in numpy: the table holds every non-zero of W_ext
and nothing else, the walk writes each (frame, column) once and visits its
terms as the earlier dense-span loop did (ascending bins, one float32 fmaf
chain, the same bits), ops/mel_ops.fused_route picks the fused launch exactly where
KB's power-of-two kernel runs, and KL's tiling covers every element once
with its channel's constants, giving dequantize_raw_plain's bits. No JAX.
"""
import re

import numpy as np
import pytest
import torch

from gomel_tpu_torch.core.config import MelConfig
from gomel_tpu_torch.core.filterbank import mel_weights
from gomel_tpu_torch.ops import fftbackend, mel_ops, quantize, rfft_mag

F32, F64 = np.float32, np.float64
CONFIGS = [MelConfig.cli_default(),
           MelConfig(num_mels=40, resolut=512, window=128),
           MelConfig(resolut=3000, window=750)]
IDS = ["cli", "40-mel-512", "n3000"]


def _weights(cfg) -> np.ndarray:
    return mel_weights(cfg.n_bins, cfg.num_mels, cfg.mel_fmin,
                       cfg.mel_fmax).astype(F32)


def fmaf(a, b, c):
    """float32 fma(a, b, c), one rounding: the product is exact in float64,
    the sum's float64 rounding error comes back by TwoSum, and it decides
    the float32 rounding where the float64 sum sits on a float32 midpoint
    (the one case where rounding twice differs from rounding once)."""
    a, b, c = (np.asarray(v, F32).astype(F64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(F32)
    r64 = r.astype(F64)
    with np.errstate(invalid="ignore"):
        toward = np.where(s > r64, np.inf, -np.inf).astype(F32)
        other = np.nextafter(r, toward)
        mid = (r64 + other.astype(F64)) / 2
        fix = (s == mid) & (e != 0) & (s != r64)
        pick_other = fix & (np.sign(other.astype(F64) - s) == np.sign(e))
    return np.where(pick_other, other, r).astype(F32)


def test_fmaf_rounds_once():
    """The emulation where the float64 sum lands on a float32 midpoint:
    1 + (2^-24 + 2^-60) rounds up (rounding to float64 first would tie to
    1), 1 + (2^-24 - 2^-60) down, and exact ties go to even."""
    one, up = F32(1.0), np.nextafter(F32(1.0), F32(2.0))
    # 2^36 + 1 = 1774001 x 38737 and 2^36 - 1 = 262143 x 262145, each
    # factor exact in float32
    s = 2.0 ** -30
    assert 1774001 * 38737 == 2 ** 36 + 1
    assert fmaf(F32(1774001 * s), F32(38737 * s), one) == up
    assert fmaf(F32(262143 * s), F32(262145 * s), one) == one
    assert fmaf(F32(2.0 ** -12), F32(2.0 ** -12), one) == one
    assert fmaf(F32(2.0 ** -12), F32(2.0 ** -12), up) == np.nextafter(
        up, F32(2.0))
    assert fmaf(F32(3), F32(5), F32(-15)) == 0


# -- the band table ------------------------------------------------------------

def _scatter(plan: mel_ops.MelBandPlan, bins: int, cols: int) -> np.ndarray:
    """The dense [bins, cols] the table describes, each term written once."""
    dense = np.zeros((bins, cols), F32)
    seen = np.zeros((bins, cols), np.int64)
    for lo, width, col, woff in plan.slots:
        if col < 0:
            assert width == 0
            continue
        for c in (0, 1):
            for t in range(width):
                dense[lo + c + t, col + c] = plan.weights[woff + 16 * t]
                seen[lo + c + t, col + c] += 1
    assert seen.max() <= 1
    return dense


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_band_table_holds_w_ext(cfg):
    """Scattered back, the packed table is W_ext exactly: every non-zero and
    nothing else; each band has one slot, its weights once."""
    w = _weights(cfg)
    plan = mel_ops.mel_band_plan(w)
    we = mel_ops.extended_weights_np(w)
    np.testing.assert_array_equal(_scatter(plan, *we.shape), we)
    bands = sorted(int(c) // 2 for c in plan.slots[:, 2] if c >= 0)
    assert bands == list(range(cfg.num_mels))
    assert plan.groups % mel_ops.KC_WARPS == 0
    assert len(plan.slots) == 16 * plan.groups
    # weights past a band's width (a group's padding) are zeros
    used = np.zeros(plan.weights.size, bool)
    for lo, width, col, woff in plan.slots:
        used[woff + 16 * np.arange(width)] = True
    assert not plan.weights[~used].any()


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_band_table_balances_the_warps(cfg):
    """A group's bands are a run of the width order (so a warp's lanes
    diverge little), and each warp's share of the warp-steps (a group costs
    its widest span) is at most its fair share plus the widest group."""
    plan = mel_ops.mel_band_plan(_weights(cfg))
    width = plan.slots[:, 1].reshape(plan.groups, 16)
    live = plan.slots[:, 2].reshape(plan.groups, 16) >= 0
    cost = np.where(live, width, 0).max(axis=1)
    loads = [int(cost[w::mel_ops.KC_WARPS].sum())
             for w in range(mel_ops.KC_WARPS)]
    assert max(loads) <= sum(loads) / mel_ops.KC_WARPS + cost.max()
    runs = sorted((int(width[g][live[g]].min()), int(width[g][live[g]].max()))
                  for g in range(plan.groups) if live[g].any())
    assert all(a[1] <= b[0] for a, b in zip(runs, runs[1:]))


def test_extended_weight_spans_are_the_table_spans():
    """_extended_weights' column spans (what tests/test_torch_ops.py holds to
    W_ext) are the table's band spans, channel 1 one bin up."""
    w = _weights(MelConfig.cli_default())
    _, lo, hi = mel_ops._extended_weights(torch.from_numpy(w))
    plan = mel_ops.mel_band_plan(w)
    for s_lo, width, col, _ in plan.slots:
        if col >= 0:
            for c in (0, 1):
                assert (int(lo[col + c]), int(hi[col + c])) == (
                    (s_lo + c, s_lo + c + width) if width else (0, 0))


# -- the column walk -----------------------------------------------------------

def walk(plan: mel_ops.MelBandPlan, rows: int, warps: int):
    """(frame, column, [bins], [weights]) of every lane of every item of
    mel_band_sums on a block of ``warps`` warps over ``rows`` frames."""
    for warp in range(warps):
        for r, p in carried_walk(plan.groups, rows, warps, 1, warp):
            assert p % mel_ops.KC_WARPS == warp % mel_ops.KC_WARPS
            for lane in range(32):
                lo, width, col, woff = plan.slots[16 * p + lane // 2]
                if col < 0:
                    continue
                c = lane & 1
                t = np.arange(width)
                yield r, col + c, lo + c + t, plan.weights[woff + 16 * t]


def span_terms(w: np.ndarray, col: int):
    """The earlier kernel's terms of column ``col``
    (tools/mel_dequant_earlier.cu ``old_mel_log_kernel``): bins [lo, hi) of
    W_ext's non-zero span, ascending, with W_ext's weights."""
    we = mel_ops.extended_weights_np(w)
    nz = np.flatnonzero(we[:, col])
    if nz.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, F32)
    k = np.arange(nz[0], nz[-1] + 1)
    return k, we[k, col]


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
@pytest.mark.parametrize("rows,warps", [(1, 4), (8, 4), (2, 8), (3, 16),
                                        (4, 8)])
def test_walk_writes_each_column_once_in_span_order(cfg, rows, warps):
    """Each (frame, column) written once; its terms are the earlier loop's,
    bin for bin and weight for weight (KB's blocks: 4, 8 or 16 warps over
    1-128 frames; KC's: 8 warps over a tile)."""
    w = _weights(cfg)
    plan = mel_ops.mel_band_plan(w)
    cols = 2 * cfg.num_mels
    hits = np.zeros((rows, cols), np.int64)
    want = {c: span_terms(w, c) for c in range(cols)}
    for r, col, k, wt in walk(plan, rows, warps):
        hits[r, col] += 1
        np.testing.assert_array_equal(k, want[col][0])
        np.testing.assert_array_equal(wt, want[col][1])
    assert (hits == 1).all()


def carried_walk(groups: int, rows: int, warps: int, rows_an_item: int,
                 warp: int):
    """mel_band_sums's items of one warp as the kernel finds them: (row
    block, position) carried from item to item by adds (mel_next_item),
    no division an item."""
    rb, p = 0, warp
    while p >= groups:
        p -= groups
        rb += 1
    out = []
    while rb * rows_an_item < rows:
        out.append((rb, p))
        p += warps
        while p >= groups:
            p -= groups
            rb += 1
    return out


@pytest.mark.parametrize("groups", [4, 8, 12, 16, 36])
@pytest.mark.parametrize("warps", [4, 8, 16])
@pytest.mark.parametrize("rows,rows_an_item", [(1, 1), (3, 1), (128, 1),
                                               (4, 4), (7, 4), (16, 2)])
def test_carried_walk_is_the_divided_walk(groups, warps, rows, rows_an_item):
    """Each warp's items, carried by adds, are the items i = warp, warp +
    warps, ... of (rows / rows_an_item) x groups split as (i / groups,
    i % groups): the same items, in the same order, on the same warps."""
    items = -(-rows // rows_an_item) * groups
    for warp in range(warps):
        want = [divmod(i, groups) for i in range(warp, items, warps)]
        assert carried_walk(groups, rows, warps, rows_an_item, warp) == want


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_walk_chain_gives_the_span_loop_bits(cfg):
    """The walk's float32 fmaf chains, clamped at 1e-5, give the bits of the
    earlier loop's (and approach the float64 dense product)."""
    w = _weights(cfg)
    plan = mel_ops.mel_band_plan(w)
    rng = np.random.default_rng(5)
    mags = (rng.standard_normal((3, cfg.n_bins + 1)) ** 2 * 50).astype(F32)
    mags[1, :40] = 0.0                        # bands that clamp at 1e-5
    got = np.full((3, 2 * cfg.num_mels), np.nan, F32)
    for r, col, k, wt in walk(plan, 3, 4):
        acc = F32(0.0)
        for kk, ww in zip(k, wt):
            acc = fmaf(mags[r, kk], ww, acc)
        got[r, col] = max(acc, F32(1e-5))
    ref = np.empty_like(got)
    for col in range(2 * cfg.num_mels):
        k, wt = span_terms(w, col)
        acc = np.zeros(3, F32)
        for kk, ww in zip(k, wt):
            acc = fmaf(mags[:, kk], np.full(3, ww, F32), acc)
        ref[:, col] = np.maximum(acc, F32(1e-5))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    dense = mags.astype(F64) @ mel_ops.extended_weights_np(w).astype(F64)
    np.testing.assert_allclose(got, np.maximum(dense, 1e-5), rtol=2e-6)


# -- KC's tiles ------------------------------------------------------------------

MEL_TILE_BYTES, MEL_TILE_MAX_ROWS = 9 * 1024, 16   # csrc/mel_log.cu


def kc_tiles(bins: int):
    """gomel_mel_log's tile rows and stage floats."""
    tile_rows = min(max(MEL_TILE_BYTES // (bins * 4), 1), MEL_TILE_MAX_ROWS)
    return tile_rows, (tile_rows * bins + 8 + 3) // 4 * 4


@pytest.mark.parametrize("bins", [2049, 257, 1501, 8193, 3])
@pytest.mark.parametrize("offset", [0, 1, 2, 3, 7])
def test_kc_tile_copy_covers_its_rows(bins, offset):
    """Each tile's 16-byte chunks (the span rounded out to 16 bytes) hold
    its rows at the skip the kernel indexes from, within the stage."""
    rows = 37
    tile_rows, stage = kc_tiles(bins)
    assert stage % 4 == 0 and tile_rows >= 1
    base = 4096 + 4 * offset                  # the magnitudes' byte address
    for tile in range(-(-rows // tile_rows)):
        r0 = tile * tile_rows
        n = min(rows - r0, tile_rows) * bins
        first = base + 4 * r0 * bins
        a0 = first & ~15
        end = first + 4 * n
        chunks = ((end - a0) // 4 + 3) // 4
        assert a0 % 16 == 0 and a0 + 16 * chunks >= end
        assert 4 * chunks <= stage
        skip = (first - a0) // 4
        assert 0 <= skip < 4 and skip + n <= 4 * chunks


# -- the fused route -------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 16, 512, 2048, 4096, 16384, 32768, 3000,
                               514, 6, 1000])
@pytest.mark.parametrize("backend", ["auto", "auto_lowp", "mxu", "xla", "mm"])
def test_fused_route_is_kbs_pow2_kernel(n, backend):
    """The fused launch where KB's power-of-two kernel would run (the hand
    kernels' route, n/2 a power of two), never on the CPU; the same errors
    as fftbackend.resolve for a name or size it refuses."""
    try:
        route = fftbackend.resolve(backend, n, "cuda")
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            mel_ops.fused_route(n, backend, "cuda")
        return
    m = n // 2
    pow2 = n % 2 == 0 and m >= 2 and m & (m - 1) == 0
    assert mel_ops.fused_route(n, backend, "cuda") == (route == "mxu" and pow2)
    if route == "mxu":
        assert rfft_mag.supported(n)
    assert not mel_ops.fused_route(n, backend, "cpu")


def test_mel_encode_on_the_cpu_stays_plain():
    """On the CPU mel_encode runs KB's and KC's plain versions: no fused
    launch counted, the same values as the two plain versions."""
    cfg = MelConfig(num_mels=40, resolut=512, window=128)
    w = torch.from_numpy(_weights(cfg))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3000)).astype(F32))
    before = mel_ops.FUSED_KERNEL.launches
    out = mel_ops.mel_encode(x, cfg.num_mels, 512, 128, w)
    assert mel_ops.FUSED_KERNEL.launches == before
    win = mel_ops.window_like(None, 512, x)
    ref = mel_ops.stft_mel_log_plain(x, win, 512, 128, w)
    assert torch.equal(out, ref)
    assert torch.equal(mel_ops.stft_mel_log(x, win, 512, 128, w), ref)


# -- KL's tiling -----------------------------------------------------------------

UNROLL = 4      # kDequantUnroll: quads a thread has in flight


def kl_launch(src_addr: int, out_addr: int, n: int, size: int, ext_len: int):
    """launch_dequantize's quads and load path for a source and an output at
    those byte addresses."""
    quads = n // 4 if ext_len <= 2 and out_addr % 16 == 0 else 0
    return quads, src_addr % (4 * size) == 0


def kl_walk(n, quads, ext_len, threads):
    """(element, channel) of every element the kernel writes, over all
    ``threads`` threads of the grid (any grid: the loops stride by it)."""
    for tid in range(threads):
        c1 = 1 if ext_len == 2 else 0
        for q0 in range(tid, quads, UNROLL * threads):
            for u in range(UNROLL):
                q = q0 + u * threads
                if q < quads:
                    for lane in range(4):
                        yield 4 * q + lane, c1 if lane & 1 else 0
        for i in range(4 * quads + tid, n, threads):
            yield i, (0 if ext_len == 1 else i % ext_len)


@pytest.mark.parametrize("dtype,max_val", [(np.uint8, 255),
                                           (np.uint16, 65535)])
@pytest.mark.parametrize("ext_len", [1, 2, 3])
@pytest.mark.parametrize("offset,n", [(0, 4096), (0, 4097), (1, 1001),
                                      (3, 35), (5, 7), (2, 0), (7, 16)])
@pytest.mark.parametrize("threads", [1, 5, 96])
def test_kl_tiling_covers_each_element_once(dtype, max_val, ext_len, offset,
                                            n, threads):
    """Every element once, with element i % ext_len's constants (the
    channel the kernel takes from the lane), and the kernel's rounded steps
    on those constants give dequantize_raw_plain's bits; an odd n and a base
    off the load width (offset elements on) included."""
    size = np.dtype(dtype).itemsize
    n -= n % ext_len
    quads, vec_load = kl_launch(4096 + size * offset, 8192, n, size, ext_len)
    assert vec_load == (offset % 4 == 0)
    rng = np.random.default_rng(9)
    img = rng.integers(0, max_val + 1, n, dtype=dtype)
    maxs = np.array([2.0, 1.25, 3.5][:ext_len], F32)
    mins = np.array([-1.75, -0.5, 0.25][:ext_len], F32)
    out = np.full(n, np.nan, F32)
    hits = np.zeros(n, np.int64)
    for i, c in kl_walk(n, quads, ext_len, threads):
        assert c == i % ext_len
        hits[i] += 1
        s = F32(img[i]) / F32(max_val)
        out[i] = s * (maxs[c] - mins[c]) + mins[c]
    assert (hits == 1).all()
    shape = (-1, ext_len) if ext_len > 1 else (-1,)
    ref = quantize.dequantize_raw_plain(
        torch.from_numpy(img.reshape(shape)),
        torch.from_numpy(maxs if ext_len > 1 else maxs[:1].reshape(())),
        torch.from_numpy(mins if ext_len > 1 else mins[:1].reshape(())),
        max_val).reshape(-1).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("size", [1, 2])
@pytest.mark.parametrize("ext_len", [1, 2, 3])
@pytest.mark.parametrize("out_addr", [8192, 8196])
def test_kl_quads_only_where_float4_stores_may_go(size, ext_len, out_addr):
    """Quads (float4 stores of 4 elements whose channels alternate from
    channel 0) only for one or two channels and a 16-byte aligned output;
    the quads' loads one wide load exactly when the source is aligned to 4
    elements."""
    quads, _ = kl_launch(4096, out_addr, 1003, size, ext_len)
    assert quads == (1003 // 4 if ext_len <= 2 and out_addr == 8192 else 0)
    for offset in range(8):
        _, vec_load = kl_launch(4096 + size * offset, 8192, 1003, size, 2)
        assert vec_load == (offset % 4 == 0)
