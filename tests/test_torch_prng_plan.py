"""The walk and the rotation of kernel KP, replayed on the CPU.

KP (csrc/threefry.cu) draws JAX's Threefry-2x32 samples: blockIdx.y walks
the key table's rows, and the row's blocks split it into a head of up to 3
samples to the first 16-byte boundary, groups of kSamples consecutive
samples (thread t takes groups t, t + stride, ..., one 16-byte store a
group) and a tail of fewer than kSamples; block 0's threads draw the head
and the tail one sample each. The grid is the card's resident blocks shared
by the rows (fewer where a row has less work), one wave. A rotation is a
funnel shift; the 64-bit product x * 2^r (lo | hi) is the same rotation,
and tools/profile_prng.py's "wide" build.

No CUDA kernel runs here, so this file replays the walk in numpy (every
(row, sample) written once, each group's store aligned, for every
per_key % 4, rows 1, 3 and 70,000, grids of one block and of the card; one
wave of blocks) and the kernel's round arithmetic, in both rotation forms,
against ``prng.threefry2x32`` and the plain version. The constants are the
source's. No JAX.
"""
import os
import re

import numpy as np
import pytest

from gomel_tpu_torch.ops import _cuda, prng

with open(os.path.join(_cuda.CSRC_DIR, "threefry.cu")) as _f:
    SOURCE = _f.read()


def _const(name: str) -> int:
    m = re.search(rf"constexpr (?:int|unsigned) {name} = (\w+);", SOURCE)
    assert m, f"{name} not in threefry.cu"
    return int(m.group(1).rstrip("u"), 0)


def _table(name: str) -> list[int]:
    m = re.search(rf"constexpr int {name}\[4\] = \{{([\d, ]+)\}};", SOURCE)
    assert m, f"{name} not in threefry.cu"
    return [int(v) for v in m.group(1).split(",")]


THREADS = _const("kThreefryThreads")
SAMPLES = _const("kSamples")
PARITY = _const("kParity")
ROTATE = _table("kEven") + _table("kOdd")
# an H100 SXM: 132 SMs x 8 resident blocks of 256 threads
CARD = 132 * 8
M32 = 0xFFFFFFFF


def test_constants_are_the_designs():
    """256-thread blocks, 4 samples a thread (one float4), JAX's parity
    constant and Threefry-2x32's rotation amounts."""
    assert (THREADS, SAMPLES, PARITY) == (256, 4, 0x1BD11BDA)
    assert ROTATE == [13, 15, 26, 6, 17, 29, 16, 24]
    assert [r for pair in prng._ROTATIONS for r in pair] == ROTATE


# -- the grid and the walk -----------------------------------------------------

def grid(rows, per_key, resident=CARD):
    """csrc/threefry.cu gomel_threefry_uniform: (blocks a row, rows of the
    grid, trips of a row's threads)."""
    by = min(rows, 65535)
    groups = per_key // SAMPLES
    one_trip = -(-groups // THREADS)
    bx = max(1, min(resident // by, one_trip))
    return bx, by, -(-groups // (bx * THREADS))


def row_walk(base, r, per_key, bx):
    """(sample counts of row r, group starts, head, tail, trips used) of the
    kernel's walk over one row whose first float is at byte ``base + 4 r
    per_key``."""
    addr = base + 4 * r * per_key
    head = min(((16 - addr % 16) % 16) // 4, per_key)
    groups = (per_key - head) // SAMPLES
    stride = bx * THREADS
    hits = np.zeros(per_key, np.int64)
    starts = head + SAMPLES * np.arange(groups, dtype=np.int64)
    # thread t draws groups t, t + stride, ...: each group once
    owner = np.arange(groups) % stride
    trip = np.arange(groups) // stride
    assert (owner * 1 + trip * stride == np.arange(groups)).all()
    for u in range(SAMPLES):
        hits[starts + u] += 1
    # block 0: threads 0-7 the head (j = t < head), 8 on the tail
    for t in range(8 + SAMPLES):
        j = t if t < 8 else head + groups * SAMPLES + (t - 8)
        if (j < head) if t < 8 else (j < per_key):
            hits[j] += 1
    return hits, starts, head, per_key - head - groups * SAMPLES, \
        int(trip.max()) + 1 if groups else 0


@pytest.mark.parametrize("per_key", [4000, 1001, 1002, 1003, 1, 2, 3, 5,
                                     2877952])
@pytest.mark.parametrize("rows", [1, 3, 70000])
@pytest.mark.parametrize("resident", [1, CARD])
def test_walk_writes_each_sample_once(per_key, rows, resident):
    """Each (row, sample) once: the y-walk takes every row once (70,000 rows
    are more than gridDim.y's 65,535), and in a row the head, the groups and
    the tail cover every sample once, for every per_key % 4 (so rows start
    4, 8 or 12 bytes past 16) and on a grid of one block or of the card;
    each group's 16-byte store is aligned."""
    bx, by, trips = grid(rows, per_key, resident)
    assert 1 <= by <= 65535 and bx >= 1
    taken = np.zeros(rows, np.int64)
    for y in range(by):
        taken[y::by] += 1
    assert (taken == 1).all()
    base = 4096
    for r in sorted({0, 1, 2, 3, rows - 1} & set(range(rows))):
        hits, starts, head, tail, used = row_walk(base, r, per_key, bx)
        assert (hits == 1).all()
        assert head <= 3 and tail < SAMPLES
        if starts.size:
            assert ((base + 4 * (r * per_key + starts)) % 16 == 0).all()
        assert used <= max(trips, 1)


@pytest.mark.parametrize("rows,per_key", [(1, 2877952), (2, 1438976),
                                          (4, 1438976), (1, 21600000),
                                          (1, 12345), (3, 1001), (70000, 3)])
@pytest.mark.parametrize("resident", [1, 7, CARD])
def test_grid_is_one_wave(rows, per_key, resident):
    """The grid holds at most the card's resident blocks (one wave, so the
    SMs hold the same number of blocks but for one), all of them where the
    rows have the work, and no more blocks a row than one trip of every
    group needs; a row's trips cover its groups with less than one trip's
    threads to spare."""
    bx, by, trips = grid(rows, per_key, resident)
    groups = per_key // SAMPLES
    one_trip = -(-groups // THREADS)
    if resident >= by:
        assert bx * by <= resident
        assert bx == one_trip or bx * by > resident - by
    else:
        assert bx == 1
    assert bx <= max(one_trip, 1)
    assert trips * bx * THREADS >= groups
    assert groups == 0 or (trips - 1) * bx * THREADS < groups


# -- the round arithmetic ------------------------------------------------------

def rotl_funnel(x, r):
    """The kernel's rotation: __funnelshift_l(x, x, r), the high word of the
    64-bit (x : x) << r."""
    both = (x.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    return ((both << np.uint64(r)) >> np.uint64(32)).astype(np.uint32)


def rotl_wide(x, r):
    """The ablation's rotation: the 64-bit product x * 2^r, its low word OR
    its high word."""
    p = x.astype(np.uint64) * np.uint64(1 << r)
    return (p & np.uint64(M32)).astype(np.uint32) | (p >> np.uint64(32)).astype(
        np.uint32)


def kernel_block(k0, k1, lo, hi=0, rotl=rotl_funnel):
    """csrc/threefry.cu draw(): one Threefry-2x32 block of counter (hi, lo)
    under key (k0, k1), in numpy uint32, with the kernel's rotation and its
    key injections (``rotl``: its funnel shift, or the ablation's product);
    returns (x0, x1). The kernel's counter high word is 0 (x0 starts at
    k0); the known answers give it others."""
    k0, k1, lo = (np.asarray(v, np.uint32) for v in (k0, k1, lo))
    k2 = k0 ^ k1 ^ np.uint32(PARITY)
    ks = (k0, k1, k2)
    with np.errstate(over="ignore"):
        x0 = np.uint32(hi) + k0 + np.zeros_like(lo)
        x1 = lo + k1
        for i in range(5):
            for r in ROTATE[4 * (i % 2): 4 * (i % 2) + 4]:
                x0 = x0 + x1
                x1 = rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


@pytest.mark.parametrize("rotl", [rotl_funnel, rotl_wide])
def test_rotations_are_rotations(rotl):
    """The funnel shift and lo | hi of x * 2^r are rotl(x, r) for every
    amount the rounds use."""
    x = np.random.default_rng(1).integers(0, 2 ** 32, 10 ** 4,
                                          dtype=np.uint32)
    for r in ROTATE:
        want = (x << np.uint32(r)) | (x >> np.uint32(32 - r))
        np.testing.assert_array_equal(rotl(x, r), want)


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
    ((0xffffffff, 0xffffffff), (0xffffffff, 0xffffffff),
     (0x1cb996fc, 0xbb002be7)),
    ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
     (0xc4923a9c, 0x483df7a0))])
@pytest.mark.parametrize("rotl", [rotl_funnel, rotl_wide])
def test_kernel_rounds_give_the_known_answers(key, counter, want, rotl):
    """The Random123 known answers of Threefry-2x32 (20 rounds) through the
    kernel's arithmetic in either rotation form, and through the host block
    function."""
    x0, x1 = kernel_block(key[0], key[1], counter[1], counter[0], rotl)
    assert (int(x0), int(x1)) == want
    assert prng.threefry2x32(*key, *counter) == want


@pytest.mark.parametrize("rotl", [rotl_funnel, rotl_wide])
def test_kernel_rounds_match_the_block_function(rotl):
    """The kernel's rounds (either rotation, its injection order) equal
    ``prng.threefry2x32`` on 10^4 random keys and counters, and the
    float32 they make from counter (0, j) equals the plain version's
    draw."""
    rng = np.random.default_rng(7)
    k = rng.integers(0, 2 ** 32, (10 ** 4, 2), dtype=np.uint32)
    c = rng.integers(0, 2 ** 32, (10 ** 4, 2), dtype=np.uint32)
    for hi in (0, int(c[0, 0])):
        x0, x1 = kernel_block(k[:, 0], k[:, 1], c[:, 1], hi, rotl)
        for i in range(10 ** 4):
            assert (int(x0[i]), int(x1[i])) == prng.threefry2x32(
                int(k[i, 0]), int(k[i, 1]), hi, int(c[i, 1]))
    # 1001 samples of three row keys: the kernel's bits as floats
    keys = prng.split_rows(prng.key(5), 3)
    jj = np.arange(1001, dtype=np.uint32)
    got = []
    for r in range(3):
        a, b = kernel_block(keys[r, 0], keys[r, 1], jj, rotl=rotl)
        bits = (a ^ b) >> np.uint32(9) | np.uint32(0x3F800000)
        got.append(bits.view(np.float32) - np.float32(1.0))
    np.testing.assert_array_equal(
        np.stack(got), prng.uniform_plain(keys, (1001,)).numpy())
