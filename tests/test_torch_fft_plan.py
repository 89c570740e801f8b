"""The register-resident forward FFT of kernels KB and KE, replayed on the CPU.

csrc/fft_core.cuh (fwd_frame_pow2) runs every power-of-two n/2 on the plan
``ops/rfft_mag.fwd_plan`` gives and the host tables ``ops/rfft_mag`` builds.
No CUDA kernel runs here, so this file replays the kernel's index
arithmetic in numpy, in float32: the first pass's loads (two butterflies a
thread, a float4 each), every Stockham pass's reads, per-pass twiddles,
in-register radix-2 decimation-in-frequency DFT and swizzled writes, and the
real split of bins k and m - k from one read. The replay is held to ``np.fft.rfft`` in float64 within 1e-5 of
each frame's peak (the card tests' bound), each pass must write every point
once, the swizzle must keep the passes' 8-byte accesses free of bank
conflicts, and each plan must fit a block (threads x points = n/2, at most
512 threads and 227 KB of shared memory).
"""
import numpy as np
import pytest

from gomel_tpu_torch.ops import rfft_mag
from gomel_tpu_torch.ops.stft import hann_window

SIZES = [4 << i for i in range(13)]          # n = 4 ... 16384
MAX_THREADS = 512                            # kMaxFrameThreads
MAX_SMEM = 232_448                           # bytes a block (227 KB)
F32 = np.float32

# cos and sin of 2 pi e / 16, e < 8, as the kernel's literals round them
COS16 = np.cos(2 * np.pi * np.arange(8) / 16).astype(F32)
SIN16 = np.sin(2 * np.pi * np.arange(8) / 16).astype(F32)


def swz(i):
    return i ^ ((i >> 4) & 15)


def bitrev(s, r):
    out, b = 0, 1
    while b < r:
        out, s, b = (out << 1) | (s & 1), s >> 1, b << 1
    return out


def rot16(zr, zi, e):
    """z * exp(-2 pi i e / 16), as rot16<false>."""
    if e == 0:
        return zr, zi
    if e == 4:
        return zi, -zr
    c, s = COS16[e], -SIN16[e]
    return zr * c - zi * s, zr * s + zi * c


def dft_regs(vr, vi, r):
    """dft_regs<R, false> on the lists of registers vr, vi (in place)."""
    half = r // 2
    while half >= 1:
        for g in range(0, r, 2 * half):
            for i in range(half):
                ar, ai = vr[g + i], vi[g + i]
                br, bi = vr[g + i + half], vi[g + i + half]
                vr[g + i], vi[g + i] = ar + br, ai + bi
                vr[g + i + half], vi[g + i + half] = rot16(ar - br, ai - bi,
                                                           i * (8 // half))
        half //= 2


def replay(x: np.ndarray, window, n: int):
    """KB/KE's forward transform of frames x [F, n] (float32), every thread
    of a frame at once; returns the rfft bins (re, im) [F, n/2 + 1] and the
    store indices of each pass."""
    plan = rfft_mag.fwd_plan(n)
    tw = rfft_mag._twiddles_np(n)
    twp = rfft_mag._pass_twiddles_np(n)
    m, T = n // 2, plan.threads
    xw = x if window is None else x * window.astype(F32)
    zr, zi = xw[:, 0::2], xw[:, 1::2]
    re = np.zeros((x.shape[0], m), F32)
    im = np.zeros_like(re)
    th = np.arange(T)
    stores = []

    def store(vr, vi, r, base, ns, written):
        for s in range(r):
            w = swz(base + s * ns)
            re[:, w], im[:, w] = vr[bitrev(s, r)], vi[bitrev(s, r)]
            written.append(w)

    r0 = plan.radices[0]
    b0 = 2 if m >= rfft_mag.REG_POINTS else 1
    vr, vi = [None] * (r0 * b0), [None] * (r0 * b0)
    for c in range(r0 * b0 // 2):           # float offsets of the float4s
        off = 4 * th + 2 * c * (m // r0) if b0 == 2 else np.array([4 * c])
        q = off // 2                        # complex index of the pair
        lo, hi = (c, r0 + c) if b0 == 2 else (2 * c, 2 * c + 1)
        vr[lo], vi[lo] = zr[:, q], zi[:, q]
        vr[hi], vi[hi] = zr[:, q + 1], zi[:, q + 1]
    written = []
    for u in range(b0):
        br, bi = vr[u * r0:(u + 1) * r0], vi[u * r0:(u + 1) * r0]
        dft_regs(br, bi, r0)
        store(br, bi, r0, (b0 * th + u) * r0, 1, written)
    stores.append(np.concatenate(written))
    ns, base_tw = r0, 0
    for r in plan.radices[1:]:
        b, stride = rfft_mag.REG_POINTS // r, m // r
        regs = []
        for u in range(b):
            j = th + u * T
            regs.append(([re[:, swz(j + t * stride)] for t in range(r)],
                         [im[:, swz(j + t * stride)] for t in range(r)]))
        written = []
        for u, (br, bi) in enumerate(regs):
            j = th + u * T
            k = j & (ns - 1)
            for t in range(1, r):
                w = twp[base_tw + (t - 1) * ns + k]
                ar, ai = br[t], bi[t]
                br[t] = ar * w[:, 0] - ai * w[:, 1]
                bi[t] = ar * w[:, 1] + ai * w[:, 0]
            dft_regs(br, bi, r)
            store(br, bi, r, (j - k) * r + k, ns, written)
        stores.append(np.concatenate(written))
        base_tw += (r - 1) * ns
        ns *= r
    # the real split, bins k and m - k from one read (split_pair)
    k = np.arange(1, m // 2 + 1)
    a, b = swz(k), swz(m - k)
    er = F32(0.5) * (re[:, a] + re[:, b])
    ei = F32(0.5) * (im[:, a] - im[:, b])
    orr = F32(0.5) * (im[:, a] + im[:, b])
    oi = F32(-0.5) * (re[:, a] - re[:, b])
    w = tw[k]
    pa = orr * w[:, 0] - oi * w[:, 1]
    pb = orr * w[:, 1] + oi * w[:, 0]
    out_r = np.empty((x.shape[0], m + 1), F32)
    out_i = np.zeros_like(out_r)
    out_r[:, 0], out_r[:, m] = re[:, 0] + im[:, 0], re[:, 0] - im[:, 0]
    out_r[:, k], out_i[:, k] = er + pa, ei + pb
    mirror = 2 * k != m
    out_r[:, m - k[mirror]] = (er - pa)[:, mirror]
    out_i[:, m - k[mirror]] = (pb - ei)[:, mirror]
    return out_r, out_i, stores


@pytest.mark.parametrize("n", SIZES)
def test_plan_fits_a_block(n):
    """threads x points a thread = n/2, one first pass of radix 8 from
    n/2 = 16 on, radices of at most 16 whose product is n/2, the packed
    code, and a block within 512 threads and 227 KB of shared memory."""
    m = n // 2
    plan = rfft_mag.fwd_plan(n)
    points = min(rfft_mag.REG_POINTS, m)
    assert plan.threads * points == m
    assert int(np.prod(plan.radices)) == m
    assert all(r in (2, 4, 8, 16) and r <= points for r in plan.radices)
    assert plan.radices[0] == (8 if m >= 16 else m)
    assert len(plan.radices) <= 4 and (m >= 16 or len(plan.radices) == 1)
    decoded = [1 << ((plan.code >> (4 * p)) & 15)
               for p in range(len(plan.radices))]
    assert decoded == list(plan.radices)
    assert plan.code >> (4 * len(plan.radices)) == 0
    block = plan.threads * plan.frames_per_block
    assert block <= MAX_THREADS
    assert block == max(rfft_mag.BLOCK_THREADS, plan.threads)
    assert plan.smem_bytes == plan.frames_per_block * 2 * m * 4 <= MAX_SMEM


def test_plan_rejects_other_sizes():
    for n in (2, 3000, 514, 6, 4097):
        with pytest.raises(ValueError):
            rfft_mag.fwd_plan(n)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_replay_matches_float64_rfft(n, windowed):
    """The kernel's arithmetic in float32 within 1e-5 of each frame's peak
    of np.fft.rfft in float64, and every pass writes each point once."""
    rng = np.random.default_rng(n + windowed)
    x = rng.standard_normal((3, n)).astype(F32)
    x[2] *= F32(1e-3)                        # a quiet frame: its own peak
    win = hann_window(n) if windowed else None
    got_r, got_i, stores = replay(x, win, n)
    xw = x.astype(np.float64) * (1.0 if win is None else
                                 win.astype(F32).astype(np.float64))
    ref = np.fft.rfft(xw, axis=-1)
    err = np.abs(got_r + 1j * got_i - ref)
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert float((err / peak).max()) <= 1e-5
    for written in stores:
        assert np.array_equal(np.sort(written), np.arange(n // 2))


@pytest.mark.parametrize("n", SIZES)
def test_swizzle_is_a_permutation(n):
    m = n // 2
    assert np.array_equal(np.sort(swz(np.arange(m))), np.arange(m))


@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192, 16384])
def test_passes_free_of_bank_conflicts(n):
    """From n/2 = 512 on, each warp-wide 8-byte shared-memory access of every
    pass (32 consecutive threads of one frame, one complex point each) is
    served as two half-warps, each of whose 16 points lands on its own pair
    of the 32 four-byte banks (slot mod 16)."""
    plan = rfft_mag.fwd_plan(n)
    m, T = n // 2, plan.threads
    assert T % 32 == 0

    def distinct_banks(slots):
        slots = np.asarray(slots)
        for half in (slots[:16], slots[16:]):
            assert len(set(half % 16)) == 16

    for w0 in range(0, T, 32):
        th = np.arange(w0, w0 + 32)
        r0 = plan.radices[0]
        for u in range(2):
            for s in range(r0):
                distinct_banks(swz((2 * th + u) * r0 + s))
        ns = r0
        for r in plan.radices[1:]:
            for u in range(rfft_mag.REG_POINTS // r):
                j = th + u * T
                k = j & (ns - 1)
                for t in range(r):
                    distinct_banks(swz(j + t * (m // r)))
                    distinct_banks(swz((j - k) * r + k + t * ns))
            ns *= r


@pytest.mark.parametrize("n", SIZES)
def test_pass_twiddles_are_the_rounded_roots(n):
    """Each per-pass twiddle is exp(-2 pi i t k / (ns R)) rounded to float32:
    within half an ulp (6e-8) of the float64 root, and equal to the full
    table's entry t k n / (ns R) (tw[j], or -tw[j - n/2]) within that."""
    plan = rfft_mag.fwd_plan(n)
    twp = rfft_mag._pass_twiddles_np(n).astype(np.float64)
    tw = rfft_mag._twiddles_np(n).astype(np.float64)
    full = np.concatenate([tw, -tw])
    if len(plan.radices) == 1:
        assert twp.shape == (1, 2)
        return
    ns, off = plan.radices[0], 0
    for r in plan.radices[1:]:
        t, k = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
        t, k = t.reshape(-1), k.reshape(-1)
        got = twp[off:off + (r - 1) * ns]
        root = np.exp(-2j * np.pi * t * k / (ns * r))
        assert np.abs(got[:, 0] - root.real).max() <= 6e-8
        assert np.abs(got[:, 1] - root.imag).max() <= 6e-8
        assert np.abs(got - full[t * k * (n // (ns * r))]).max() <= 6e-8
        off += (r - 1) * ns
        ns *= r
    assert off == twp.shape[0]
