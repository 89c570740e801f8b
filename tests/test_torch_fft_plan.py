"""The register-resident FFT core of kernels KB, KE, KG and KJ, replayed on
the CPU.

csrc/fft_core.cuh (fwd_frame_pow2, inv_frame_pow2) runs every power-of-two
n/2 on the plan ``ops/rfft_mag.fwd_plan`` gives and the host tables
``ops/rfft_mag`` builds. No CUDA kernel runs here, so this file replays the
kernels' index arithmetic in numpy, in float32. Forward (KB, KE): the first
pass's loads (two butterflies a thread, a float4 each), every Stockham
pass's reads, per-pass twiddles, in-register radix-2 decimation-in-frequency
DFT and swizzled writes, and the real split of bins k and m - k from one
read; held to ``np.fft.rfft`` in float64 within 1e-5 of each frame's peak
(the card tests' bound). Inverse (KG, KJ): KG's paired prologue (2 Z[k] and
2 Z[m - k] from bins k and m - k, k = 0 taking DC and Nyquist, k = m/2 its
own partner), the passes with conjugated roots (the first from the buffer,
with no twiddles) and the last pass's stores straight to the frame, scaled
by 1/n and times the window; held to ``np.fft.irfft`` in float64 within
1e-5 of each frame's peak, and KJ's composition (forward, paired
projection, inverse) to ``gl_project_plain`` in float64 within 1e-4
relative L2 a frame. Each pass must write every point once, the last
pass's stores must be coalesced (a warp's 32 consecutive float2), the
swizzle must keep the passes' 8-byte accesses free of bank conflicts, and
each plan must fit a block (threads x points = n/2, at most 512 threads and
227 KB of shared memory). No JAX.
"""
import numpy as np
import pytest

import torch

from gomel_tpu_torch.ops import griffinlim, rfft_mag
from gomel_tpu_torch.ops.stft import frame_signal, hann_window

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


def rot16(zr, zi, e, inverse=False):
    """z * exp(-2 pi i e / 16), as rot16<false> (inverse: exp(+...),
    rot16<true>)."""
    if e == 0:
        return zr, zi
    if e == 4:
        return (-zi, zr) if inverse else (zi, -zr)
    c, s = COS16[e], (SIN16[e] if inverse else -SIN16[e])
    return zr * c - zi * s, zr * s + zi * c


def dft_regs(vr, vi, r, inverse=False):
    """dft_regs<R, inverse> on the lists of registers vr, vi (in place)."""
    half = r // 2
    while half >= 1:
        for g in range(0, r, 2 * half):
            for i in range(half):
                ar, ai = vr[g + i], vi[g + i]
                br, bi = vr[g + i + half], vi[g + i + half]
                vr[g + i], vi[g + i] = ar + br, ai + bi
                vr[g + i + half], vi[g + i + half] = rot16(
                    ar - br, ai - bi, i * (8 // half), inverse)
        half //= 2


def forward_buffer(x: np.ndarray, window, n: int):
    """fwd_frame_pow2 on frames x [F, n] (float32), every thread of a frame
    at once: the frame's buffer (re, im) [F, n/2], Z at the swizzled slots,
    and the store slots of each pass."""
    plan = rfft_mag.fwd_plan(n)
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
    return re, im, stores


def split_pairs(re, im, n):
    """split_pair for k = 1 .. m/2: (X[k], X[m - k]) as (re, im) each."""
    m = n // 2
    tw = rfft_mag._twiddles_np(n)
    k = np.arange(1, m // 2 + 1)
    a, b = swz(k), swz(m - k)
    er = F32(0.5) * (re[:, a] + re[:, b])
    ei = F32(0.5) * (im[:, a] - im[:, b])
    orr = F32(0.5) * (im[:, a] + im[:, b])
    oi = F32(-0.5) * (re[:, a] - re[:, b])
    w = tw[k]
    pa = orr * w[:, 0] - oi * w[:, 1]
    pb = orr * w[:, 1] + oi * w[:, 0]
    return (er + pa, ei + pb), (er - pa, pb - ei)


def replay(x: np.ndarray, window, n: int):
    """KB/KE's forward transform of frames x [F, n] (float32); returns the
    rfft bins (re, im) [F, n/2 + 1] and the store indices of each pass."""
    m = n // 2
    re, im, stores = forward_buffer(x, window, n)
    k = np.arange(1, m // 2 + 1)
    (kr, ki), (qr, qi) = split_pairs(re, im, n)
    out_r = np.empty((x.shape[0], m + 1), F32)
    out_i = np.zeros_like(out_r)
    out_r[:, 0], out_r[:, m] = re[:, 0] + im[:, 0], re[:, 0] - im[:, 0]
    out_r[:, k], out_i[:, k] = kr, ki
    mirror = 2 * k != m
    out_r[:, m - k[mirror]] = qr[:, mirror]
    out_i[:, m - k[mirror]] = qi[:, mirror]
    return out_r, out_i, stores


def inverse_split(pr, pi, qr, qi, wr, wi):
    """inverse_split_bin: 2 Z[k] from P = X[k], Q = X[m - k], w = tw[k]."""
    ar, ai = pr + qr, pi - qi
    dr, di = pr - qr, pi + qi
    return ar - (wr * di - wi * dr), ai + (wr * dr + wi * di)


def paired_store(p, q, n):
    """The inverse kernels' pairs: P = X[k] and Q = X[m - k] for k = 0 ..
    m/2 ((re, im) [F, m/2 + 1] each; k = 0: DC and Nyquist, their imaginary
    parts already zero) -> the frame's buffer with 2 Z[k] and 2 Z[m - k] at
    the swizzled slots (k = m/2 is its own partner: written once), and the
    slots written."""
    m = n // 2
    w = rfft_mag._twiddles_np(n)[:m // 2 + 1]
    k = np.arange(m // 2 + 1)
    re = np.zeros((p[0].shape[0], m), F32)
    im = np.zeros_like(re)
    re[:, swz(k)], im[:, swz(k)] = inverse_split(*p, *q, w[:, 0], w[:, 1])
    mirror = (k > 0) & (2 * k != m)
    zr, zi = inverse_split(*q, *p, -w[:, 0], w[:, 1])
    re[:, swz(m - k[mirror])] = zr[:, mirror]
    im[:, swz(m - k[mirror])] = zi[:, mirror]
    return re, im, np.concatenate([swz(k), swz(m - k[mirror])])


def inverse_replay(re, im, window, n: int):
    """inv_frame_pow2 on the buffers (re, im) [F, n/2] holding Z: the frame
    [F, n] (scaled by 1/n, times the window), the store slots of each pass
    before the last, and the last pass's stores as (u, s, points of threads
    0 .. T-1)."""
    plan = rfft_mag.fwd_plan(n)
    twp = rfft_mag._pass_twiddles_np(n)
    m, T = n // 2, plan.threads
    points = min(rfft_mag.REG_POINTS, m)
    th = np.arange(T)
    out = np.zeros((re.shape[0], n), F32)
    inv_n = F32(1.0) / F32(n)
    win = None if window is None else window.astype(F32)
    re, im = re.copy(), im.copy()
    stores, last_stores = [], []
    ns, base_tw = 1, 0
    for p, r in enumerate(plan.radices):
        last = p == len(plan.radices) - 1
        stride = m // r
        regs = []
        for u in range(points // r):
            j = th + u * T
            regs.append(([re[:, swz(j + t * stride)] for t in range(r)],
                         [im[:, swz(j + t * stride)] for t in range(r)]))
        written = []
        for u, (br, bi) in enumerate(regs):
            j = th + u * T
            k = j & (ns - 1)
            if ns > 1:                      # the first pass has no twiddles
                for t in range(1, r):
                    w = twp[base_tw + (t - 1) * ns + k]
                    wr, wi = w[:, 0], -w[:, 1]
                    ar, ai = br[t], bi[t]
                    br[t] = ar * wr - ai * wi
                    bi[t] = ar * wi + ai * wr
            dft_regs(br, bi, r, inverse=True)
            for s in range(r):
                v = (br[bitrev(s, r)], bi[bitrev(s, r)])
                if last:                    # point j + s ns, samples 2i, 2i+1
                    i = j + s * ns
                    for c in range(2):
                        y = v[c] * inv_n
                        out[:, 2 * i + c] = y if win is None else y * win[2 * i + c]
                    last_stores.append((u, s, i))
                else:
                    w_at = swz((j - k) * r + k + s * ns)
                    re[:, w_at], im[:, w_at] = v
                    written.append(w_at)
        if not last:
            stores.append(np.concatenate(written))
        if ns > 1:
            base_tw += (r - 1) * ns
        ns *= r
    return out, stores, last_stores


def project_bin(xr, xi, mag):
    """project_bin (unit_phase.cuh) in float32, each step rounded."""
    a = np.sqrt(xr * xr + xi * xi)
    pos = a > 0
    with np.errstate(divide="ignore"):
        inv = np.where(pos, F32(1.0) / np.where(pos, a, F32(1.0)), F32(0.0))
    ur = np.where(pos, xr * inv, F32(1.0))
    return mag * ur, mag * (xi * inv)


def gl_replay(frames: np.ndarray, mag: np.ndarray, window, n: int):
    """KJ on frames [F, n] and magnitudes [F, n/2 + 1] (float32): the
    forward replay, the projection of bins k and m - k in pairs, then the
    inverse replay."""
    m = n // 2
    re, im, _ = forward_buffer(frames, window, n)
    (kr, ki), (qr, qi) = split_pairs(re, im, n)
    zero = np.zeros((frames.shape[0], 1), F32)
    k = np.arange(m // 2 + 1)
    # k = 0: DC and Nyquist from Z[0]
    p = (np.concatenate([re[:, :1] + im[:, :1], kr], 1),
         np.concatenate([zero, ki], 1))
    q = (np.concatenate([re[:, :1] - im[:, :1], qr], 1),
         np.concatenate([zero, qi], 1))
    p, q = project_bin(*p, mag[:, k]), project_bin(*q, mag[:, m - k])
    p[1][:, 0] = q[1][:, 0] = 0.0
    zr, zi, _ = paired_store(p, q, n)
    return inverse_replay(zr, zi, window, n)[0]


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


def _half_spectrum(n: int, seed: int):
    """Random half spectra X [3, n/2 + 1] (float32), the last frame quiet."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, n // 2 + 1))
         + 1j * rng.standard_normal((3, n // 2 + 1)))
    x[2] *= 1e-3
    return x.real.astype(F32), x.imag.astype(F32)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_inverse_replay_matches_float64_irfft(n, windowed):
    """KG's paired prologue and the inverse passes in float32 within 1e-5 of
    each frame's peak (the unwindowed frame's: the FFT's rounding scales
    with it) of np.fft.irfft in float64; the prologue writes each slot once
    (k = 0 and k = m/2 included) and every pass each point once."""
    m = n // 2
    xr, xi = _half_spectrum(n, n + windowed)
    xi[:, 0] = xi[:, m] = 0.0               # irfft ignores them; KG drops them
    k = np.arange(m // 2 + 1)
    re, im, slots = paired_store((xr[:, k], xi[:, k]),
                                 (xr[:, m - k], xi[:, m - k]), n)
    assert np.array_equal(np.sort(slots), np.arange(m))
    win = hann_window(n) if windowed else None
    got, stores, last = inverse_replay(re, im, win, n)
    ref = np.fft.irfft(xr.astype(np.float64) + 1j * xi.astype(np.float64), n)
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    if win is not None:
        ref = ref * win.astype(F32).astype(np.float64)
    assert float((np.abs(got - ref) / peak).max()) <= 1e-5
    for written in stores:
        assert np.array_equal(np.sort(written), np.arange(m))
    points = np.concatenate([i for _, _, i in last])
    assert np.array_equal(np.sort(points), np.arange(m))


@pytest.mark.parametrize("n", SIZES)
def test_inverse_last_pass_stores_coalesce(n):
    """The last pass (ns = n/2 / R) stores point j + s ns of butterfly j:
    for each (u, s) the threads of a frame store consecutive float2, so a
    warp's 32 stores are 32 consecutive float2 (all of a frame's T where
    T < 32), and each point is stored once."""
    plan = rfft_mag.fwd_plan(n)
    m, T = n // 2, plan.threads
    re = np.zeros((1, m), F32)
    _, _, last = inverse_replay(re, re, None, n)
    assert len(last) == m // T
    assert plan.radices[-1] * (m // plan.radices[-1]) == m
    for _, _, idx in last:
        for w0 in range(0, T, 32):
            warp = idx[w0:w0 + 32]
            assert np.array_equal(warp, warp[0] + np.arange(len(warp)))
    points = np.concatenate([i for _, _, i in last])
    assert np.array_equal(np.sort(points), np.arange(m))


@pytest.mark.parametrize("n", SIZES)
def test_gl_replay_matches_float64_plain(n):
    """KJ's composition (forward replay, paired projection, inverse replay)
    in float32 within 1e-4 relative L2 a frame of gl_project_plain in
    float64; frame 0 is silent (unit phase 1)."""
    rng = np.random.default_rng(n + 7)
    hop, frames = max(1, n // 4), 4
    sig = rng.random(n + (frames - 1) * hop).astype(F32)
    sig[:n] = 0.0
    mag = (rng.random((frames, n // 2 + 1)) * 3).astype(F32)
    win = hann_window(n)
    framed = frame_signal(torch.from_numpy(sig), n, hop).numpy()
    got = gl_replay(framed, mag, win, n)
    ref = griffinlim.gl_project_plain(
        torch.from_numpy(sig).double(), torch.from_numpy(mag).double(),
        torch.from_numpy(win.astype(F32)).double(), n, hop).numpy()
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert float(rel.max()) <= 1e-4, float(rel.max())


@pytest.mark.parametrize("n", [1024, 2048, 4096, 8192, 16384])
def test_inverse_first_pass_free_of_bank_conflicts(n):
    """The inverse's first pass reads the buffer (points j + t n/16 for
    butterflies j = th and th + T) and writes points 8 j + s: each
    half-warp's 16 points land on 16 distinct bank pairs, as the later
    passes' do (test_passes_free_of_bank_conflicts)."""
    plan = rfft_mag.fwd_plan(n)
    m, T, r0 = n // 2, plan.threads, plan.radices[0]
    for w0 in range(0, T, 32):
        th = np.arange(w0, w0 + 32)
        for u in range(rfft_mag.REG_POINTS // r0):
            j = th + u * T
            for t in range(r0):
                for slots in (swz(j + t * (m // r0)), swz(j * r0 + t)):
                    for half in (slots[:16], slots[16:]):
                        assert len(set(half % 16)) == 16
