"""The mixed-radix register core of kernels KB, KE, KG and KJ, replayed on
the CPU.

csrc/fft_core.cuh (fwd_frame_mixed, inv_frame_mixed) runs every n whose half
m is not a power of two on the plan ``ops/rfft_mag.mixed_plan`` gives and the
per-pass table of ``ops/rfft_mag._mixed_twiddles_np``. No CUDA kernel runs
here, so this file replays the kernels' index arithmetic in numpy, in
float32 (complex64): the forward's decimation in time in place (the first
pass's butterflies j = th + u T from the signal's points j + t m/R_0, stored
at the digit-reversed points rev(j) R_0 + s; each later pass's butterflies
g ns + k at points g ns R + k + t ns, twiddled from the pass's table row),
the compile-time butterflies (the power-of-two DFTs with the 16th roots,
the symmetric 3-, 5- and 7-point forms with their float32 literal roots,
the prime-factor nests of the composites), the generic passes (a thread an
output, roots from the pass's table of ns R roots, a second buffer after
the first pass), the split of bins k and m - k, KJ's projection, KE's
epilogue (the pairs (k, m - k) that hold a bin of its range), KG's prologue
(2 Z[k] and 2 Z[m - k] from the bins its source mode gives) and its frame
mask over the blocks of the plan, and the inverse's decimation in
frequency, whose last pass stores the frame's points j + t m/R_0 times 1/n
and the window. Each is held to ``np.fft.rfft``, ``stft_planes_plain``,
``irfft_window_plain`` or ``gl_project_plain`` in float64 (the card tests'
bounds: 1e-5 of each frame's peak, 1e-4 relative L2 a frame). Each pass
must write every point once; every plan must fit a block and take no more
passes than the one-prime-a-pass route the core replaced. No JAX.
"""
import os
import re

import numpy as np
import pytest

import torch

from gomel_tpu_torch.ops import (griffinlim, istft, phase_ops, quantize,
                                 rfft_mag)
from gomel_tpu_torch.ops.fftbackend import ct_supported
from gomel_tpu_torch.ops.stft import frame_signal, hann_window

SIZES = [6, 254, 400, 960, 1200, 2400, 3000, 4094, 6000, 12000]
MAX_THREADS = 512                            # a block, at most
MAX_SMEM = 232_448                           # bytes a block (227 KB)
F32, C64 = np.float32, np.complex64
CORE = os.path.join(os.path.dirname(rfft_mag.__file__), "..", "csrc",
                    "fft_core.cuh")

# cos and sin of 2 pi e / 16, e < 8, as the kernel's literals round them
COS16 = np.cos(2 * np.pi * np.arange(8) / 16).astype(F32)
SIN16 = np.sin(2 * np.pi * np.arange(8) / 16).astype(F32)


def mixed_sizes() -> list[int]:
    """Every even n the FFT kernels take whose half is not a power of two."""
    return [n for n in range(6, 16385, 2)
            if (n // 2) & (n // 2 - 1) and ct_supported(n)]


def old_passes(m: int) -> int:
    """The passes of the shared-memory mixed radix: radix 4 while 4 divides
    what is left, else its smallest prime factor."""
    count = 0
    while m > 1:
        r = 4 if m % 4 == 0 else next(p for p in range(2, m + 1) if m % p == 0)
        m //= r
        count += 1
    return count


def bitrev(s, r):
    out, b = 0, 1
    while b < r:
        out, s, b = (out << 1) | (s & 1), s >> 1, b << 1
    return out


def first_factor(r: int) -> int:
    """mixed_first_factor<R>: the power of two of R, else 3, else 5."""
    if r % 2 == 0:
        return r & -r
    return 3 if r % 3 == 0 else 5


def out_pos(r: int, s: int) -> int:
    """Where dft_mixed<R> leaves X[s]."""
    if r & (r - 1) == 0:
        return bitrev(s, r)
    if r in (3, 5, 7):
        return s
    a = first_factor(r)
    return (s % a) * (r // a) + out_pos(r // a, s % (r // a))


def rot16(z, e, inverse):
    """rot16<inverse>: z * exp(-+2 pi i e / 16) with the literal roots."""
    if e == 0:
        return z
    if e == 4:
        return z * C64(1j if inverse else -1j)
    s = SIN16[e] if inverse else -SIN16[e]
    return (z.real * COS16[e] - z.imag * s
            + 1j * (z.real * s + z.imag * COS16[e])).astype(C64)


def dft_pow2(v, r, inverse):
    """dft_regs<R>: radix-2 decimation in frequency, X[s] at bitrev(s)."""
    half = r // 2
    while half >= 1:
        for g in range(0, r, 2 * half):
            for i in range(half):
                a, b = v[g + i], v[g + i + half]
                v[g + i] = a + b
                v[g + i + half] = rot16(a - b, i * (8 // half), inverse)
        half //= 2


def literal_roots() -> dict[tuple[int, int], tuple[float, float]]:
    """(R, r) -> (cos, sin) of 2 pi r / R as cos_prime / sin_prime in
    csrc/fft_core.cuh write them."""
    with open(CORE) as f:
        text = f.read()
    out = {}
    for name in ("cos_prime", "sin_prime"):
        body = text[text.index(f"float {name}("):]
        body = body[:body.index("\n}\n")]
        for key, val in re.findall(r"case (\d+): return (-?[\d.]+)f;", body):
            out.setdefault((int(key) // 4, int(key) % 4), []).append(float(val))
        val = re.search(r"default: return (-?[\d.]+)f;", body).group(1)
        out.setdefault((7, 3), []).append(float(val))
    return {k: tuple(v) for k, v in out.items()}


ROOTS = literal_roots()


def dft_prime(v, r, inverse):
    """dft_prime<R>: the symmetric form, natural order."""
    h = (r - 1) // 2
    a = [v[j] + v[r - j] for j in range(1, h + 1)]
    b = [v[j] - v[r - j] for j in range(1, h + 1)]
    x0 = v[0]
    total = x0
    for aj in a:
        total = total + aj
    v[0] = total
    for s in range(1, h + 1):
        re, im = x0, np.zeros_like(x0)
        for j in range(1, h + 1):
            rr = (j * s) % r
            e = rr if rr <= h else r - rr
            c, sn = ROOTS[(r, e)]
            c, sn = F32(c), F32(sn if rr <= h else -sn)
            re = re + c * a[j - 1]
            im = im + sn * b[j - 1]
        lo = re - C64(1j) * im
        hi = re + C64(1j) * im
        v[s], v[r - s] = (hi, lo) if inverse else (lo, hi)


def dft_mixed(v, r, inverse=False):
    """dft_mixed<R> on the list of R registers v (in place)."""
    if r & (r - 1) == 0:
        dft_pow2(v, r, inverse)
    elif r in (3, 5, 7):
        dft_prime(v, r, inverse)
    else:
        a = first_factor(r)
        b = r // a
        y = [None] * r
        for n2 in range(b):
            row = [v[(b * n1 + a * n2) % r] for n1 in range(a)]
            dft_mixed(row, a, inverse)
            y[n2 * a:(n2 + 1) * a] = row
        for k1 in range(a):
            col = [y[n2 * a + out_pos(a, k1)] for n2 in range(b)]
            dft_mixed(col, b, inverse)
            v[k1 * b:(k1 + 1) * b] = col


class Replay:
    """The kernels' view of one plan: its passes, the table rows, rev()."""

    def __init__(self, n: int):
        self.n, self.m = n, n // 2
        self.plan = rfft_mag.mixed_plan(n)
        self.table = rfft_mag._mixed_twiddles_np(n)
        self.tw = self.table[:, 0] + 1j * self.table[:, 1]
        self.tw = self.tw.astype(C64)
        self.ns, self.rows = [], []
        ns, row = 1, 0
        for p, r in enumerate(self.plan.radices):
            self.ns.append(ns)
            self.rows.append(row)
            if self.plan.in_registers[p]:
                row += (r - 1) * ns if p else 0
            else:
                row += ns * r
            ns *= r
        self.th = np.arange(self.plan.threads)

    def rev(self, j):
        """mixed_rev: the digits of j (R_{P-1} least significant) reversed."""
        q = np.zeros_like(j)
        radices = self.plan.radices
        for p in range(len(radices) - 1, 0, -1):
            q = q * radices[p] + j % radices[p]
            j = j // radices[p]
        return q

    def items(self, r: int):
        """The butterflies (or, generic, outputs) of a pass, by u: arrays of
        th + u T over the frame's threads."""
        count = self.plan.points // r if r else self.plan.points
        return [self.th + u * self.plan.threads for u in range(count)]


def forward(x: np.ndarray, window, n: int):
    """fwd_frame_mixed on frames x [F, n] (float32): Z [F, m] in natural
    order and the points each pass wrote."""
    rp = Replay(n)
    plan, m = rp.plan, rp.m
    xw = x if window is None else x * window.astype(F32)
    pts = (xw[:, 0::2] + 1j * xw[:, 1::2]).astype(C64)
    buf = np.full((x.shape[0], m), np.nan, C64)
    written = []
    r0, stride = plan.radices[0], m // plan.radices[0]
    w = []
    if plan.in_registers[0]:
        for j in rp.items(r0):
            v = [pts[:, j + t * stride] for t in range(r0)]
            dft_mixed(v, r0)
            for s in range(r0):
                pos = rp.rev(j) * r0 + s
                buf[:, pos] = v[out_pos(r0, s)]
                w.append(pos)
    else:
        roots = rp.tw[rp.rows[0]:rp.rows[0] + r0]
        for o in rp.items(0):
            s, j = o // stride, o % stride
            acc = np.zeros((x.shape[0], len(o)), C64)
            for t in range(r0):
                acc = acc + pts[:, j + t * stride] * roots[(t * s) % r0]
            pos = rp.rev(j) * r0 + s
            buf[:, pos] = acc
            w.append(pos)
    written.append(np.concatenate(w))
    for p in range(1, len(plan.radices)):
        r, ns, row = plan.radices[p], rp.ns[p], rp.rows[p]
        w = []
        if plan.in_registers[p]:
            for b in rp.items(r):
                g, k = b // ns, b % ns
                base = g * ns * r + k
                v = [buf[:, base + t * ns] for t in range(r)]
                for t in range(1, r):
                    v[t] = v[t] * rp.tw[row + (t - 1) * ns + k]
                dft_mixed(v, r)
                for s in range(r):
                    buf[:, base + s * ns] = v[out_pos(r, s)]
                    w.append(base + s * ns)
        else:
            span = ns * r
            roots = rp.tw[row:row + span]
            out = np.full_like(buf, np.nan)
            for i in rp.items(0):
                g, e = i // span, i % span
                k = e % ns
                acc = np.zeros((x.shape[0], len(i)), C64)
                for t in range(r):
                    acc = acc + buf[:, g * span + k + t * ns] * roots[
                        (t * e) % span]
                out[:, i] = acc
                w.append(i)
            buf = out
        written.append(np.concatenate(w))
    return buf, written


def inverse(buf: np.ndarray, window, n: int):
    """inv_frame_mixed on Z [F, m] in natural order: the frame [F, n], times
    1/n and the window, and the points each pass wrote (the last: the
    frame's points it stored)."""
    rp = Replay(n)
    plan, m = rp.plan, rp.m
    buf = buf.copy()
    written = []
    for p in range(len(plan.radices) - 1, 0, -1):
        r, ns, row = plan.radices[p], rp.ns[p], rp.rows[p]
        w = []
        if plan.in_registers[p]:
            for b in rp.items(r):
                g, k = b // ns, b % ns
                base = g * ns * r + k
                v = [buf[:, base + s * ns] for s in range(r)]
                dft_mixed(v, r, inverse=True)
                for t in range(r):
                    y = v[out_pos(r, t)]
                    if t:
                        y = y * np.conj(rp.tw[row + (t - 1) * ns + k])
                    buf[:, base + t * ns] = y
                    w.append(base + t * ns)
        else:
            span = ns * r
            roots = np.conj(rp.tw[row:row + span])
            out = np.full_like(buf, np.nan)
            for i in rp.items(0):
                g, e = i // span, i % span
                d, k = e // ns, e % ns
                acc = np.zeros((buf.shape[0], len(i)), C64)
                for s in range(r):
                    acc = acc + buf[:, g * span + k + s * ns] * roots[
                        (d * k + s * d * ns) % span]
                out[:, i] = acc
                w.append(i)
            buf = out
        written.append(np.concatenate(w))
    r0, stride = plan.radices[0], m // plan.radices[0]
    frame = np.zeros((buf.shape[0], m), C64)
    w = []
    if plan.in_registers[0]:
        for j in rp.items(r0):
            v = [buf[:, rp.rev(j) * r0 + s] for s in range(r0)]
            dft_mixed(v, r0, inverse=True)
            for t in range(r0):
                frame[:, j + t * stride] = v[out_pos(r0, t)]
                w.append(j + t * stride)
    else:
        roots = np.conj(rp.tw[rp.rows[0]:rp.rows[0] + r0])
        for i in rp.items(0):
            t, j = i // stride, i % stride
            acc = np.zeros((buf.shape[0], len(i)), C64)
            for s in range(r0):
                acc = acc + buf[:, rp.rev(j) * r0 + s] * roots[(t * s) % r0]
            frame[:, i] = acc
            w.append(i)
    written.append(np.concatenate(w))
    inv_n = F32(1.0) / F32(n)
    out = np.empty((buf.shape[0], n), F32)
    out[:, 0::2] = frame.real * inv_n
    out[:, 1::2] = frame.imag * inv_n
    if window is not None:
        out = out * window.astype(F32)
    return out, written


def split(z: np.ndarray, n: int):
    """The kernels' split: rfft bins (re, im) [F, m + 1] from Z, bins k and
    m - k from one read (split_values), DC and Nyquist from Z[0]."""
    m = n // 2
    tw = rfft_mag._twiddles_np(n)
    k = np.arange(1, m // 2 + 1)
    p, q = z[:, k], z[:, m - k]
    er = F32(0.5) * (p.real + q.real)
    ei = F32(0.5) * (p.imag - q.imag)
    orr = F32(0.5) * (p.imag + q.imag)
    oi = F32(-0.5) * (p.real - q.real)
    a = orr * tw[k, 0] - oi * tw[k, 1]
    b = orr * tw[k, 1] + oi * tw[k, 0]
    re = np.zeros((z.shape[0], m + 1), F32)
    im = np.zeros_like(re)
    re[:, 0], re[:, m] = z[:, 0].real + z[:, 0].imag, z[:, 0].real - z[:, 0].imag
    re[:, k], im[:, k] = er + a, ei + b
    mirror = 2 * k != m
    re[:, m - k[mirror]] = (er - a)[:, mirror]
    im[:, m - k[mirror]] = (b - ei)[:, mirror]
    return re, im


def project_bin(xr, xi, mag):
    """project_bin (unit_phase.cuh) in float32, each step rounded."""
    a = np.sqrt(xr * xr + xi * xi)
    pos = a > 0
    with np.errstate(divide="ignore"):
        inv = np.where(pos, F32(1.0) / np.where(pos, a, F32(1.0)), F32(0.0))
    ur = np.where(pos, xr * inv, F32(1.0))
    return mag * ur, mag * (xi * inv)


def inverse_split(pr, pi, qr, qi, w):
    """inverse_split_bin: 2 Z[k] from P = X[k], Q = X[m - k], w = tw[k]."""
    ar, ai = pr + qr, pi - qi
    dr, di = pr - qr, pi + qi
    wr, wi = w[..., 0], w[..., 1]
    return ar - (wr * di - wi * dr), ai + (wr * dr + wi * di)


def gl_replay(frames: np.ndarray, mag: np.ndarray, window, n: int):
    """KJ's composition: the forward replay, the projection of bins k and
    m - k in pairs (k = 0: DC and Nyquist, their imaginary parts dropped),
    the inverse replay."""
    m = n // 2
    z, _ = forward(frames, window, n)
    re, im = split(z, n)
    k = np.arange(m // 2 + 1)
    pr, pi = project_bin(re[:, k], im[:, k], mag[:, k])
    qr, qi = project_bin(re[:, m - k], im[:, m - k], mag[:, m - k])
    pi[:, 0] = qi[:, 0] = 0.0
    w = rfft_mag._twiddles_np(n)[k]
    zr, zi = inverse_split(pr, pi, qr, qi, w)
    out = np.zeros((frames.shape[0], m), C64)
    out[:, k] = zr + 1j * zi
    mirror = (k > 0) & (2 * k != m)
    wm = np.stack([-w[:, 0], w[:, 1]], axis=-1)
    yr, yi = inverse_split(qr, qi, pr, pi, wm)
    out[:, m - k[mirror]] = (yr + 1j * yi)[:, mirror]
    return inverse(out, window, n)[0]


def store_planes(z: np.ndarray, n: int, first: int, count: int):
    """KE's epilogue (phase_encode.cu store_planes): each thread th of the
    frame's T walks k = (lo // T) T + th, ... <= hi, takes the pairs
    (k, m - k) from lo on (k = 0: DC and Nyquist), splits them (split) and
    stores (Im, Re) of each member in first..first+count-1. Returns the
    planes [F, count, 2] and how often each bin was stored."""
    m = n // 2
    threads = rfft_mag.mixed_plan(n).threads
    re, im = split(z, n)
    last = first + count - 1
    lo = max(0, min(first, m - last))
    hi = min(m // 2, max(last, m - first))
    out = np.full((z.shape[0], count, 2), np.nan, F32)
    hits = np.zeros(count, int)
    for th in range(threads):
        for k in range((lo // threads) * threads + th, hi + 1, threads):
            if k < lo:
                continue
            for b in (k, m - k) if 2 * k != m else (k,):
                if first <= b <= last:
                    out[:, b - first, 0], out[:, b - first, 1] = (
                        im[:, b], re[:, b])
                    hits[b - first] += 1
    return out, hits


def half_bins(src, mode: str, n: int, ext=None, max_val=0, ihs=0):
    """half_bin<kMode> (phase_decode.cu) for k = 0..m in float32: the
    planes' bins as they are, or (spectrogram, PNG planes) bin k > 0 from
    stored bin min(k - 1, nf - 1), real part channel 1 and imaginary part
    channel 0, the PNG planes' values rescaled step by step and through
    ihs sinh passes; DC's and Nyquist's imaginary parts zero."""
    m = n // 2
    if mode == "planes":
        re, im = (a.astype(F32).copy() for a in src)
    else:
        if mode == "spec":
            chans = src.astype(F32)                          # [F, nf, 2]
        else:
            q = src.astype(F32).transpose(1, 0, 2)           # [F, nf, 2]
            mx, mn = ext
            with np.errstate(over="ignore"):
                chans = (q / F32(max_val)) * (mx - mn).astype(F32) + mn
                for _ in range(ihs):
                    chans = np.sinh(chans).astype(F32)
        j = np.minimum(np.arange(m + 1) - 1, chans.shape[1] - 1)
        re, im = chans[:, j, 1].copy(), chans[:, j, 0].copy()
        re[:, 0] = im[:, 0] = 0.0
    im[:, 0] = im[:, m] = 0.0
    return re, im


def load_spectrum(re: np.ndarray, im: np.ndarray, n: int) -> np.ndarray:
    """KG's prologue (load_spectrum): for k = 0..m/2, P = X[k] and
    Q = X[m - k] give 2 Z[k] = inverse_split_bin(P, Q, tw[k]) and, for
    0 < k != m - k, 2 Z[m - k] from (Q, P, -conj tw[k]), in natural order.
    Each point is written once."""
    m = n // 2
    k = np.arange(m // 2 + 1)
    w = rfft_mag._twiddles_np(n)[k]
    zr, zi = inverse_split(re[:, k], im[:, k], re[:, m - k], im[:, m - k], w)
    out = np.full((re.shape[0], m), np.nan, C64)
    out[:, k] = zr + 1j * zi
    mirror = (k > 0) & (2 * k != m)
    wm = np.stack([-w[:, 0], w[:, 1]], axis=-1)
    yr, yi = inverse_split(re[:, m - k], im[:, m - k], re[:, k], im[:, k], wm)
    out[:, m - k[mirror]] = (yr + 1j * yi)[:, mirror]
    assert not np.isnan(out).any()
    return out


def masked_launch(frames_out: np.ndarray, frames: int, real: int,
                  per_block: int):
    """KG's blocks over frames_out [B * F, n] (each frame as the unmasked
    launch computes it) with a real-frame count: a block holding no frame
    before ``real`` of its row (block_live) stores zeros and returns; in a
    live block a masked frame stores zeros, the others their frame. Returns
    the result, the count of stores of each frame, and the blocks found
    live only through a later row's first frame."""
    total = frames_out.shape[0]
    out = np.full_like(frames_out, np.nan)
    stores = np.zeros(total, int)
    by_next_row = 0
    for first in range(0, total, per_block):
        last = min(first + per_block, total) - 1
        row0 = first // frames
        head = first - row0 * frames < real
        live = head or (real > 0 and (row0 + 1) * frames <= last)
        by_next_row += live and not head
        for frame in range(first, first + per_block):
            if frame >= total:
                continue
            masked = frame % frames >= real
            if masked:
                out[frame] = 0.0
                stores[frame] += 1
            elif live:
                out[frame] = frames_out[frame]
                stores[frame] += 1
    return out, stores, by_next_row


def test_every_size_has_a_plan():
    """Every even n from 6 to 16384 whose half is not a power of two and
    that the FFT kernels take has a plan: its radices multiply to n/2 in at
    most 8 passes and no more than the route it replaced took, threads x
    points = n/2 with every register radix dividing points, and the block
    fits (at most 256 threads, 512 allowed, and 227 KB of shared memory);
    no register radix exceeds 16."""
    sizes = mixed_sizes()
    assert len(sizes) > 2900
    for n in sizes:
        m = n // 2
        plan = rfft_mag.mixed_plan(n)
        assert int(np.prod(plan.radices)) == m, n
        assert len(plan.radices) <= rfft_mag.MIXED_MAX_PASSES
        assert len(plan.radices) <= old_passes(m), (n, plan.radices)
        assert plan.threads * plan.points == m
        assert plan.points <= rfft_mag.MIXED_MAX_POINTS
        for p, r in enumerate(plan.radices):
            if plan.in_registers[p]:
                assert plan.points % r == 0
            assert 2 <= r <= 127
        block = plan.threads * plan.frames_per_block
        assert block <= rfft_mag.MIXED_BLOCK_THREADS <= MAX_THREADS
        assert plan.smem_bytes <= MAX_SMEM
        regs = [r for p, r in enumerate(plan.radices) if plan.in_registers[p]]
        assert max(regs, default=2) <= 16
        assert plan.code >> (8 * len(plan.radices)) == 0
        assert [(plan.code >> (8 * p)) & 255 for p in
                range(len(plan.radices))] == list(plan.radices)


def test_plan_rejects_other_sizes():
    for n in (4096, 3001, 514, 2, 4):
        with pytest.raises(ValueError):
            rfft_mag.mixed_plan(n)


@pytest.mark.parametrize("m,passes", [(200, 3), (480, 3), (600, 3),
                                      (1200, 3), (1500, 3), (3000, 4)])
def test_user_sizes_take_few_register_passes(m, passes):
    """The frame lengths users pick in milliseconds (25 ms at 16 kHz, 20 and
    25 ms at 48 kHz, 2400, 3000, 6000) run in register passes only, three
    where radices up to 16 allow it: m = 3000 = 2^3 x 3 x 5^3 needs a fourth
    (each radix takes one 5), which beat three passes with radix 20 or 30
    on the card (tools/profile_fft.py)."""
    plan = rfft_mag.mixed_plan(2 * m)
    assert 2 <= len(plan.radices) <= passes
    assert all(plan.in_registers[p] for p in range(len(plan.radices)))


def test_literal_roots_are_the_rounded_roots():
    """cos_prime / sin_prime's literals are the float32 roundings of the
    float64 roots, as the host's tables round them."""
    assert sorted(ROOTS) == [(3, 1), (5, 1), (5, 2), (7, 1), (7, 2), (7, 3)]
    for (r, e), (c, s) in ROOTS.items():
        assert F32(c) == np.float32(np.cos(2 * np.pi * e / r))
        assert F32(s) == np.float32(np.sin(2 * np.pi * e / r))


@pytest.mark.parametrize("n", SIZES)
def test_magic_division_is_exact(n):
    """div_magic(x, ceil(2^32 / d)) = x // d for every x < 2^14 and every
    divisor the plan's passes use (ns, ns R, R, m / R_0)."""
    rp = Replay(n)
    x = np.arange(1 << 14, dtype=np.uint64)
    divisors = {rp.m // rp.plan.radices[0]}
    for p, r in enumerate(rp.plan.radices):
        divisors |= {r, rp.ns[p], rp.ns[p] * r}
    for d in divisors:
        magic = np.uint64(((1 << 32) + d - 1) // d)
        assert np.array_equal((x * magic) >> np.uint64(32), x // np.uint64(d))


@pytest.mark.parametrize("n", SIZES)
def test_pass_table_is_the_rounded_roots(n):
    """Each register pass after the first has exp(-2 pi i t k / (ns R)) at
    (t - 1) ns + k, each generic pass the ns R roots exp(-2 pi i j / (ns R)),
    rounded to float32 (within half an ulp, 6e-8, of the float64 root)."""
    rp = Replay(n)
    want = []
    for p, r in enumerate(rp.plan.radices):
        ns = rp.ns[p]
        if rp.plan.in_registers[p]:
            if p:
                t, k = np.meshgrid(np.arange(1, r), np.arange(ns),
                                   indexing="ij")
                want.append(np.exp(-2j * np.pi * (t * k).reshape(-1)
                                   / (ns * r)))
        else:
            want.append(np.exp(-2j * np.pi * np.arange(ns * r) / (ns * r)))
    if not want:
        assert rp.table.shape == (1, 2)
        return
    want = np.concatenate(want)
    assert rp.table.shape == (len(want), 2)
    assert np.abs(rp.table[:, 0] - want.real).max() <= 6e-8
    assert np.abs(rp.table[:, 1] - want.imag).max() <= 6e-8


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("n", SIZES)
def test_replay_matches_float64_rfft(n, windowed):
    """The forward replay and the split in float32 within 1e-5 of each
    frame's peak of np.fft.rfft in float64 (a quiet frame too), and every
    pass writes each point once."""
    rng = np.random.default_rng(n + windowed)
    x = rng.standard_normal((3, n)).astype(F32)
    x[2] *= F32(1e-3)
    win = hann_window(n) if windowed else None
    z, written = forward(x, win, n)
    re, im = split(z, n)
    xw = x.astype(np.float64) * (1.0 if win is None else
                                 win.astype(F32).astype(np.float64))
    ref = np.fft.rfft(xw, axis=-1)
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert float((np.abs(re + 1j * im - ref) / peak).max()) <= 1e-5
    for pos in written:
        assert np.array_equal(np.sort(pos), np.arange(n // 2))


@pytest.mark.parametrize("n", SIZES)
def test_inverse_replay_matches_float64_irfft(n):
    """The inverse replay of Z (2 Z from the half spectrum, as the
    projection writes it) within 1e-5 of each frame's peak of np.fft.irfft
    in float64; every pass writes each point once, the last stores each of
    the frame's points once."""
    m = n // 2
    rng = np.random.default_rng(n + 3)
    spec = (rng.standard_normal((3, m + 1))
            + 1j * rng.standard_normal((3, m + 1)))
    spec[:, 0] = spec[:, 0].real
    spec[:, m] = spec[:, m].real
    spec[2] *= 1e-3
    ref = np.fft.irfft(spec, n)
    # Z whose unscaled inverse, times 1/n, is the frame: 2 Z = the packed
    # transform of the frame's samples
    z = np.fft.fft(ref[:, 0::2] + 1j * ref[:, 1::2], axis=-1) * 2
    got, written = inverse(z.astype(C64), None, n)
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    assert float((np.abs(got - ref) / peak).max()) <= 1e-5
    for pos in written:
        assert np.array_equal(np.sort(pos), np.arange(m))


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


@pytest.mark.parametrize("bins", ["phase", "all"])
@pytest.mark.parametrize("n", SIZES)
def test_ke_replay_matches_float64_planes(n, bins):
    """KE on the mixed core: the forward replay and the bin-range pair
    epilogue in float32 within 1e-5 of each frame's peak of
    stft_planes_plain in float64, for the phase encode's bins 1..nf with the
    window and for rfft_planes' bins 0..n/2 of framed input (hop n, no
    window); every bin of the range stored once."""
    m = n // 2
    rng = np.random.default_rng(n + 11)
    if bins == "phase":
        hop, first, count, win = max(1, n // 4), 1, max(1, m * 768 // 1000), \
            hann_window(n)
    else:
        hop, first, count, win = n, 0, m + 1, None
    x = rng.standard_normal(n + 2 * hop).astype(F32)
    framed = frame_signal(torch.from_numpy(x), n, hop).numpy()
    framed[2] *= F32(1e-3)
    z, _ = forward(framed, win, n)
    got, hits = store_planes(z, n, first, count)
    assert np.array_equal(hits, np.ones(count, int))
    x64 = torch.from_numpy(framed.reshape(-1).astype(np.float64))
    ref = rfft_mag.stft_planes_plain(
        x64, None if win is None else torch.from_numpy(
            win.astype(F32)).double(), n, n, first, count).numpy()
    peak = np.abs(rfft_mag.stft_planes_plain(
        x64, None if win is None else torch.from_numpy(
            win.astype(F32)).double(), n, n, 0, m + 1).numpy()).max(
        axis=(-2, -1), keepdims=True)
    assert float((np.abs(got - ref) / peak).max()) <= 1e-5


@pytest.mark.parametrize("mode", ["planes", "spec", "quant8", "quant16"])
@pytest.mark.parametrize("n", SIZES)
def test_kg_replay_matches_float64_plain(n, mode):
    """KG on the mixed core: half_bin of each source mode, the pair
    prologue and the inverse replay (times 1/n and the window) in float32
    within 1e-5 of each frame's peak of irfft_window_plain in float64 on
    the planes, grown spectrogram or dequantized PNG planes (IHS 2 on the
    uint16 planes); the DC and Nyquist imaginary parts the planes carry are
    ignored."""
    m, frames = n // 2, 3
    rng = np.random.default_rng(n + 13)
    win = hann_window(n)
    ext, max_val, ihs = None, 0, 0
    nf = max(1, m * 3 // 4)
    if mode == "planes":
        src = (rng.standard_normal((frames, m + 1)).astype(F32),
               rng.standard_normal((frames, m + 1)).astype(F32))
        re64, im64 = (torch.from_numpy(a).double() for a in src)
    elif mode == "spec":
        src = (rng.standard_normal((frames, nf, 2)) * 20).astype(F32)
        re64, im64 = phase_ops.grow_half_planes(
            torch.from_numpy(src).double(), m)
    else:
        max_val, dt = (255, np.uint8) if mode == "quant8" else \
            (65535, np.uint16)
        ihs = 0 if mode == "quant8" else 2
        src = rng.integers(0, max_val + 1, (nf, frames, 2), dtype=dt)
        ext = (np.array([3.0, 2.5], F32), np.array([-2.0, -1.5], F32))
        spec = quantize.dequantize_planes(torch.from_numpy(src), ext[0],
                                          ext[1], max_val, ihs)
        re64, im64 = phase_ops.grow_half_planes(spec.double(), m)
    re, im = half_bins(src, mode, n, ext, max_val, ihs)
    got, _ = inverse(load_spectrum(re, im, n), win, n)
    ref = istft.irfft_window_plain(re64, im64, n, None).numpy()
    peak = np.abs(ref).max(axis=-1, keepdims=True)
    want = ref * win.astype(F32).astype(np.float64)
    assert float((np.abs(got - want) / peak).max()) <= 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_kg_masked_frames_are_zeros(n):
    """KG's real-frame count on the mixed core's blocks (the plan's frames
    a block, 3 rows whose frame count is no multiple of it, so blocks
    straddle rows): every frame stored once, the masked ones exact zeros,
    the rest the unmasked launch's frame; where a block holds several
    frames, one is live only through the next row's first frame, and a
    count of 0 masks all."""
    per_block = rfft_mag.mixed_plan(n).frames_per_block
    frames = 2 * per_block + 1
    rng = np.random.default_rng(n + 17)
    m = n // 2
    re = rng.standard_normal((3 * frames, m + 1)).astype(F32)
    im = rng.standard_normal((3 * frames, m + 1)).astype(F32)
    full, _ = inverse(load_spectrum(re, im, n), hann_window(n), n)
    for real in (0, 1, frames // 2, frames):
        out, stores, by_next_row = masked_launch(full, frames, real,
                                                 per_block)
        assert np.array_equal(stores, np.ones(3 * frames, int))
        fi = np.arange(3 * frames) % frames
        assert np.array_equal(out[fi >= real], np.zeros_like(out[fi >= real]))
        assert np.array_equal(out[fi < real], full[fi < real])
        if real == 1 and per_block > 1:
            assert by_next_row > 0
