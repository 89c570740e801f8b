"""Spectrogram <-> PNG image codecs with embedded float16 metadata.

Copy of ``gomel_tpu/io/imagecodec.py`` (mel and phase codecs): the port
cannot import ``gomel_tpu``, whose package __init__ imports JAX.
tests/test_torch_host.py pins the copy to the original.

Metadata is packed as float16 bytes into the blue channel of column x=0 at
the high-y end. Two layouts exist in the reference and are mutually
incompatible:
- ``layout="go"`` (canonical): mel images use 8 bytes [max, min, samples, sr]
  with a GLOBAL min/max (mel/impl.go:127-193); phase images use 16 bytes
  [max0, max1, 0, min0, min1, 0, samples, sr] with PER-CHANNEL min/max and
  B = -val0 conjugate hint (phase/impl.go:168-278).
- ``layout="py"``: the Python port's 12-byte phase layout
  [max0, max1, min0, min1, samples, sr], B left at 0 (phase.py:643-747).

Quantization matches Go's ``uint8(int(maxVal*val))``: truncation toward zero
with modulo-256/65536 wraparound for the (negative) blue hint values.
"""
from __future__ import annotations

import zlib

import numpy as np

from .float16meta import pack_floats, unpack_floats
from .pngcodec import read_png, write_png

GO_PHASE_META_BYTES = 16
PY_PHASE_META_BYTES = 12
MEL_META_BYTES = 8


def _at_least_rgb(img: np.ndarray) -> np.ndarray:
    """Expand grayscale/gray+alpha PNGs to 3 channels (alpha dropped),
    mirroring Go's image/png->RGBA tolerance for odd color types."""
    if img.ndim == 2:
        return np.stack([img] * 3, axis=-1)
    if img.shape[2] == 2:  # gray + alpha
        g = img[:, :, 0]
        return np.stack([g, g, g], axis=-1)
    return img


def _quantize(vals: np.ndarray, max_val: int) -> np.ndarray:
    """uint8(int(max_val * val)) for val in [0, 1]: truncation, clipped."""
    q = np.trunc(max_val * vals)
    return np.clip(q, 0, max_val)


def _quantize_wrap(vals: np.ndarray, max_val: int) -> np.ndarray:
    """Go's unsigned conversion of possibly-negative ints: truncate toward
    zero, then wrap modulo max_val+1 (two's complement low bits)."""
    q = np.trunc(max_val * vals).astype(np.int64)
    return q & max_val


def dump_buffer_u16(spec: np.ndarray) -> np.ndarray:
    """In-memory uint16 preview image R | G<<8 with per-channel min/max
    (reference ``dumpbuffer``: mel/impl.go:16-44). spec: [F, bins, 2];
    returns flattened [F*bins] uint16 in the reference's y + x*bins order."""
    spec = np.asarray(spec, dtype=np.float64)
    maxs = spec.max(axis=(0, 1))
    mins = spec.min(axis=(0, 1))
    rng = np.where(maxs > mins, maxs - mins, 1.0)
    norm = (spec - mins) / rng
    v0 = np.trunc(255 * norm[:, :, 0]).astype(np.int64)
    v1 = np.trunc(255 * norm[:, :, 1]).astype(np.int64)
    return ((v0 & 0xFFFF) | ((v1 << 8) & 0xFFFF)).astype(np.uint16).reshape(-1)


def save_mel_image(path: str, spec: np.ndarray, y_reverse: bool,
                   samples_in_mel: float, sample_rate: float,
                   compress_level: int = 1,
                   compress_strategy: int = zlib.Z_RLE) -> None:
    """Write a mel spectrogram [F, num_mels, 2] as 8-bit RGBA PNG
    (reference ``dumpimage``: mel/impl.go:127-193)."""
    spec = np.asarray(spec, dtype=np.float64)
    n_frames, mels, _ = spec.shape
    mgc_max = float(spec.max())
    mgc_min = float(spec.min())
    rng = mgc_max - mgc_min
    norm = (spec - mgc_min) / rng if rng > 0 else np.full_like(spec, 0.5)

    img = np.zeros((mels, n_frames, 4), dtype=np.uint8)
    # image[y, x] = spec[x, y] (Go buf[y + x*mels] layout, mel/impl.go:160)
    img[:, :, 0] = _quantize(norm[:, :, 0].T, 255).astype(np.uint8)
    img[:, :, 1] = _quantize(norm[:, :, 1].T, 255).astype(np.uint8)
    img[:, :, 3] = 255
    meta = pack_floats([mgc_max, mgc_min, samples_in_mel, sample_rate])
    meta_start = mels - len(meta)
    img[meta_start:, 0, 2] = np.frombuffer(meta, dtype=np.uint8)
    if y_reverse:
        img = img[::-1, :, :]
    write_png(path, img, compress_level=compress_level,
              compress_strategy=compress_strategy)


def save_mel_image_quantized(path: str, img2: np.ndarray, mgc_max: float,
                             mgc_min: float, y_reverse: bool,
                             samples_in_mel: float, sample_rate: float,
                             compress_level: int = 1,
                             compress_strategy: int = zlib.Z_RLE) -> None:
    """Assemble + write a mel PNG from DEVICE-quantized planes
    (ops/quantize.quantize_mel_plane): img2 is [mels, F, 2] uint8 in image
    layout; mgc_max/mgc_min are the global pre-normalization extrema. Only
    host work left: metadata bytes, y flip, deflate. Byte-compatible with
    save_mel_image output (same reader, mel/impl.go:52-118)."""
    if img2.dtype != np.uint8:
        raise ValueError(f"expected uint8 mel planes, got {img2.dtype}")
    mels, n_frames, _ = img2.shape
    img = np.zeros((mels, n_frames, 4), dtype=np.uint8)
    img[:, :, 0] = img2[:, :, 0]
    img[:, :, 1] = img2[:, :, 1]
    img[:, :, 3] = 255
    meta = pack_floats([float(mgc_max), float(mgc_min), samples_in_mel,
                        sample_rate])
    meta_start = mels - len(meta)
    img[meta_start:, 0, 2] = np.frombuffer(meta, dtype=np.uint8)
    if y_reverse:
        img = img[::-1, :, :]
    write_png(path, img, compress_level=compress_level,
              compress_strategy=compress_strategy)


def load_mel_image_raw(path: str, y_reverse: bool
                       ) -> tuple[np.ndarray, float, float, float, float]:
    """Read a mel PNG WITHOUT de-quantizing: returns (planes [mels, F, 2]
    uint8, mgc_max, mgc_min, samples, sample_rate), including the legacy
    ``max == samples_in_mel`` guard (mel/impl.go:105-107)."""
    img = read_png(path)
    img = _at_least_rgb(img)
    if y_reverse:
        img = img[::-1, :, :]
    mels, n_frames = img.shape[0], img.shape[1]
    if mels < MEL_META_BYTES:
        raise ValueError(
            f"mel image too small for its metadata layout: {mels} rows < "
            f"{MEL_META_BYTES}-byte metadata block")
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    meta_start = mels - MEL_META_BYTES
    meta = bytes(img[meta_start:, 0, 2].tolist())
    mgc_max, mgc_min, samples_in_mel, sr = unpack_floats(meta, 4)
    if mgc_max == samples_in_mel:
        samples_in_mel = 0.0  # legacy guard (mel/impl.go:105-107)
    planes = np.stack([img[:, :, 0], img[:, :, 1]], axis=-1)  # [mels, F, 2]
    return planes, mgc_max, mgc_min, samples_in_mel * n_frames, sr


def load_mel_image(path: str, y_reverse: bool) -> tuple[np.ndarray, float, float]:
    """Read a mel PNG -> (spec [F, num_mels, 2], samples, sample_rate)
    (reference ``loadpng``: mel/impl.go:52-118), including the legacy guard
    ``if max == samples_in_mel: samples_in_mel = 0``."""
    img = read_png(path)
    img = _at_least_rgb(img)
    if y_reverse:
        img = img[::-1, :, :]
    mels, n_frames = img.shape[0], img.shape[1]
    if mels < MEL_META_BYTES:
        raise ValueError(
            f"mel image too small for its metadata layout: {mels} rows < "
            f"{MEL_META_BYTES}-byte metadata block")
    to8 = (lambda v: (v >> 8).astype(np.uint8)) if img.dtype == np.uint16 else (lambda v: v)
    meta_start = mels - MEL_META_BYTES
    meta = bytes(to8(img[meta_start:, 0, 2]).tolist())
    mgc_max, mgc_min, samples_in_mel, sr = unpack_floats(meta, 4)
    if mgc_max == samples_in_mel:
        samples_in_mel = 0.0  # legacy guard (mel/impl.go:105-107)
    val0 = to8(img[:, :, 0]).astype(np.float64) / 255.0
    val1 = to8(img[:, :, 1]).astype(np.float64) / 255.0
    spec = np.stack([val0.T, val1.T], axis=-1)  # [F, mels, 2]
    spec = spec * (mgc_max - mgc_min) + mgc_min
    return spec, samples_in_mel * n_frames, sr


def save_phase_image(path: str, spec: np.ndarray, y_reverse: bool,
                     samples_in_mel: float, sample_rate: float,
                     ihs_passes: int = 0, hdr: bool = False,
                     layout: str = "go", compress_level: int = 1,
                     compress_strategy: int = zlib.Z_RLE) -> None:
    """Write a phase spectrogram [F, num_freqs, 2] as PNG.

    layout="go": 16-byte metadata, B = -val0 hint, RGBA (NRGBA/NRGBA64 parity,
    phase/impl.go:168-278).
    layout="py": 12-byte metadata, B = 0, RGB (phase.py:643-747).
    ``compress_level``: lossless deflate speed/size trade (pngcodec.write_png).
    """
    spec = np.asarray(spec, dtype=np.float64)
    for _ in range(ihs_passes):
        spec = np.arcsinh(spec)
    n_frames, nf, _ = spec.shape
    maxs = spec.max(axis=(0, 1))  # per-channel (phase/impl.go:198-212)
    mins = spec.min(axis=(0, 1))
    rng = maxs - mins
    norm = np.where(rng > 0, (spec - mins) / np.where(rng > 0, rng, 1.0), 0.5)

    max_val = 65535 if hdr else 255
    dtype = np.uint16 if hdr else np.uint8
    channels = 4 if layout == "go" else 3
    img = np.zeros((nf, n_frames, channels), dtype=dtype)
    img[:, :, 0] = _quantize(norm[:, :, 0].T, max_val).astype(dtype)
    img[:, :, 1] = _quantize(norm[:, :, 1].T, max_val).astype(dtype)
    if layout == "go":
        # blue = -val0 with Go's wrapping conversion (phase/impl.go:229,256)
        img[:, :, 2] = _quantize_wrap(-norm[:, :, 0].T, max_val).astype(dtype)
        img[:, :, 3] = max_val
        meta = pack_floats([maxs[0], maxs[1], 0.0, mins[0], mins[1], 0.0,
                            samples_in_mel, sample_rate])
    elif layout == "py":
        meta = pack_floats([maxs[0], maxs[1], mins[0], mins[1],
                            samples_in_mel, sample_rate])
    else:
        raise ValueError(f"unknown layout {layout!r}")
    meta_start = nf - len(meta)
    # metadata byte values 0-255 stored directly, even in 16-bit images
    # (phase/impl.go:239, phase.py:714)
    img[meta_start:, 0, 2] = np.frombuffer(meta, dtype=np.uint8).astype(dtype)
    if y_reverse:
        img = img[::-1, :, :]
    write_png(path, img, compress_level=compress_level,
              compress_strategy=compress_strategy)


def save_phase_image_quantized(path: str, img2: np.ndarray, maxs, mins,
                               y_reverse: bool, samples_in_mel: float,
                               sample_rate: float, hdr: bool = False,
                               layout: str = "go",
                               compress_level: int = 1,
                               compress_strategy: int = zlib.Z_RLE) -> None:
    """Assemble + write a phase PNG from DEVICE-quantized planes
    (ops/quantize.quantize_planes): img2 is [nf, F, 2] uint8/uint16 in image
    layout; maxs/mins are the per-channel pre-normalization extrema. Only
    host work left: the derived B channel, metadata bytes, y flip, deflate.
    Byte-compatible with save_phase_image output (same readers)."""
    nf, n_frames, _ = img2.shape
    max_val = 65535 if hdr else 255
    dtype = np.uint16 if hdr else np.uint8
    if img2.dtype != dtype:
        raise ValueError(f"expected {dtype} planes for hdr={hdr}, "
                         f"got {img2.dtype}")
    channels = 4 if layout == "go" else 3
    img = np.zeros((nf, n_frames, channels), dtype=dtype)
    img[:, :, 0] = img2[:, :, 0]
    img[:, :, 1] = img2[:, :, 1]
    if layout == "go":
        # B = trunc(max_val * -norm0) & max_val == (-v0) & max_val because
        # trunc is odd and v0 = trunc(max_val * norm0) is unclipped for
        # norm0 in [0, 1] (phase/impl.go:229,256)
        img[:, :, 2] = ((-img2[:, :, 0].astype(np.int64)) & max_val
                        ).astype(dtype)
        img[:, :, 3] = max_val
        meta = pack_floats([float(maxs[0]), float(maxs[1]), 0.0,
                            float(mins[0]), float(mins[1]), 0.0,
                            samples_in_mel, sample_rate])
    elif layout == "py":
        meta = pack_floats([float(maxs[0]), float(maxs[1]),
                            float(mins[0]), float(mins[1]),
                            samples_in_mel, sample_rate])
    else:
        raise ValueError(f"unknown layout {layout!r}")
    meta_start = nf - len(meta)
    img[meta_start:, 0, 2] = np.frombuffer(meta, dtype=np.uint8).astype(dtype)
    if y_reverse:
        img = img[::-1, :, :]
    write_png(path, img, compress_level=compress_level,
              compress_strategy=compress_strategy)


def _detect_phase_layout(img: np.ndarray) -> str:
    """Layout detection for ``layout="auto"``.

    Primary discriminator: the Go writer stores the conjugate hint B = -val0
    in the blue channel of EVERY pixel (phase/impl.go:229,256),
    while the Python port leaves blue at 0 everywhere except the metadata
    bytes in column 0 (phase.py:695-714). Any nonzero blue
    OUTSIDE the 16-byte metadata window therefore proves "go" — this covers
    silent/constant audio (Go quantizes the degenerate norm 0.5 to a nonzero
    hint) and images whose channel-0 content is concentrated anywhere
    visible.

    If the entire visible blue plane is zero (normal for every py image; for
    a Go image it requires all visible val0 to quantize to 0, i.e. the
    channel maximum hiding under the metadata bytes), fall back to the block
    structure: bytes 0:4 of the Go window hold float16 max0/max1 (nonzero
    unless both maxima are exactly 0), while for py those rows are data
    (blue 0).

    The residual ambiguity defaults to "py" — and is HARMLESS: reaching it
    requires every max/min float16 to be zero in both interpretations, and
    the go block's [samples, sr] bytes sit at the SAME absolute rows
    (nf-4..nf) as py's (go offsets 12:16 of a 16-byte block == py offsets
    8:12 of a 12-byte block), so both interpretations decode the identical
    all-zero spectrogram with identical samples/sr
    (tests/test_untrusted_images.py::test_layout_autodetect_fuzz asserts
    load-level equivalence for this family).
    """
    nf = img.shape[0]
    if nf < GO_PHASE_META_BYTES:
        return "py"  # cannot be the 16-byte Go layout
    meta_start = nf - GO_PHASE_META_BYTES
    if np.any(img[:, 1:, 2]) or np.any(img[:meta_start, 0, 2]):
        return "go"
    blue = img[meta_start:, 0, 2]
    if img.dtype == np.uint16:
        blue = blue & 0xFF
    if np.any(blue[:4]):  # go's max0/max1 float16 bytes
        return "go"
    return "py"


def load_phase_image_raw(path: str, y_reverse: bool, hdr: bool = False,
                         layout: str = "auto"
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray,
                                    float, float, int]:
    """Read a phase PNG WITHOUT de-quantizing: returns (planes [nf, F, 2]
    uint8|uint16, maxs [2], mins [2], samples, sample_rate, num_freqs).

    The device-dequantize fast path (ops/quantize.dequantize_planes,
    Phase(device_quantize=True).to_wav_png) uploads these integer planes —
    4x (8-bit) / 2x (HDR) less host->device traffic than the float
    spectrogram — and runs rescale + sinh-undo + decode in one program.
    """
    (r, g, max0, max1, min0, min1, samples_in_mel, sr, nf,
     n_frames, _max_val) = _load_phase_planes(path, y_reverse, hdr, layout)
    planes = np.stack([r, g], axis=-1)  # [nf, F, 2] integer
    return (planes, np.array([max0, max1]), np.array([min0, min1]),
            samples_in_mel * n_frames, sr, nf)


def _load_phase_planes(path: str, y_reverse: bool, hdr: bool,
                       layout: str):
    """Shared PNG read + metadata unpack: returns INTEGER r/g planes
    [nf, F] plus unpacked metadata (the common prefix of the host and
    device de-quantization paths)."""
    img = read_png(path)
    img = _at_least_rgb(img)
    if y_reverse:
        img = img[::-1, :, :]
    nf, n_frames = img.shape[0], img.shape[1]
    if layout == "auto":
        layout = _detect_phase_layout(img)
    if layout not in ("go", "py"):
        raise ValueError(f"unknown metadata layout {layout!r}")
    need = GO_PHASE_META_BYTES if layout == "go" else PY_PHASE_META_BYTES
    if nf < need:
        raise ValueError(
            f"phase image too small for {layout!r} metadata layout: "
            f"{nf} rows < {need}-byte metadata block")

    if hdr:
        # HDR: 16-bit samples; metadata stored as low byte (phase/impl.go:91-93)
        if img.dtype != np.uint16:
            raise ValueError("expected 16-bit PNG for HDR load")
        blue_bytes = (img[:, 0, 2] & 0xFF).astype(np.uint8)
        max_val = 65535.0
        r = img[:, :, 0]
        g = img[:, :, 1]
    else:
        if img.dtype == np.uint16:
            img8 = (img >> 8).astype(np.uint8)
        else:
            img8 = img
        blue_bytes = img8[:, 0, 2]
        max_val = 255.0
        r = img8[:, :, 0]
        g = img8[:, :, 1]

    if layout == "go":
        meta = bytes(blue_bytes[nf - GO_PHASE_META_BYTES:].tolist())
        vals = unpack_floats(meta, 8)
        max0, max1, _, min0, min1, _, samples_in_mel, sr = vals
    else:
        meta = bytes(blue_bytes[nf - PY_PHASE_META_BYTES:].tolist())
        vals = unpack_floats(meta, 6)
        max0, max1, min0, min1, samples_in_mel, sr = vals
    return (r, g, max0, max1, min0, min1, samples_in_mel, sr, nf,
            n_frames, max_val)


def load_phase_image(path: str, y_reverse: bool, ihs_passes: int = 0,
                     hdr: bool = False, layout: str = "auto"
                     ) -> tuple[np.ndarray, float, float, int]:
    """Read a phase PNG -> (spec [F, num_freqs, 2], samples, sample_rate,
    num_freqs). Reference: phase/impl.go:51-153 (Go layout) and
    phase.py:750-852 (Python layout)."""
    (r, g, max0, max1, min0, min1, samples_in_mel, sr, nf,
     n_frames, max_val) = _load_phase_planes(path, y_reverse, hdr, layout)
    val0 = r.astype(np.float64) / max_val
    val1 = g.astype(np.float64) / max_val
    spec = np.stack([val0.T, val1.T], axis=-1)  # [F, nf, 2]
    spec[:, :, 0] = spec[:, :, 0] * (max0 - min0) + min0
    spec[:, :, 1] = spec[:, :, 1] * (max1 - min1) + min1
    for _ in range(ihs_passes):
        spec = np.sinh(spec)
    return spec, samples_in_mel * n_frames, sr, nf
