"""Image read/write: PNG / PPM / EXR / NPZ-float + ASCII preview.

Replaces the reference's image paths: `sutil::saveImage`/`loadImage` (PPM/PNG/EXR
via stb + tinyexr, `SDK/sutil/sutil.h:99-100`, `sutil.cpp`), `PPMLoader`
(`sutil/PPMLoader.{h,cpp}`), and the `optixConsole` luminance-mapped ASCII dump
(`SDK/optixConsole/optixConsole.cpp:697-760`). PNG is a stdlib-zlib codec
(8-bit, non-interlaced: what the framework writes and what most tools
emit); HDR
float layers (denoiser AOVs, beauty) use the from-scratch EXR codec in
io/exr.py (the tinyexr role) — .npz remains as a fallback container.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # color type -> samples/pixel


def save_image(path: str, pixels: np.ndarray) -> None:
    """Save uint8 RGB(A) [H, W, C] or float [H, W, 3] (auto-encoded) images.

    Dispatch by extension like `sutil::saveImage`: .png/.ppm for display
    images, .npz for float/HDR layers.
    """
    pixels = np.asarray(pixels)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        np.savez_compressed(path, image=pixels.astype(np.float32))
        return
    if ext == ".exr":
        from .exr import write_exr
        write_exr(path, pixels.astype(np.float32))
        return
    if pixels.dtype != np.uint8:
        # Linear float → sRGB uint8 (what saveImage does for float buffers).
        from ..core.film import linear_to_srgb
        import jax.numpy as jnp
        pixels = np.asarray(
            (np.clip(np.asarray(linear_to_srgb(jnp.asarray(pixels))), 0, 1) * 255.99999)
        ).astype(np.uint8)
    if ext == ".ppm":
        _save_ppm(path, pixels[..., :3])
        return
    _save_png(path, pixels)


def load_image(path: str) -> np.ndarray:
    """Load an image; uint8 for PNG/PPM, float32 [H, W, ...] for .npz."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        with np.load(path) as z:
            return z["image"]
    if ext == ".exr":
        from .exr import read_exr
        return read_exr(path)
    if ext == ".ppm":
        return _load_ppm(path)
    return _load_png(path)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _save_png(path: str, pixels: np.ndarray) -> None:
    """8-bit grey/RGB/RGBA PNG, filter type 0 on every row."""
    img = np.ascontiguousarray(pixels, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                color_type, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _load_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced grey/RGB/grey-alpha/RGBA PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = header
    if depth != 8 or interlace or color_type not in _PNG_CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) "
                         f"PNG is supported (depth={depth}, "
                         f"color_type={color_type}, interlace={interlace})")
    c = _PNG_CHANNELS[color_type]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if ftype > 4:
            raise ValueError(f"{path}: row {y} has PNG filter type {ftype}")
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:          # Sub, Average and Paeth depend on the left pixel
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - c] if x >= c else 0
                b = prev[x]
                if ftype == 1:
                    p = a
                elif ftype == 3:
                    p = (a + b) >> 1
                else:
                    cc = prev[x - c] if x >= c else 0
                    pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                         else cc)
                cur[x] = (line[x] + p) & 0xFF
        out[y] = cur
        prev = cur
    img = out.reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def _save_ppm(path: str, rgb: np.ndarray) -> None:
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb, dtype=np.uint8).tobytes())


def _load_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # Minimal P6 parser (binary PPM) with comment skipping.
    tokens, i = [], 0
    while len(tokens) < 4:
        while i < len(data) and data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while i < len(data) and data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j:j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    assert tokens[0] == b"P6", "only binary PPM (P6) supported"
    w, h = int(tokens[1]), int(tokens[2])
    i += 1  # single whitespace after maxval
    return np.frombuffer(data, np.uint8, count=w * h * 3, offset=i).reshape(h, w, 3)


ASCII_RAMP = " .:-=+*#%@"


def to_ascii(rgb: np.ndarray, width: int = 96) -> str:
    """Luminance-mapped ASCII art of an image — the `optixConsole` output mode
    (`optixConsole.cpp:697-760`), used for headless smoke tests."""
    img = np.asarray(rgb, np.float32)
    if img.dtype == np.uint8 or img.max() > 1.5:
        img = img / 255.0
    h, w = img.shape[:2]
    ch = max(1, int(round(width * h / w * 0.5)))
    ys = np.linspace(0, h - 1, ch).astype(int)
    xs = np.linspace(0, w - 1, width).astype(int)
    lum = img[..., :3] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    sub = lum[np.ix_(ys, xs)]
    idx = np.clip((sub * (len(ASCII_RAMP) - 1)).round().astype(int), 0, len(ASCII_RAMP) - 1)
    return "\n".join("".join(ASCII_RAMP[v] for v in row) for row in idx)
