"""Headless smoke tests of the first apps (the optixConsole pattern:
deterministic render → programmatic inspection, SURVEY.md §4)."""
import numpy as np
import pytest

from optix_raytracer_tpu.apps import hello, triangle


class TestHello:
    def test_solid_color(self):
        img = np.asarray(hello.render(64, 48, color=(0.462, 0.725, 0.0)))
        assert img.shape == (48, 64, 4)
        # Every pixel identical, alpha opaque, sRGB-encoded green dominant.
        assert (img == img[0, 0]).all()
        r, g, b, a = img[0, 0]
        assert a == 255 and g > r > b


class TestTriangle:
    def test_hit_and_miss_regions(self):
        img = np.asarray(triangle.render(96, 96))
        h, w = 96, 96
        center = img[h // 2, w // 2]
        corner = img[2, 2]
        # center hits the triangle (barycentric shading → not the miss color)
        assert (center[:3] != corner[:3]).any()
        # corner is the miss color: blue-ish gradient base
        assert corner[2] > corner[0]

    def test_deterministic(self):
        a = np.asarray(triangle.render(64, 64))
        b = np.asarray(triangle.render(64, 64))
        np.testing.assert_array_equal(a, b)

    def test_io_roundtrip(self, tmp_path):
        from optix_raytracer_tpu.io.image import load_image, save_image
        img = np.asarray(triangle.render(32, 32))
        for name in ["t.png", "t.ppm"]:
            path = str(tmp_path / name)
            save_image(path, img)
            back = load_image(path)
            np.testing.assert_array_equal(back[..., :3], img[..., :3])


def _png_with_filter(img, ftype):
    """Encode uint8 [H, W, C] as a PNG whose every row uses filter `ftype`,
    straight from the PNG specification (independent of io/image.py)."""
    import struct
    import zlib
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int32)
    out = bytearray()
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(ftype)
        out += ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_decoder_row_filters(tmp_path, ftype, channels):
    from optix_raytracer_tpu.io.image import load_image
    img = np.random.default_rng(ftype).integers(0, 256, (7, 5, channels),
                                                dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_with_filter(img, ftype))
    back = load_image(str(path))
    np.testing.assert_array_equal(back, img[..., 0] if channels == 1
                                  else img)


def test_png_decoder_rejects_bad_filter(tmp_path):
    import struct
    import zlib
    from optix_raytracer_tpu.io.image import load_image
    data = bytearray(_png_with_filter(np.zeros((2, 2, 3), np.uint8), 0))
    # rebuild IDAT with filter byte 7 on the first row
    raw = bytes([7]) + bytes(6) + bytes([0]) + bytes(6)
    body = zlib.compress(raw)
    idat = (struct.pack(">I", len(body)) + b"IDAT" + body
            + struct.pack(">I", zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF))
    start = 8 + 25                       # signature + IHDR chunk
    end = data.index(b"IEND") - 4
    path = tmp_path / "bad.png"
    path.write_bytes(bytes(data[:start]) + idat + bytes(data[end:]))
    with pytest.raises(ValueError, match="filter type 7"):
        load_image(str(path))
