"""The numpy PNG codec (data.png) against OpenCV's libpng decoder: 8- and
16-bit grayscale under every row filter, files libpng wrote with its own
filter choice, round trips, and the loader's 8-bit conversion."""

import struct
import zlib

import numpy as np
import pytest

from rsvio_tpu.data import png
from rsvio_tpu.data.players import _load_gray


def _image(dtype, H=37, W=53, seed=0):
    rng = np.random.default_rng(seed)
    smooth = np.kron(rng.uniform(0, 1, (H // 4 + 1, W // 4 + 1)),
                     np.ones((4, 4)))[:H, :W]
    noise = rng.uniform(0, 0.2, (H, W))
    top = np.iinfo(dtype).max
    return np.clip((0.8 * smooth + noise) * top, 0, top).astype(dtype)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decode_equals_cv2_for_each_filter(tmp_path, dtype, filter_type):
    cv2 = pytest.importorskip("cv2")
    img = _image(dtype, seed=filter_type)
    path = str(tmp_path / "f.png")
    png.write_png(path, img, filter_type)
    ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(ref, img)
    got = png.read_png(path)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_decode_files_written_by_libpng(tmp_path, dtype):
    cv2 = pytest.importorskip("cv2")
    img = _image(dtype, H=64, W=80, seed=7)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img)
    np.testing.assert_array_equal(png.read_png(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_round_trip(tmp_path, dtype):
    img = _image(dtype, H=480, W=752, seed=3)
    path = str(tmp_path / "rt.png")
    png.write_png(path, img)
    np.testing.assert_array_equal(png.read_png(path), img)


def test_loader_conversion_matches_cv2_grayscale(tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = _image(np.uint16, seed=11)
    path = str(tmp_path / "g16.png")
    png.write_png(path, img)
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE).astype(np.float32)
    np.testing.assert_array_equal(_load_gray(path), ref)


def test_unsupported_png_raises_with_file_name(tmp_path):
    path = tmp_path / "interlaced.png"
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 1)   # Adam7 interlace

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(b"\0" * 20))
                     + chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="interlaced.png"):
        png.read_png(str(path))
