"""Standard-library PNG codec (io/png.py): round trips against OpenCV's
codec, every PNG row filter at full EuRoC size, batched decoding, the
fallback path of ImageSource, and refusal of what it does not support."""
import cv2
import numpy as np
import pytest

from msckf_stereo_c.io.png import (
    decode_gray8,
    encode_gray8,
    read_gray8,
    read_gray8_batch,
    write_gray8,
)


def _image(seed=0, H=48, W=75):
    rng = np.random.default_rng(seed)
    ramp = (np.arange(W)[None, :] * 3 + np.arange(H)[:, None] * 5) % 256
    return (ramp + rng.integers(0, 40, (H, W))).astype(np.uint8)


def test_round_trip_against_cv2(tmp_path):
    img = _image()
    ours = encode_gray8(img)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_UNCHANGED), img
    )
    ok, theirs = cv2.imencode(".png", img)
    assert ok
    np.testing.assert_array_equal(decode_gray8(theirs.tobytes()), img)
    path = str(tmp_path / "a.png")
    write_gray8(path, img)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_GRAYSCALE), img)
    np.testing.assert_array_equal(read_gray8(path), img)


def _cv2_decode(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)


def test_every_row_filter():
    img = _image(seed=1, H=10)
    ftypes = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    data = encode_gray8(img, ftypes)
    np.testing.assert_array_equal(_cv2_decode(data), img)
    np.testing.assert_array_equal(decode_gray8(data), img)


@pytest.mark.parametrize("filters", ["paeth", "average", "mixed"])
def test_full_frame_filters(filters):
    """752x480, the EuRoC frame: Average and Paeth rows chain every pixel to
    its left neighbour, the decoder's hardest case."""
    img = _image(seed=2, H=480, W=752)
    ftypes = {"paeth": 4, "average": 3,
              "mixed": np.random.default_rng(3).integers(0, 5, 480)}[filters]
    data = encode_gray8(img, ftypes)
    np.testing.assert_array_equal(_cv2_decode(data), img)
    np.testing.assert_array_equal(decode_gray8(data), img)


def test_batch_decode_matches_cv2(tmp_path):
    """One wavefront over several images, each with its own row filters,
    in groups that do not divide the file count."""
    paths, imgs = [], []
    for i, filters in enumerate([4, 3, 0, 1, 2, [4, 0, 3, 1, 2] * 4, 4]):
        img = _image(seed=10 + i, H=20, W=33)
        paths.append(str(tmp_path / f"{i}.png"))
        write_gray8(paths[-1], img, filters)
        imgs.append(img)
    got = read_gray8_batch(paths, group=3)
    np.testing.assert_array_equal(got, np.stack(imgs))
    for p, g in zip(paths, got):
        np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), g)


def test_image_source_without_native(tmp_path, monkeypatch):
    """Without the native runtime ImageSource decodes chunks on io/png.py."""
    from msckf_stereo_c.io import native
    from msckf_stereo_c.io.euroc import ImageSource

    monkeypatch.setattr(native, "available", lambda: False)
    paths, imgs = [], []
    for i in range(5):
        img = _image(seed=20 + i, H=24, W=40)
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], img)
        imgs.append(img)
    with ImageSource(paths, width=40, height=24) as src:
        assert src._stream is None
        got = np.concatenate([src.next(2), src.next(2), src.next(2)])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.stack(imgs).astype(np.float32))


def test_refuses_colour_and_bad_input():
    ok, rgb = cv2.imencode(".png", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="grayscale"):
        decode_gray8(rgb.tobytes())
    with pytest.raises(ValueError, match="not a PNG"):
        decode_gray8(b"GIF89a")
    with pytest.raises(ValueError):
        encode_gray8(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        encode_gray8(np.zeros((4, 4), np.uint8), 5)
