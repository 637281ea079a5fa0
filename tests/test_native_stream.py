"""Native runtime concurrency + parser edge cases (VERDICT round 1 #6).

The threaded prefetch stream (native/euroc_runtime.cpp:134-172) claims
strict in-order delivery with a bounded look-ahead queue; round 1 only ever
decoded 5 images through it.  Here: ~200 PNGs through 4 workers with a slow
consumer and a tiny queue (backpressure genuinely binds), tiny batch reads,
plus CSV parser edge cases (comments, blanks, CRLF, junk lines) checked
against the Python loader."""
import os
import time

import numpy as np
import pytest

from msckf_stereo_c.io import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native runtime not built (make -C native)"
)

W, H = 96, 64


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    import cv2

    d = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    files = []
    n = 200
    for i in range(n):
        img = rng.integers(0, 200, (H, W), np.uint8)
        # Encode the frame index into the first 4 pixels so delivery order
        # is checkable from content alone.
        img[0, 0] = i % 256
        img[0, 1] = i // 256
        img[0, 2] = 170
        img[0, 3] = 85
        p = str(d / f"{i:06d}.png")
        cv2.imwrite(p, img)
        files.append((p, img))
    return files


def _frame_index(frame: np.ndarray) -> int:
    assert frame[0, 2] == 170 and frame[0, 3] == 85, "marker corrupted"
    return int(frame[0, 0]) + 256 * int(frame[0, 1])


def test_stream_in_order_with_slow_consumer_and_tiny_queue(png_dir):
    files = [p for p, _ in png_dir]
    # queue_depth=6 << 200 files: workers must block on backpressure while
    # the consumer dawdles; delivery must still be exactly 0..199.
    s = native.ImageStream(files, W, H, queue_depth=6, threads=4)
    got = []
    while True:
        time.sleep(0.002)  # slow consumer
        batch = s.next_batch(7)  # ragged batch size on purpose
        if batch.shape[0] == 0:
            break
        got.extend(_frame_index(f) for f in batch)
    assert s.errors == 0
    s.close()
    assert got == list(range(len(files)))


def test_stream_content_exact(png_dir):
    files = [p for p, _ in png_dir][:40]
    s = native.ImageStream(files, W, H, queue_depth=16, threads=4)
    out = s.next_batch(40)
    assert s.errors == 0
    s.close()
    for i, (_, ref) in enumerate(png_dir[:40]):
        np.testing.assert_array_equal(out[i], ref)


def test_stream_single_thread_single_depth(png_dir):
    """Degenerate configuration (1 worker, depth 1) still delivers all
    frames in order — the strictest backpressure case."""
    files = [p for p, _ in png_dir][:25]
    s = native.ImageStream(files, W, H, queue_depth=1, threads=1)
    got = []
    while True:
        b = s.next_batch(3)
        if b.shape[0] == 0:
            break
        got.extend(_frame_index(f) for f in b)
    s.close()
    assert got == list(range(25))


def test_stream_decode_error_counted(png_dir, tmp_path):
    bad = str(tmp_path / "corrupt.png")
    with open(bad, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\nnot really a png")
    files = [png_dir[0][0], bad, png_dir[1][0]]
    s = native.ImageStream(files, W, H, queue_depth=4, threads=2)
    out = s.next_batch(3)
    assert out.shape[0] == 3
    assert s.errors == 1
    # The bad slot arrives zero-filled; the good ones intact and in order.
    assert _frame_index(out[0]) == 0
    assert (out[1] == 0).all()
    assert _frame_index(out[2]) == 1
    s.close()


def test_imu_csv_edge_cases(tmp_path):
    """Comments, blank lines, CRLF endings, and junk rows are skipped; the
    values match the Python csv loader."""
    p = tmp_path / "data.csv"
    rows = [
        "#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z",
        "",
        "1403636579758555520,-0.1,0.2,-0.3,9.0,0.5,-0.25",
        "# a comment mid-file",
        "1403636579763555520,0.01,0.02,0.03,0.1,0.2,0.3\r",
        "garbage line without numbers",
        "1403636579768555520,-1e-3,2e-3,-3e-3,9.81,0,0",
        "",
    ]
    p.write_text("\n".join(rows) + "\n")
    t, gyro, acc = native.load_imu_csv(str(p))
    assert len(t) == 3
    np.testing.assert_allclose(t[0], 1403636579.758555520)
    np.testing.assert_allclose(gyro[1], [0.01, 0.02, 0.03])
    np.testing.assert_allclose(acc[2], [9.81, 0.0, 0.0])
    np.testing.assert_allclose(gyro[2], [-1e-3, 2e-3, -3e-3])


def test_cam_csv_and_unsynced_stereo(tmp_path):
    """The native cam-CSV parser agrees with the Python loader, and
    synchronize_stereo drops unpairable frames (the reference only warns,
    image_processor.cpp:703-706)."""
    import ctypes

    from msckf_stereo_c.io.euroc import load_sequence, synchronize_stereo

    root = tmp_path / "mav0"
    t0 = 1403636579758555520
    # cam0 has 6 frames; cam1 is missing frame 2 and has one off-sync frame.
    cam0_ts = [t0 + int(i * 0.05e9) for i in range(6)]
    cam1_ts = [t for i, t in enumerate(cam0_ts) if i != 2]
    cam1_ts[3] += int(0.02e9)  # 20 ms off: beyond the 4 ms pairing gate
    for cam, ts in (("cam0", cam0_ts), ("cam1", cam1_ts)):
        os.makedirs(root / cam / "data", exist_ok=True)
        with open(root / cam / "data.csv", "w") as f:
            f.write("#timestamp [ns],filename\n\n")
            for t in ts:
                f.write(f"{t},{t}.png\r\n")
        import cv2

        for t in ts:
            cv2.imwrite(str(root / cam / "data" / f"{t}.png"), np.zeros((H, W), np.uint8))
    os.makedirs(root / "imu0", exist_ok=True)
    with open(root / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        f.write(f"{t0},0,0,0,0,0,9.81\n")

    # Native cam CSV parse matches the Python index.
    lib = native.load_library()
    t_ns = np.empty(64, np.int64)
    names = ctypes.create_string_buffer(4096)
    n = lib.mr_load_cam_csv(
        str(root / "cam0" / "data.csv").encode(),
        t_ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        names,
        4096,
        64,
    )
    assert n == 6
    np.testing.assert_array_equal(t_ns[:6], cam0_ts)
    first = names.raw.split(b"\0")[0].decode()
    assert first == f"{cam0_ts[0]}.png"  # CRLF trimmed

    seq = load_sequence(str(root))
    times, f0, f1 = synchronize_stereo(seq)
    # 6 cam0 frames - 1 missing partner - 1 off-sync partner = 4 pairs.
    assert len(times) == 4
    missing = cam0_ts[2] * 1e-9
    offsync = cam0_ts[4] * 1e-9
    assert all(abs(t - missing) > 1e-6 and abs(t - offsync) > 1e-6 for t in times)
