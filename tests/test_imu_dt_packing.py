"""Host-exact IMU dt packing (ImuBatch.dt): the f32 device path must not lose
time resolution to absolute-timestamp subtraction at long horizons (f32 eps
at t=130 s is ~1e-5 s = 0.2% of the 5 ms IMU interval)."""
import numpy as np
import jax.numpy as jnp

from msckf_stereo_c.models.runner import pack_imu_batches


def _world(T=40, rate=200.0, fps=20.0, t0=0.0, seed=0):
    rng = np.random.default_rng(seed)
    imu_t = t0 + np.arange(int(T * fps * rate / fps)) / rate
    frame_t = t0 + np.arange(int(T)) / fps + 0.001
    gyro = rng.standard_normal((len(imu_t), 3))
    acc = rng.standard_normal((len(imu_t), 3))
    return imu_t, gyro, acc, frame_t


def test_fresh_pack_dt_semantics():
    imu_t, gyro, acc, frame_t = _world(T=8)
    b = pack_imu_batches(imu_t, gyro, acc, frame_t, 16)
    dt = np.asarray(b.dt)
    valid = np.asarray(b.valid)
    # Frame 0: blind row (sentinel -1 on consumed slots).
    assert (dt[0][valid[0]] == -1.0).all()
    # First consumed slot after the blind row is the device-derived one.
    assert dt[1, 0] == -1.0
    # Everything else is the exact IMU interval.
    rest = np.concatenate([dt[1, 1:][valid[1, 1:]], dt[2:][valid[2:]]])
    np.testing.assert_allclose(rest, 1.0 / 200.0, rtol=0, atol=1e-12)


def test_chunked_pack_matches_full():
    imu_t, gyro, acc, frame_t = _world(T=20)
    full = pack_imu_batches(imu_t, gyro, acc, frame_t, 16)
    h = 11
    a = pack_imu_batches(imu_t, gyro, acc, frame_t[:h], 16)
    b = pack_imu_batches(
        imu_t, gyro, acc, frame_t[h:], 16, prev_frame_t=float(frame_t[h - 1])
    )
    for f, parts in (("time", None), ("gyro", None), ("acc", None), ("valid", None), ("dt", None)):
        fa = np.concatenate([np.asarray(getattr(a, f)), np.asarray(getattr(b, f))])
        np.testing.assert_array_equal(fa, np.asarray(getattr(full, f)), err_msg=f)


def test_dt_exact_at_long_horizon():
    # Absolute times near 130 s in float32 cannot represent 5 ms steps
    # exactly; the packed dt must still be exact because it is computed in
    # float64 on the host BEFORE any cast.
    imu_t, gyro, acc, frame_t = _world(T=8, t0=130.0)
    b = pack_imu_batches(imu_t, gyro, acc, frame_t, 16, dtype=np.float32)
    t32 = np.asarray(b.time)
    valid = np.asarray(b.valid)
    dt = np.asarray(b.dt)

    # The f32 absolute-time differences are visibly quantized...
    naive = np.diff(t32[2][valid[2]])
    assert np.abs(naive - 0.005).max() > 2e-6
    # ...while the packed deltas are exact to f32 rounding of 5 ms.
    good = dt[2][valid[2]]
    np.testing.assert_allclose(good, 0.005, rtol=0, atol=1e-9)


def test_cap_gap_spans_dropped_samples():
    imu_t, gyro, acc, frame_t = _world(T=6)
    L = 6  # fewer slots than the ~10 samples per frame -> cap engages
    b = pack_imu_batches(imu_t, gyro, acc, frame_t, L)
    dt = np.asarray(b.dt)
    valid = np.asarray(b.valid)
    assert valid[2].all()
    # First kept slot of frame 2 spans frame 1's kept tail + frame 2's
    # dropped head; the chain still telescopes to the consumed-time span.
    t2 = np.asarray(b.time)[2]
    t1_last = np.asarray(b.time)[1][valid[1]][-1]
    np.testing.assert_allclose(dt[2].sum(), t2[-1] - t1_last, atol=1e-12)
    assert dt[2, 0] > 0.005  # the gap
