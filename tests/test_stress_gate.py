"""Short-horizon CPU run of the V1_01-realistic stress gate (the full
130 s multi-seed run is scripts/stress_gate.py on the GPU; VERDICT round 1
next #2, round 2 next #1/#4).

Uses the same code path (sim/stress.py: stress trajectory + stress events
+ device renderer -> full pipeline, f32 filter + schur + Newton-Schulz =
the hardware configuration) on a shortened sequence whose stress windows
scale with duration: the run still crosses both texture-poor windows, the
occluder sweep, and the exposure drift.

The gate run executes ONCE (module fixture); the tracking-survival and
ATE assertions are separate tests so a tracking collapse can never hide
inside an accuracy xfail (ADVICE round 2).  The module is subprocess-
isolated (tests/_isolation.py): its full-pipeline chunk scan is the
largest compile in the suite."""
import numpy as np
import jax.numpy as jnp
import pytest

from _isolation import isolate_module

from msckf_stereo_c.config import FilterConfig
from msckf_stereo_c.sim.stress import run_stress_gate

_IN_CHILD, _child_only, test_stress_gate_module_in_subprocess = isolate_module(
    __file__, "MSCKF_STRESS_CHILD"
)


@pytest.fixture(scope="module")
def gate_out():
    return run_stress_gate(
        duration=36.0,
        chunk=128,
        mcfg=FilterConfig(ns_iters=10, matmul_precision="tensorfloat32"),
        filter_dtype=jnp.float32,
        method="schur",
    )


@_child_only
def test_stress_tracking_survives(gate_out):
    """Tracking survives the texture-poor windows and the occluder sweep
    (the filter never free-coasts on IMU alone).  Since the round-4
    photometric realism channels the deepest dip (texture-poor + occluder
    + vignette + noise overlap) is single-digit by design — the bar is
    never-zero plus healthy average tracking, with accuracy enforced by
    test_stress_gate_ate."""
    assert gate_out.min_tracks_after_ransac > 3, gate_out.min_tracks_after_ransac
    tr = np.asarray(gate_out.result.tracking["after_ransac"][5:])
    assert tr.mean() > 30, tr.mean()


@_child_only
def test_stress_gate_ate(gate_out):
    """The end-to-end gate (BASELINE.json: <= 0.13 m on V1_01-like motion).

    Round 3 closed the round-2 drift (0.32-0.97 m): wrong stereo locks along
    the epipolar line are now killed at birth by the left-right round-trip
    check, and the stress trajectory's IMU synthesis is fully analytic —
    see docs/STRESS_NOTES.md."""
    assert gate_out.ate_rmse < 0.13, f"stress ATE {gate_out.ate_rmse:.4f} m"


@_child_only
def test_stress_events_actually_fire():
    """The short run must not silently skip the stress channels: re-derive
    the schedule and check each channel is active for a real fraction."""
    from msckf_stereo_c.sim.render_jax import make_stress_events
    from msckf_stereo_c.sim.trajectory import make_stress_trajectory

    traj = make_stress_trajectory(duration=36.0)
    idx = np.arange(0, traj.t.shape[0], 10)
    ev = make_stress_events(traj, idx)
    assert np.mean(ev.tex_scale < 0.2) > 0.15  # texture-poor windows
    assert np.mean(ev.occ_radius > 0.5) > 0.08  # occluder sweep
    # Photometric realism channels (round 4): on by default in the gate.
    assert ev.noise_read is not None and float(ev.noise_read.min()) > 1.0
    assert ev.noise_shot is not None and float(ev.noise_shot.min()) > 0.0
    assert ev.blur is not None and float(ev.blur.max()) == 1.0
    assert ev.vignette is not None and float(ev.vignette.max()) > 0.2
    assert ev.gain.max() - ev.gain.min() > 0.3  # exposure drift
