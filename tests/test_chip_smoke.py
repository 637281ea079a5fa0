"""chip_smoke.py, the GPU smoke run: its phases at small sizes on the CPU
(the kernel through the Pallas interpreter), its refusal to run without a
GPU, and the same kernel phase compiled for the card (``gpu`` marker)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_kernel_phase_interpret(capsys):
    """The kernel phase's comparison at a block-ragged width (N=37)."""
    chip_smoke.phase_kernels(B=2, N=37, loop="interpret", reps=1)
    out = capsys.readouterr().out
    assert "valid identical" in out and "K=21" in out


@pytest.mark.gpu
def test_kernel_phase_on_gpu(gpu):
    """The Triton kernel compiled for the card, at B=16 x 96 features."""
    chip_smoke.phase_kernels()


def test_refuses_cpu_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_refuses_outside_the_repo(tmp_path):
    """Alone in a directory, the script fails before printing a result."""
    (tmp_path / "chip_smoke.py").write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_synthetic_euroc_round_trip(tmp_path, capsys):
    """The written mav0 loads through the EuRoC reader: synchronized stereo
    at 20 Hz, 200 Hz IMU, ground truth per frame, exact 8-bit PNGs; the
    decode report names the decoder in use."""
    from msckf_stereo_c.io.euroc import load_images, load_sequence, synchronize_stereo
    from msckf_stereo_c.io.png import read_gray8

    root = str(tmp_path / "mav0")
    chip_smoke.write_synthetic_euroc(root, n_frames=4)
    seq = load_sequence(root)
    times, f0, f1 = synchronize_stereo(seq)
    assert len(times) == 4 and len(seq.gt.t) == 4
    np.testing.assert_allclose(np.diff(times), 0.05, atol=1e-6)
    np.testing.assert_allclose(np.median(np.diff(seq.imu.t)), 0.005, atol=1e-6)
    imgs = load_images(f1)
    assert imgs.shape == (4, 480, 752)
    np.testing.assert_array_equal(imgs[2], read_gray8(f1[2]).astype(np.float32))
    chip_smoke.log_png_decode(root)
    assert "native runtime" in capsys.readouterr().out
