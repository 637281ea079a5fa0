"""Multi-process (multi-host tier) execution: jax.distributed across 2 OS
processes x 2 virtual CPU devices, gloo collectives.

The per-lane VIO outputs must be BIT-identical to the single-process
sharded run on a same-shape mesh (lane math never crosses a device, so a
process boundary must not change a bit); the distributed-BA pose system is
assembled by a cross-process psum whose reduction order may differ, so BA
equality is machine-precision.

The module self-isolates into a subprocess (tests/_isolation.py): the
parent compiles a whole-pipeline shard_map program for the reference run.
"""
import sys

import numpy as np

from _isolation import isolate_module

_IN_CHILD, _child_only, test_multiproc_module_in_subprocess = isolate_module(
    __file__, "MSCKF_MULTIPROC_CHILD"
)


def _check(results):
    for rc, out in results:
        assert rc == 0, f"worker failed (rc={rc}):\n{out[-4000:]}"
        assert "MULTIPROC_OK" in out, out[-4000:]


@_child_only
def test_multiproc_vio_bit_equality(tmp_path):
    import jax

    from msckf_stereo_c.parallel.multiproc import (
        launch_workers,
        run_vio_reference,
    )
    from msckf_stereo_c.parallel.multiseq import make_mesh

    assert len(jax.devices()) >= 4
    # Same mesh SHAPE as the 2-process x 2-device global mesh.
    ref = run_vio_reference(make_mesh(4))
    assert int(ref["after_ransac"].min()) > 10  # the reference scene tracks
    path = tmp_path / "vio_ref.npz"
    np.savez(path, **ref)

    _check(launch_workers("vio", num_processes=2, devices_per_process=2,
                          ref_path=str(path)))


@_child_only
def test_multiproc_distributed_ba(tmp_path):
    from msckf_stereo_c.parallel.multiproc import (
        launch_workers,
        run_ba_reference,
    )
    from msckf_stereo_c.parallel.multiseq import make_mesh

    ref = run_ba_reference(make_mesh(4, axis="map"))
    assert ref["costs"][-1] < 1e-3 * ref["costs"][0]
    path = tmp_path / "ba_ref.npz"
    np.savez(path, **ref)

    _check(launch_workers("ba", num_processes=2, devices_per_process=2,
                          ref_path=str(path)))
