#!/usr/bin/env python
"""A/B measurements behind the GPU defaults: the LK-iteration kernel, the
template interpolation, the matmul precisions and ``ns_iters``.

    python scripts/gpu_decisions.py [--base parent|final] [--variants ...]
        [--pairs 2] [--frames 100] [--batch 16] [--reps 3]
        [--stress-variants ...] [--stress-duration 130] [--skip-stress]
        [--skip-cpu] [--out chiprun_out/gpu_decisions.jsonl]

Throughput: the bench configuration (bench.py's sequence, B lanes x
``--frames`` frames, schur, f32 filter) at a base configuration — the
parent's bench defaults (frontend and filter at tensorfloat32,
ns_iters=10) or this tree's defaults — against one variant per decision,
timed in ``--pairs`` pairs of alternating order inside this one process,
with every lane's ATE.  Accuracy: seed 0 of the 130 s stress gate on the
GPU per stress variant, beside the CPU float64 'qr' filter on the same
seed (a JAX_PLATFORMS=cpu subprocess that runs while the GPU work does).
Every result is one JSON line in ``--out`` and on stdout, with the device
and the card's power limit.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


# The configuration each variant departs from: the parent's bench defaults
# (frontend and filter at tensorfloat32, Newton-Schulz solvers) or the
# defaults of this tree.
def _bases():
    from msckf_stereo_c.config import FilterConfig, FrontendConfig

    return {
        "parent": dict(fe="tensorfloat32", fi="tensorfloat32", ns=10),
        "final": dict(fe=FrontendConfig.matmul_precision,
                      fi=FilterConfig.matmul_precision, ns=FilterConfig.ns_iters),
    }


# Overrides of the base precision/solver fields per variant; "xla_loop" and
# "slice_template" swap code instead (see _variant_patches).
OVERRIDES = {
    "frontend_f32": dict(fe="float32"),
    "filter_f32": dict(fi="float32"),
    "all_f32": dict(fe="float32", fi="float32"),
    "all_f32_ns0": dict(fe="float32", fi="float32", ns=0),
    "ns0": dict(ns=0),
    "ns10": dict(ns=10),
}


def _slice_template(img, pts, P):
    """The 4-slice bilinear template interpolation (the alternative to the
    tent-weight matmuls of ``klt_corr._interp_template``): exact f32
    elementwise work on a (P+3)-window."""
    import jax.numpy as jnp

    from msckf_stereo_c.ops.klt_corr import _extract_at_origins

    H, W = img.shape
    q, Tq = P + 2, P + 3
    torg = jnp.clip(jnp.floor(pts) - (P + 1) // 2, 0, jnp.array([W - Tq, H - Tq], img.dtype))
    t = _extract_at_origins(img, torg, Tq)
    a = jnp.clip(pts - (P + 1) / 2.0 - torg, 0.0, 1.0)
    ax, ay = a[:, 0][:, None, None], a[:, 1][:, None, None]
    return (t[:, :q, :q] * (1 - ax) * (1 - ay) + t[:, :q, 1:] * ax * (1 - ay)
            + t[:, 1:, :q] * (1 - ax) * ay + t[:, 1:, 1:] * ax * ay)


def _variant_patches(name):
    """(module, attribute, replacement) patches active while a variant traces."""
    from msckf_stereo_c.ops import klt_corr as kc

    if name == "xla_loop":
        return [(kc, "_resolve_loop", lambda loop: "xla" if loop is None else loop)]
    if name == "slice_template":
        return [(kc, "_interp_template", _slice_template)]
    return []


def _configs(base, name):
    from msckf_stereo_c.config import FilterConfig, FrontendConfig

    c = {**_bases()[base], **OVERRIDES.get(name, {})}
    return (FrontendConfig(temporal_levels=1, matmul_precision=c["fe"]),
            FilterConfig(ns_iters=c["ns"], matmul_precision=c["fi"]))


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def throughput(args, out, card):
    import jax

    import bench

    data = bench.bench_data(args.frames)
    runs = {}
    for name in ["base"] + args.variants:
        fe, fi = _configs(args.base, name)
        saved = []
        for mod, attr, new in _variant_patches(name):
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, new)
        try:
            run, run_args = bench.build_batched_run(fe, fi, "schur", args.batch, data)
            t0 = time.time()
            jax.block_until_ready(run(*run_args)[1][0].p)  # trace + compile here
            compile_s = time.time() - t0
        finally:
            for mod, attr, old in saved:
                setattr(mod, attr, old)
        _, pose = bench.time_run(run, run_args, 1)
        ates = bench.lane_ates(pose, data)
        runs[name] = (run, run_args)
        _emit(out, {"kind": "compile", "base": args.base, "variant": name,
                    "compile_s": compile_s,
                    "ate_lane0_m": ates[0], "ate_worst_lane_m": max(ates), **card})
    fps = lambda dt: args.batch * args.frames / dt  # noqa: E731
    for name in args.variants:
        # Pairs in alternating order: (base, variant), (variant, base), ...
        order = [n for i in range(args.pairs)
                 for n in (("base", name) if i % 2 == 0 else (name, "base"))]
        times = {n: [] for n in ("base", name)}
        for n in order:
            dt, _ = bench.time_run(*runs[n], args.reps)
            times[n].append(dt)
        _emit(out, {"kind": "ab", "base": args.base, "variant": name, "order": order,
                    "base_fps": [fps(t) for t in times["base"]],
                    "variant_fps": [fps(t) for t in times[name]],
                    "batch": args.batch, "frames": args.frames, **card})


def _stress(base, name, duration, platform):
    import jax.numpy as jnp

    from msckf_stereo_c.sim.stress import run_stress_gate

    fe, fi = _configs(base, name)
    f64 = platform == "cpu"
    if f64:
        fi = dataclasses.replace(fi, ns_iters=0, matmul_precision="float32")
    t0 = time.time()
    # chunk 289 divides the 2601 frames of 130 s: one compiled program.
    res = run_stress_gate(
        duration=duration, chunk=289, fcfg=fe, mcfg=fi, seed=0, lm_seed=1,
        filter_dtype=jnp.float64 if f64 else jnp.float32,
        method="qr" if f64 else "schur",
    )
    return {"kind": "stress", "base": base, "variant": "cpu_f64_qr" if f64 else name,
            "seed": 0, "duration_s": duration, "ate_rmse_m": res.ate_rmse,
            "ate_max_m": res.ate_max,
            "min_tracks_after_ransac": int(res.min_tracks_after_ransac),
            "wall_s": time.time() - t0}


def kernel_tiles(out, card, tiles, reps=50):
    """Time the LK kernel alone per (rows, num_warps) tile at B=16 x 96
    features, on the surfaces of the chip_smoke kernels phase."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    from msckf_stereo_c.ops import klt_corr as kc

    prev, curr = (jnp.asarray(x, jnp.float32) for x in chip_smoke._frame_pair())
    rng = np.random.default_rng(0)
    B, N, P, iters, eps = 16, 96, 15, 30, 0.01
    pts = jnp.asarray(np.stack([rng.uniform(30, 720, B * N), rng.uniform(30, 450, B * N)], -1),
                      jnp.float32)
    guess = pts + jnp.asarray(rng.uniform(-1.5, 1.5, (B * N, 2)), jnp.float32)
    S = P + 2 * kc._SEARCH_RADIUS + 2
    H, W = curr.shape
    tq = kc._template_quantities(kc._interp_template(prev, pts, P), P)
    sorg = jnp.clip(jnp.floor(guess) - S // 2, 0, jnp.array([W - S, H - S], jnp.float32))
    Cx, Cy = kc._corr_surfaces(kc._extract_at_origins(curr, sorg, S), tq.gx, tq.gy, P)
    f0 = guess - (P - 1) / 2.0 - sorg
    K = Cx.shape[-1]
    G = tq.G
    det = G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] ** 2
    z = jnp.zeros_like(det)
    sc = jnp.stack([G[:, 1, 1] / det, -G[:, 0, 1] / det, z, -G[:, 0, 1] / det,
                    G[:, 0, 0] / det, z, tq.tgx, tq.tgy, z, f0[:, 0], f0[:, 1],
                    (~tq.good).astype(jnp.float32)])
    cs = (Cx.reshape(-1, K * K), Cy.reshape(-1, K * K))
    ref = None
    for rows, warps in tiles:
        kc._BLOCK_ROWS, kc._NUM_WARPS = rows, warps
        kc._iterate_fn.cache_clear()
        run = jax.jit(kc._iterate_fn(K, iters, eps, float(S - P - 1), 2, False))
        got = np.asarray(run(sc, *cs))
        ref = got if ref is None else ref
        t0 = time.perf_counter()
        for _ in range(reps):
            r = run(sc, *cs)
        jax.block_until_ready(r)
        _emit(out, {"kind": "tile", "rows": rows, "num_warps": warps, "features": B * N,
                    "ms_per_call": (time.perf_counter() - t0) / reps * 1e3,
                    "max_dev_px": float(np.abs(got - ref).max()), **card})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "gpu_decisions.jsonl"))
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--base", default="parent", choices=["parent", "final"])
    ap.add_argument("--variants", nargs="*", default=[
        "xla_loop", "slice_template", "frontend_f32", "filter_f32", "ns0"])
    ap.add_argument("--stress-variants", nargs="*", default=[
        "base", "frontend_f32", "filter_f32", "all_f32", "all_f32_ns0"])
    ap.add_argument("--stress-duration", type=float, default=130.0)
    ap.add_argument("--skip-stress", action="store_true")
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--tiles", action="store_true",
                    help="only time the LK kernel per (rows, num_warps) tile")
    ap.add_argument("--cpu-f64-stress", action="store_true",
                    help="(child process) the CPU float64 'qr' stress reference")
    args = ap.parse_args()

    import jax

    from msckf_stereo_c.device import select_platform, setup_compile_cache

    setup_compile_cache()
    if args.cpu_f64_stress:
        select_platform("cpu")
        jax.config.update("jax_enable_x64", True)
        print(json.dumps(_stress("final", "base", args.stress_duration, "cpu")), flush=True)
        return

    select_platform("gpu")
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = {"device": dev.device_kind, "platform": dev.platform, "nvidia_smi": smi}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    child = None
    with open(args.out, "a") as out:
        if args.tiles:
            kernel_tiles(out, card, [(8, 4), (16, 4), (16, 8), (32, 8), (32, 16), (64, 16)])
            return
        if not (args.skip_stress or args.skip_cpu):
            env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cpu-f64-stress",
                 "--stress-duration", str(args.stress_duration)],
                env=env, stdout=subprocess.PIPE, text=True,
            )
        try:
            throughput(args, out, card)
            if not args.skip_stress:
                for name in args.stress_variants:
                    _emit(out, {**_stress(args.base, name, args.stress_duration, "gpu"),
                                **card})
            if child is not None:
                lines = child.communicate()[0].strip().splitlines()
                rec = json.loads(lines[-1]) if child.returncode == 0 and lines else {
                    "kind": "stress", "variant": "cpu_f64_qr", "error": child.returncode}
                _emit(out, rec)
        finally:
            if child is not None and child.poll() is None:
                child.kill()
                child.wait()


if __name__ == "__main__":
    main()
