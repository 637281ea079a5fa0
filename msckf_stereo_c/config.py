"""Configuration system.

Frozen dataclasses mirroring the reference's three YAML config files
(/root/reference/config/{app_imgproc.yaml, app_msckfvio.yaml,
camchain-imucam-euroc.yaml}; loaded at image_processor.cpp:75,
msckf_vio.cpp:59, system.cpp:13).  Defaults equal the reference's EuRoC
values so a config-less construction reproduces the reference setup.

Being frozen dataclasses of Python scalars/tuples, configs are hashable and
can be passed as static arguments to jitted functions; array-valued
calibration (intrinsics, extrinsics) is materialized on demand via the
``*_array`` helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Vec3 = Tuple[float, float, float]
Vec4 = Tuple[float, float, float, float]
Mat4 = Tuple[float, ...]  # 16 row-major entries

# The values jax.default_matmul_precision accepts, plus "default" (= leave
# the platform fast path in place).  Validated at config construction so a
# typo fails with a clear error instead of an opaque trace-time failure on
# the first frame.
VALID_MATMUL_PRECISIONS = (
    "default",
    "bfloat16",
    "bfloat16_3x",
    "tensorfloat32",
    "float32",
    "highest",
)


def _check_matmul_precision(value: str) -> None:
    if value not in VALID_MATMUL_PRECISIONS:
        raise ValueError(
            f"matmul_precision={value!r} is not one of {VALID_MATMUL_PRECISIONS}"
        )


def matmul_precision_scope(precision: str):
    """Context manager scoping jax matmul precision; no-op for "default".

    Single home for the if-default-else branching previously duplicated at
    the vio_step / frontend_step call sites."""
    import contextlib

    import jax

    if precision == "default":
        return contextlib.nullcontext()
    return jax.default_matmul_precision(precision)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Mirror of app_imgproc.yaml (reference image_processor.h:75-88)."""

    grid_row: int = 4
    grid_col: int = 5
    grid_min_feature_num: int = 3
    grid_max_feature_num: int = 4
    pyramid_levels: int = 4  # reference hardcodes 4 (image_processor.cpp:232)
    patch_size: int = 15
    # Reference value is 10 on RAW pixels (app_imgproc.yaml); with the
    # presmooth prefilter (below) the blur scales small-feature contrast
    # by ~0.7, so the default compensates to 7 (>= 8 sigma of the
    # post-filter noise floor).  Measured on the 36 s realism gate:
    # threshold 10 + presmooth loses all tracks in the texture-poor +
    # vignette window (min_tracks 0); 7 keeps 9+ and ATE 0.0479 m.
    fast_threshold: int = 7
    max_iteration: int = 30
    track_precision: float = 0.01
    ransac_threshold: float = 3.0
    stereo_threshold: float = 5.0
    # Fixed-shape additions: static capacity of the feature track pool.
    # grid_row*grid_col*grid_max_feature_num = 80 live tracks max; the pool
    # is padded for alignment and new-candidate staging.
    max_features: int = 96
    # Per-cell candidate budget for the FAST detector's occupancy grid
    # (vikit CornerDetector(30, 47, thr): ~16 px cells for 752x480).
    detector_cell: int = 16
    # KLT implementation: "corr" (correlation surfaces; the LK loop is a
    # Triton kernel on the GPU), "gemm" (matmul-resampling), or "gather"
    # (reference bilinear-gather path).  All three are semantically
    # equivalent (tested); "corr" is the production path.
    klt_impl: str = "corr"
    # Lens models (static for jit; set from the camchain by the drivers).
    distortion_model0: str = "radtan"
    distortion_model1: str = "radtan"
    # Temporal 2-pt RANSAC (reference ships the solver with its call sites
    # commented out, image_processor.cpp:482-493 — default off for parity).
    ransac_enabled: bool = False
    # Pyramid levels searched by the temporal (prev->curr) KLT.  The
    # reference always uses all 4, but with IMU-seeded guesses the coarse
    # levels are redundant AND harmful: their wide search windows alias
    # onto neighboring features in dense scenes (measured: fast-motion
    # synthetic ATE 0.167 m with 4 levels vs 0.116 with 2 vs 0.101 with 1 —
    # and 1 keeps more tracks; smooth-motion bench ATE 0.0059 with 1 vs
    # 0.0066 with 2).  Deliberate deviation from the reference.
    temporal_levels: int = 1
    # Pyramid levels searched by the stereo (cam0->cam1) KLT for SURVIVING
    # tracks (candidates always walk the full pyramid from the extrinsic
    # guess).  Survivors carry their previous disparity, which moves ~1 px
    # per frame at EuRoC speeds — inside the full-res search radius, so 1
    # level suffices (measured: 948 vs 898 fps; synthetic bench ATE 0.0066
    # vs 0.0037 m, both ~20x under the 0.13 m gate; fast-motion gates pass).
    # Set 2 to restore the previous two-level refinement.
    stereo_levels: int = 1
    # Reuse the merged stereo call's interpolated template patches as the
    # next frame's temporal-KLT templates (same image, same positions —
    # bit-identical, tested).  Effective only with klt_impl='corr' and
    # temporal_levels == stereo_levels == 1; skips one patch-extraction
    # kernel per frame.
    tmpl_carry: bool = True
    # Cap the per-frame new-feature candidate set (the sieve keeps the
    # per-grid top grid_max_feature_num; the budget then keeps the most
    # NEEDED candidates — those whose within-grid rank is below the grid's
    # estimated vacancy, then by response).  Candidates ride 3 KLT level
    # calls, so lanes beyond steady-state refill demand (~10-15/frame) are
    # pure cost.  48 deliberately undershoots the 60-candidate first-frame
    # demand (20 grids x 3): 12 grids start one feature short and refill on
    # frame two — measured ATE/fast-motion gates unchanged, +55 fps.
    # 0 disables the cap.
    cand_budget: int = 48
    # Sensor-noise prefilter: run the full-resolution tracking/detection
    # level through a 5-tap binomial blur (ops/pyramid.py:smooth5).  Under
    # realistic per-pixel sensor noise (read sigma 2.5 DN + shot 0.06*I),
    # raw-pixel central-difference gradients make FAST birth spurious
    # corners (~1800 extra non-landmark tracks on the 36 s stress probe)
    # and hold a persistent ~+0.05 px tracking bias; the prefilter cuts
    # pixel noise ~3.7x with an unbiased symmetric kernel.  The reference
    # detects/tracks on raw pixels (image_processor.cpp:213-245) — its
    # real-camera inputs carry exactly this noise.  Coarse pyramid levels
    # keep the exact OpenCV pyrDown chain.  Measured (36 s stress gate):
    # noise-only 0.135 -> 0.0479 m with all realism channels on; the
    # round-3 clean-channel scene is unchanged (0.0433 vs 0.0436).
    # Pairs with the compensated fast_threshold default above.
    presmooth: bool = True
    # Candidate coarse walk: whether candidates refine their extrinsic
    # guess at pyramid level 1 between the coarse (3,2) walk and the
    # full-resolution pass.  False is faster and holds the bench-scene ATE
    # but was MEASURED UNSAFE at long horizon (before the GPU port; see
    # PERF.md): the 130 s stress gate degrades 0.036 -> 0.117 m without it — the
    # level-2 guess (~4 px full-res error) lands inside the full-res
    # search radius but close enough to neighboring-blob basins that
    # candidate locks are born subtly wrong under the stress scene's
    # feature density.  Default stays True; the knob remains for
    # benign-scene throughput runs (BENCH_CAND_LEVEL1=0).
    cand_level1: bool = True
    # Left-right stereo consistency check (round-trip px threshold; 0
    # disables).  The epipolar gate cannot reject a wrong lock ALONG the
    # epipolar line, and with carried-disparity stereo matching such a lock
    # persists for the track's whole life: measured on the 36 s circle/wall
    # scene, ~2% of observations carried ~-10 px disparity errors, all from
    # tracks BORN on the wrong blob (scripts/track_bias_probe.py,
    # docs/STRESS_NOTES.md).  Tracking cam1->cam0 back at full resolution
    # and requiring the round trip to land within this radius kills them at
    # birth.  The reference has no equivalent (it re-walks the full pyramid
    # from the extrinsic guess every frame, image_processor.cpp:534-620, so
    # its wrong locks do not persist); this is this build's counterpart
    # safeguard for its cheaper carried-disparity design.
    stereo_lr_threshold: float = 1.0
    # Scope of the LR check.  True (default): the full survivor+candidate
    # union, every frame.  False narrows the backward KLT to candidate
    # lanes only (~1/3 of the union) on the theory that wrong locks are
    # only BORN at candidate matching — MEASURED FALSE at long horizon
    # (before the GPU port; see PERF.md): the 130 s stress gate degrades
    # 0.036 -> 0.257 m (bar 0.13) without the survivor round trip, i.e.
    # survivors' carried disparity DOES get corrupted mid-life under the
    # occluder sweep / texture-dropout windows, and the per-frame survivor
    # LR check is what catches it.  The knob remains for benign-scene
    # throughput runs only.
    stereo_lr_survivors: bool = True
    # Translation-aware temporal prediction: back-project each track by its
    # last stereo depth, displace by the filter's velocity estimate over the
    # frame interval, reproject through the full lens model (and pre-scale
    # the carried stereo disparity by the predicted depth change).  The
    # reference predicts rotation only (predictFeatureTracking,
    # image_processor.cpp:321-350) and absorbs translation flow with its
    # 4-level pyramid; with temporal_levels=1 the translation flow
    # (fx*v*dt/Z, ~17 px at 3.6 m and 2.7 m/s) must be predicted instead —
    # measured on the 36 s stress/wall-8 scene: ATE 0.59 m (9% scale error,
    # +/-7 deg yaw wander) -> 0.030 m with this on.  Applies only when the
    # driver supplies the filter velocity (models/vio.py); standalone
    # frontend calls without cam_vel always use the rotation-only warp.
    translation_seed: bool = True
    # Anchor-template refinement: after the frame-to-frame temporal KLT,
    # re-align each track against its BIRTH template (stored once at
    # allocation) and accept the correction when it converges within
    # anchor_radius px.  Frame-to-frame LK re-anchors its template at the
    # tracked sub-pixel position every frame, so sub-pixel localization
    # bias ACCUMULATES along a track's life (measured on the stress scene:
    # mean vertical residual vs ground truth drifts +0.02 -> -0.61 px by
    # age 15-25, which integrates into a z-position drift of ~-2 mm/s —
    # the camera v-axis is world-aligned at every orbit azimuth, so
    # vertical drift never cancels).  Anchoring bounds the drift by one
    # alignment bias.  The reference has no equivalent (same accumulation
    # exists there).  Active only with the corr/tmpl-carry configuration.
    anchor_refine: bool = True
    anchor_radius: float = 2.0
    # Photometric normalization of the correlation-surface LK (klt_impl=
    # 'corr' only).  'none' = raw brightness constancy (the reference's LK,
    # vikit optical_flow_multi_level).  'zeromean' subtracts template and
    # patch means (folds into the correlation surfaces — offset-invariant;
    # exposure offset drift and vignette gradients stop biasing the solve).
    # 'gain' additionally re-estimates a per-iteration photometric gain
    # from one extra correlation surface (affine-photometric LK): the
    # displacement estimate is exactly unbiased under patch = a*templ + b —
    # the anchor-refinement and low-SNR-window bias mechanism identified in
    # 'mixed' = 'gain' for the anchor alignment only, the damped joint
    # translation+offset solve ('offset') elsewhere.  'anchor_gain' keeps
    # the frame-to-frame solves on the raw reference-faithful path —
    # BIT-identical to 'none' — and applies the affine solve ONLY to the
    # anchor alignment.  The default stays 'none': the FULL 130 s
    # 5-seed protocol rejected every normalized mode (docs/STRESS_NOTES.md
    # round 5) — gain everywhere worst 0.150 (the per-iteration gain
    # d.o.f. consumes residual SNR in low-texture windows), zeromean
    # freezes on DC-gradient ramps, damped-offset 'mixed' DIVERGED on one
    # seed draw, and even anchor-only gain lost on a noise-dominated seed
    # (0.1437 vs 0.1029: the gain is estimated from the NOISY current
    # patch no matter how clean the template is).  The knobs remain for
    # exposure-drift-dominated deployments, where 'gain' measured 2x
    # better on the drift-heavy seed.
    klt_norm: str = "none"
    # Matmul precision of the front-end image GEMMs and convolutions
    # (pyramids, corr surfaces, resampling).  "default" leaves the
    # platform's choice; "tensorfloat32" is one TF32 tensor-core pass on the
    # GPU; "float32" is exact f32 off the tensor cores.  The filter has its
    # own knob (FilterConfig.matmul_precision).  Default tensorfloat32:
    # measured on the H100 (PERF.md), float32 holds the same 130 s stress
    # ATE (0.0830 vs 0.0835 m) but costs 41 % of the bench's frames/s.
    matmul_precision: str = "tensorfloat32"

    def __post_init__(self):
        _check_matmul_precision(self.matmul_precision)
        if self.klt_norm not in (
            "none", "zeromean", "offset", "gain", "mixed", "anchor_gain"
        ):
            raise ValueError(
                f"klt_norm={self.klt_norm!r} is not one of "
                "('none', 'zeromean', 'offset', 'gain', 'mixed', 'anchor_gain')"
            )
        if self.klt_norm != "none" and self.klt_impl != "corr":
            raise ValueError(
                f"klt_norm={self.klt_norm!r} requires klt_impl='corr' "
                f"(got {self.klt_impl!r})"
            )

    @property
    def num_grids(self) -> int:
        return self.grid_row * self.grid_col


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Mirror of app_msckfvio.yaml (reference msckf_vio.cpp:58-112)."""

    frame_rate: float = 20.0
    max_cam_state_size: int = 20
    position_std_threshold: float = 8.0
    rotation_threshold: float = 0.2618
    translation_threshold: float = 0.4
    tracking_rate_threshold: float = 0.5
    feature_translation_threshold: float = -1.0
    # Standard deviations; squared into variances on use (msckf_vio.cpp:77-81).
    noise_gyro: float = 0.005
    noise_acc: float = 0.05
    noise_gyro_bias: float = 0.001
    noise_acc_bias: float = 0.01
    noise_feature: float = 0.035
    initial_velocity: Vec3 = (0.0, 0.0, 0.0)
    initial_cov_velocity: float = 0.25
    initial_cov_gyro_bias: float = 0.01
    initial_cov_acc_bias: float = 0.01
    initial_cov_extrinsic_rotation: float = 3.0462e-4
    initial_cov_extrinsic_translation: float = 2.5e-5
    # Static capacities (replace dynamic std::map state).  The
    # reference's 1500-row stacked-Jacobian cap (msckf_vio.cpp:1009) has no
    # analog here: information accumulation is O(D^2) regardless of rows.
    max_tracks: int = 128  # feature map_server pool size
    max_imu_per_frame: int = 16  # IMU slots per frame batch (EuRoC: ~10)
    imu_init_samples: int = 200  # gravity/bias init window (msckf_vio.cpp:196)
    # Update-candidate budget per phase: tracks finishing in one frame are
    # few (~10-20); gating/update tensors are compacted to this many slots
    # (the fixed-shape analog of the reference's 1500-row cap, msckf_vio.cpp:1009 —
    # overflow candidates are dropped from the update, not from the map).
    max_update_tracks: int = 32
    # Linear-solver implementation for gating + the schur EKF update.
    # 0 = exact factorizations (Cholesky), the default on every platform:
    # on the H100 it lands on the CPU f64 stress ATE (0.0772 vs 0.0785 m)
    # where Newton-Schulz gives 0.0830 (PERF.md).  >0 = scaled Newton-
    # Schulz inverse with that many iterations — pure batched matmuls, no
    # sequential column loops (each iteration quadruples the spectral
    # floor); 10 covers conditioning ~3e4 where the max observed
    # c/min_eig on stressed runs is ~3e2.
    ns_iters: int = 0
    # SNR-adaptive observation noise (no reference equivalent — the
    # reference's observation_noise is one static scalar, msckf_vio.cpp:44).
    # When on, each track's measurement noise VARIANCE is inflated by
    # clip(noise_snr_ref / q, 1, noise_inflation_cap), where q is the
    # track's mean frontend-published template min-eig (FrameOutput.quality;
    # the CRLB of KLT localization scales as sigma_px^2 ~ sigma_noise^2 /
    # min_eig).  Weak-texture tracks — exactly the low-SNR-window population
    # whose noise^2/signal^2 sub-pixel bias drives long-horizon drift
    # (docs/STRESS_NOTES.md round 4) — are downweighted instead of entering
    # the EKF at full weight.  Implemented as sqrt-weight scaling of the
    # per-track Jacobian blocks, exactly equivalent to per-track R = c*I;
    # tracks with unknown quality (non-corr frontends) keep the base noise.
    noise_adaptive: bool = False
    noise_snr_ref: float = 40.0
    noise_inflation_cap: float = 16.0
    # Matmul precision of all filter-side matmuls.  "float32" (exact f32,
    # the default): on the H100 a "tensorfloat32" filter diverges on the
    # 130 s stress seed (PERF.md), and reduced-precision passes make the
    # ATE depend on how XLA tiles the batch (models/msckf.py:filter_step).
    matmul_precision: str = "float32"

    def __post_init__(self):
        _check_matmul_precision(self.matmul_precision)

    @property
    def gyro_noise_var(self) -> float:
        return self.noise_gyro**2

    @property
    def acc_noise_var(self) -> float:
        return self.noise_acc**2

    @property
    def gyro_bias_noise_var(self) -> float:
        return self.noise_gyro_bias**2

    @property
    def acc_bias_noise_var(self) -> float:
        return self.noise_acc_bias**2

    @property
    def observation_noise_var(self) -> float:
        return self.noise_feature**2

    @property
    def state_dim(self) -> int:
        """Error-state dimension: 21 IMU + 6 per cam slot (all preallocated)."""
        return 21 + 6 * self.max_cam_state_size


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """One camera's Kalibr entry (camchain-imucam yaml)."""

    intrinsics: Vec4  # fx, fy, cx, cy
    distortion_model: str  # "radtan" | "equidistant"
    distortion_coeffs: Vec4
    resolution: Tuple[int, int]  # (width, height)
    T_cam_imu: Mat4  # row-major 4x4; transforms IMU-frame points to cam frame

    def K(self) -> np.ndarray:
        fx, fy, cx, cy = self.intrinsics
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)

    def T_cam_imu_mat(self) -> np.ndarray:
        return np.asarray(self.T_cam_imu, dtype=np.float64).reshape(4, 4)


@dataclasses.dataclass(frozen=True)
class StereoCalib:
    """Full Kalibr camchain: two cameras + stereo + body extrinsics."""

    cam0: CameraCalib
    cam1: CameraCalib
    T_cn_cnm1: Mat4  # cam0 -> cam1 transform (points): p_c1 = T * p_c0
    T_imu_body: Mat4

    def T_cam0_cam1_mat(self) -> np.ndarray:
        """p_c1 = R p_c0 + t (reference CAMState::T_cam0_cam1)."""
        return np.asarray(self.T_cn_cnm1, dtype=np.float64).reshape(4, 4)

    # Derived extrinsics in the conventions used by the engine.
    def R_imu_cam0(self) -> np.ndarray:
        """Rotation IMU->cam0 of *vectors*: R_i_c = R(T_cam_imu)."""
        return self.cam0.T_cam_imu_mat()[:3, :3]

    def t_cam0_imu(self) -> np.ndarray:
        """cam0 position in IMU frame: t = -R(T_cam_imu)^T t(T_cam_imu)."""
        T = self.cam0.T_cam_imu_mat()
        return -T[:3, :3].T @ T[:3, 3]


# EuRoC defaults (camchain-imucam-euroc.yaml).
_EUROC_CAM0 = CameraCalib(
    intrinsics=(458.654, 457.296, 367.215, 248.375),
    distortion_model="radtan",
    distortion_coeffs=(-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05),
    resolution=(752, 480),
    T_cam_imu=(
        0.014865542981794, 0.999557249008346, -0.025774436697440, 0.065222909535531,
        -0.999880929698575, 0.014967213324719, 0.003756188357967, -0.020706385492719,
        0.004140296794224, 0.025715529947966, 0.999660727177902, -0.008054602460030,
        0.0, 0.0, 0.0, 1.0,
    ),
)
_EUROC_CAM1 = CameraCalib(
    intrinsics=(457.587, 456.134, 379.999, 255.238),
    distortion_model="radtan",
    distortion_coeffs=(-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05),
    resolution=(752, 480),
    T_cam_imu=(
        0.012555267089103, 0.999598781151433, -0.025389800891747, -0.044901980682509,
        -0.999755099723116, 0.013011905181504, 0.017900583825251, -0.020569771258915,
        0.018223771455443, 0.025158836311552, 0.999517347077547, -0.008638135126028,
        0.0, 0.0, 0.0, 1.0,
    ),
)
_EUROC_T_CN = (
    0.999997256477881, 0.002312067192424, 0.000376008102415, -0.110073808127187,
    -0.002317135723281, 0.999898048506644, 0.014089835846648, 0.000399121547014,
    -0.000343393120525, -0.014090668452714, 0.999900662637729, -0.000853702503357,
    0.0, 0.0, 0.0, 1.0,
)
_IDENTITY4 = (
    1.0, 0.0, 0.0, 0.0,
    0.0, 1.0, 0.0, 0.0,
    0.0, 0.0, 1.0, 0.0,
    0.0, 0.0, 0.0, 1.0,
)

EUROC_CALIB = StereoCalib(cam0=_EUROC_CAM0, cam1=_EUROC_CAM1, T_cn_cnm1=_EUROC_T_CN, T_imu_body=_IDENTITY4)


def _yaml():
    """PyYAML, imported on use: only the config-file loaders need it."""
    import yaml

    return yaml


def _mat4_from_yaml(node) -> Mat4:
    flat = np.asarray(node, dtype=np.float64).reshape(-1)
    if flat.size != 16:
        raise ValueError(f"expected 16-element matrix, got {flat.size}")
    return tuple(float(v) for v in flat)


def load_camchain(path: str) -> StereoCalib:
    """Parse a Kalibr-style camchain YAML (reference config_io.h decoders)."""
    with open(path) as f:
        node = _yaml().safe_load(f)

    def cam(key: str) -> CameraCalib:
        c = node[key]
        return CameraCalib(
            intrinsics=tuple(float(v) for v in c["intrinsics"]),
            distortion_model=str(c["distortion_model"]),
            distortion_coeffs=tuple(float(v) for v in c["distortion_coeffs"]),
            resolution=tuple(int(v) for v in c["resolution"]),
            T_cam_imu=_mat4_from_yaml(c["T_cam_imu"]),
        )

    return StereoCalib(
        cam0=cam("cam0"),
        cam1=cam("cam1"),
        T_cn_cnm1=_mat4_from_yaml(node["cam1"]["T_cn_cnm1"]),
        T_imu_body=_mat4_from_yaml(node.get("T_imu_body", list(_IDENTITY4))),
    )


def load_frontend_config(path: str) -> FrontendConfig:
    with open(path) as f:
        node = _yaml().safe_load(f)
    base = FrontendConfig()
    # The presmooth prefilter and the FAST threshold are coupled: the blur
    # scales small-feature contrast ~0.7x, so presmooth=True pairs with the
    # compensated threshold 7 while the reference's raw-pixel threshold 10
    # pairs with presmooth=False (threshold 10 + presmooth was measured to
    # lose ALL tracks in texture-poor+vignette windows — docs/STRESS_NOTES.md
    # round 4).  A YAML that pins the reference's fast_threshold >= 10
    # without taking a position on presmooth gets the raw-pixel pairing it
    # implicitly asked for.
    if "presmooth" not in node and int(node.get("fast_threshold", 0)) >= 10:
        import warnings

        warnings.warn(
            f"{path}: fast_threshold={node['fast_threshold']} without an "
            "explicit 'presmooth' key — defaulting presmooth to false (the "
            "raw-pixel pairing). Set 'presmooth: true' with a lower "
            "threshold (e.g. 7) for the sensor-noise prefilter.",
            stacklevel=2,
        )
        base = dataclasses.replace(base, presmooth=False)
    return dataclasses.replace(
        base,
        matmul_precision=str(node.get("matmul_precision", base.matmul_precision)),
        grid_row=int(node.get("grid_row", base.grid_row)),
        grid_col=int(node.get("grid_col", base.grid_col)),
        grid_min_feature_num=int(node.get("grid_min_feature_num", base.grid_min_feature_num)),
        grid_max_feature_num=int(node.get("grid_max_feature_num", base.grid_max_feature_num)),
        patch_size=int(node.get("patch_size", base.patch_size)),
        fast_threshold=int(node.get("fast_threshold", base.fast_threshold)),
        max_iteration=int(node.get("max_iteration", base.max_iteration)),
        track_precision=float(node.get("track_precision", base.track_precision)),
        ransac_threshold=float(node.get("ransac_threshold", base.ransac_threshold)),
        stereo_threshold=float(node.get("stereo_threshold", base.stereo_threshold)),
        klt_impl=str(node.get("klt_impl", base.klt_impl)),
        klt_norm=str(node.get("klt_norm", base.klt_norm)),
        temporal_levels=int(node.get("temporal_levels", base.temporal_levels)),
        stereo_levels=int(node.get("stereo_levels", base.stereo_levels)),
        tmpl_carry=bool(node.get("tmpl_carry", base.tmpl_carry)),
        cand_budget=int(node.get("cand_budget", base.cand_budget)),
        ransac_enabled=bool(node.get("ransac_enabled", base.ransac_enabled)),
        stereo_lr_threshold=float(
            node.get("stereo_lr_threshold", base.stereo_lr_threshold)
        ),
        presmooth=bool(node.get("presmooth", base.presmooth)),
        cand_level1=bool(node.get("cand_level1", base.cand_level1)),
        stereo_lr_survivors=bool(
            node.get("stereo_lr_survivors", base.stereo_lr_survivors)
        ),
        anchor_refine=bool(node.get("anchor_refine", base.anchor_refine)),
        translation_seed=bool(node.get("translation_seed", base.translation_seed)),
    )


def load_filter_config(path: str, base: FilterConfig | None = None) -> FilterConfig:
    with open(path) as f:
        node = _yaml().safe_load(f)
    base = base if base is not None else FilterConfig()
    return dataclasses.replace(
        base,
        frame_rate=float(node.get("frame_rate", base.frame_rate)),
        max_cam_state_size=int(node.get("max_cam_state_size", base.max_cam_state_size)),
        position_std_threshold=float(node.get("position_std_threshold", base.position_std_threshold)),
        rotation_threshold=float(node.get("rotation_threshold", base.rotation_threshold)),
        translation_threshold=float(node.get("translation_threshold", base.translation_threshold)),
        tracking_rate_threshold=float(node.get("tracking_rate_threshold", base.tracking_rate_threshold)),
        feature_translation_threshold=float(
            node.get("feature/config/translation_threshold", base.feature_translation_threshold)
        ),
        noise_gyro=float(node.get("noise/gyro", base.noise_gyro)),
        noise_acc=float(node.get("noise/acc", base.noise_acc)),
        noise_gyro_bias=float(node.get("noise/gyro_bias", base.noise_gyro_bias)),
        noise_acc_bias=float(node.get("noise/acc_bias", base.noise_acc_bias)),
        noise_feature=float(node.get("noise/feature", base.noise_feature)),
        initial_velocity=tuple(float(v) for v in node.get("initial_state/velocity", base.initial_velocity)),
        initial_cov_velocity=float(node.get("initial_covariance/velocity", base.initial_cov_velocity)),
        initial_cov_gyro_bias=float(node.get("initial_covariance/gyro_bias", base.initial_cov_gyro_bias)),
        initial_cov_acc_bias=float(node.get("initial_covariance/acc_bias", base.initial_cov_acc_bias)),
        initial_cov_extrinsic_rotation=float(
            node.get("initial_covariance/extrinsic_rotation_cov", base.initial_cov_extrinsic_rotation)
        ),
        initial_cov_extrinsic_translation=float(
            node.get("initial_covariance/extrinsic_translation_cov", base.initial_cov_extrinsic_translation)
        ),
        ns_iters=int(node.get("ns_iters", base.ns_iters)),
        max_update_tracks=int(node.get("max_update_tracks", base.max_update_tracks)),
        matmul_precision=str(node.get("matmul_precision", base.matmul_precision)),
        noise_adaptive=bool(node.get("noise_adaptive", base.noise_adaptive)),
        noise_snr_ref=float(node.get("noise_snr_ref", base.noise_snr_ref)),
        noise_inflation_cap=float(
            node.get("noise_inflation_cap", base.noise_inflation_cap)
        ),
    )
