"""Device-side stereo renderer: the JAX twin of ``sim/render.py``.

The numpy renderer costs ~0.8 s per stereo pair on this host — fine for
20-frame unit tests, prohibitive for the V1_01-length (>=120 s, >=2400
frame) stress gates.  This renderer runs the same raycast (procedural
texture on a finite cylinder + caps, full radtan lens model, Gaussian
landmark blobs) as a jitted, vmappable JAX program, so long sequences
render on the device in seconds and feed the pipeline without a host
round-trip.

It additionally implements the stress channels the V1_01-realistic gate
needs (VERDICT round 1, "what's missing" #1):

* per-frame texture/blob gain (texture-poor intervals -> feature dropout),
* per-frame global brightness gain/offset (exposure drift),
* a world-space sphere occluder (geometrically consistent between the two
  cameras — tracks crossing it genuinely die),

and the photometric realism channels (VERDICT round 3, next #4 — the
residual gap between blobs-on-texture and real V1_01 imagery):

* per-pixel sensor noise: read noise (constant sigma) + shot noise
  (variance proportional to intensity), drawn per frame per camera,
* motion blur from the TRUE trajectory during the exposure window: the
  frame is the average of renders at poses sampled across the exposure
  (K=3 taps at +/- one trajectory step, ~10 ms) — blur magnitude therefore
  scales with the true angular/linear rates, exactly like a real shutter,
* vignetting: radial intensity falloff toward the corners (static lens
  property).

Equivalence with the numpy renderer on the un-stressed channels is tested
in tests/test_render_jax.py."""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EUROC_CALIB, StereoCalib
from .render import _Texture, _ray_lut
from .trajectory import SimTrajectory


def _interp_pose_taps(
    traj: SimTrajectory, frame_indices: np.ndarray, offsets: np.ndarray, n_traj: int
):
    """(T, K, 3, 3), (T, K, 3) poses at fractional trajectory offsets:
    positions linearly interpolated, rotations geodesically (so3 log/exp
    between the bracketing samples) — host-side numpy via the jnp lie ops
    on stacked arrays."""
    import jax

    from ..utils.lie import so3_exp, so3_log

    T = len(frame_indices)
    K = len(offsets)
    idx = frame_indices[:, None] + offsets[None, :]  # (T, K) fractional
    idx = np.clip(idx, 0.0, n_traj - 1.0)
    lo = np.floor(idx).astype(np.int64)
    hi = np.minimum(lo + 1, n_traj - 1)
    a = (idx - lo).astype(np.float64)  # (T, K)

    p = (1.0 - a[..., None]) * traj.p[lo] + a[..., None] * traj.p[hi]
    R_lo = traj.R_w_b[lo].reshape(-1, 3, 3)  # (T*K, 3, 3)
    R_hi = traj.R_w_b[hi].reshape(-1, 3, 3)

    # R(t) = R_lo @ exp(t * log(R_lo^T R_hi)); vectorized with jnp.
    # HIGHEST precision: any renderer-side geometry matmul left at a
    # reduced-precision f32 default (bf16 or TF32 passes) silently warps
    # the rendered imagery — a phantom accuracy gap between devices (see
    # _raycast).  This ran at default precision at first and doubled the
    # 130 s realism gate's ATE on an accelerator against the CPU.
    import jax.numpy as jnp

    with jax.default_matmul_precision("highest"):
        Rl = jnp.asarray(R_lo)
        Rh = jnp.asarray(R_hi)
        dR = jnp.einsum(
            "nji,njk->nik", Rl, Rh, precision=jax.lax.Precision.HIGHEST
        )  # R_lo^T R_hi
        phi = jax.vmap(so3_log)(dR)  # (T*K, 3)
        Rt = jnp.einsum(
            "nij,njk->nik",
            Rl,
            jax.vmap(so3_exp)(phi * jnp.asarray(a.reshape(-1))[:, None]),
            precision=jax.lax.Precision.HIGHEST,
        )
    return np.asarray(Rt).reshape(T, K, 3, 3), p


@dataclasses.dataclass
class StressEvents:
    """Per-frame stress schedule (all arrays (T,) unless noted).

    The photometric channels (None = off, keeping the channel out of the
    compiled program entirely): ``noise_read``/``noise_shot`` per-pixel
    sensor noise, ``blur`` exposure fraction for the 3-tap motion blur,
    ``vignette`` corner falloff fraction."""

    tex_scale: np.ndarray  # texture AC amplitude multiplier (1 = nominal)
    blob_scale: np.ndarray  # landmark blob amplitude multiplier
    gain: np.ndarray  # global brightness gain
    offset: np.ndarray  # global brightness offset (intensity units)
    occ_pos: np.ndarray  # (T, 3) occluder sphere center in world
    occ_radius: np.ndarray  # occluder radius in meters (0 = off)
    noise_read: Optional[np.ndarray] = None  # (T,) read-noise sigma (DN)
    noise_shot: Optional[np.ndarray] = None  # (T,) shot gain: var = shot * I
    blur: Optional[np.ndarray] = None  # (T,) exposure fraction in [0, 1]
    vignette: Optional[np.ndarray] = None  # (T,) corner falloff in [0, 1]
    noise_seed: int = 0
    noise_frame0: int = 0  # absolute index of frame 0 (set by .slice)

    @staticmethod
    def nominal(T: int) -> "StressEvents":
        return StressEvents(
            tex_scale=np.ones(T),
            blob_scale=np.ones(T),
            gain=np.ones(T),
            offset=np.zeros(T),
            occ_pos=np.zeros((T, 3)),
            occ_radius=np.zeros(T),
        )

    def slice(self, s0: int, s1: int) -> "StressEvents":
        """Frame-range slice (chunked rendering), None-aware."""

        def cut(x):
            return None if x is None else x[s0:s1]

        return StressEvents(
            tex_scale=self.tex_scale[s0:s1],
            blob_scale=self.blob_scale[s0:s1],
            gain=self.gain[s0:s1],
            offset=self.offset[s0:s1],
            occ_pos=self.occ_pos[s0:s1],
            occ_radius=self.occ_radius[s0:s1],
            noise_read=cut(self.noise_read),
            noise_shot=cut(self.noise_shot),
            blur=cut(self.blur),
            vignette=cut(self.vignette),
            # Per-frame noise keys are derived from the ABSOLUTE frame
            # index, so chunked and one-shot renders draw identical noise.
            noise_seed=self.noise_seed,
            noise_frame0=self.noise_frame0 + s0,
        )


def make_stress_events(
    traj: SimTrajectory,
    frame_indices: np.ndarray,
    orbit_angle: Optional[np.ndarray] = None,
    occ_orbit_radius: float = 5.5,
    occ_max_radius: float = 0.8,
    # Photometric realism channels — ON by default since the tracker's
    # noise prefilter landed (FrontendConfig.presmooth).  History: with the
    # raw-pixel tracker the 36 s gate measured 0.0436 m with the round-3
    # channels, 0.135 with sensor noise alone and 0.258 with
    # noise+vignette; with the prefilter + compensated FAST threshold the
    # all-channels gate measures 0.0479 m (docs/STRESS_NOTES.md round 4).
    sensor_noise: bool = True,
    # Noise spec calibrated to a V1_01-class capture (MT9V034, good indoor
    # lighting): sigma_total ~2.3 DN at mid-gray (~33 dB SNR).  The
    # initial harsher spec (2.5 / 0.06, sigma ~3.4 DN — a dark-sequence
    # gain level) is kept measured in docs/STRESS_NOTES.md: 130 s CPU
    # gate 0.123 m vs 0.085 m at this spec; STRESS_NOISE_READ/SHOT
    # override per run.
    noise_read_dn: float = 1.5,
    noise_shot_gain: float = 0.04,
    motion_blur: bool = True,
    vignette: float = 0.35,
    noise_seed: int = 0,
    # Depth of the texture-poor windows (fraction of texture/blob contrast
    # removed).  The historical 0.85/0.65 pairs with the Vicon-room
    # trajectory, whose angular-speed near-stalls coincide with the
    # windows; the fast-motion family (3+ m/s sprints through the same
    # schedule) uses a milder dip — an 85% texture kill DURING a sprint is
    # a guaranteed total outage for any tracker (measured: min_tracks 0,
    # 0.173 m) and no real benchmark couples the two.
    tex_poor_depth: float = 0.85,
    blob_poor_depth: float = 0.65,
) -> StressEvents:
    """The standard stress schedule, windowed by normalized sequence time:

    * [0.22, 0.36] and [0.58, 0.72]: texture-poor (texture AC -> 0.15,
      blob amplitude -> 0.35) — the KLT loses its background anchors and
      FAST loses most candidates;
    * [0.42, 0.56]: an occluder sphere (0.8 m, sized for the 7 m room —
      a person-scale obstruction) parked in front of the wall at the
      azimuth the camera sweeps mid-window — tracks die crossing it;
    * whole run: slow sinusoidal exposure drift (gain 1 +/- 0.25, offset
      +/- 12 intensity units) plus a linear darkening trend;
    * whole run (round 4, VERDICT #4): per-pixel sensor noise (read sigma
      ~1.5 DN + shot variance 0.04*I -> sigma ~2.6 DN at the 120 DN blob
      peaks; V1_01-calibrated defaults — see the parameter comment above),
      full-exposure motion blur (the 3-tap true-trajectory average
      — ~4-9 px of smear at the scene's 1-2 rad/s peak rates), and 35 %
      corner vignetting.
    """
    t = traj.t[frame_indices]
    u = (t - t[0]) / max(t[-1] - t[0], 1e-9)
    T = len(t)

    def window(lo, hi, ramp=0.02):
        # Smooth 0->1->0 window over normalized time.
        up = np.clip((u - lo) / ramp, 0.0, 1.0)
        dn = np.clip((hi - u) / ramp, 0.0, 1.0)
        return np.minimum(up, dn)

    poor = np.maximum(window(0.22, 0.36), window(0.58, 0.72))
    tex_scale = 1.0 - tex_poor_depth * poor
    blob_scale = 1.0 - blob_poor_depth * poor

    gain = 1.0 + 0.25 * np.sin(2 * np.pi * u * 3.1) - 0.1 * u
    offset = 12.0 * np.sin(2 * np.pi * u * 1.7 + 1.0)

    occ_w = window(0.42, 0.56, ramp=0.04)
    if orbit_angle is None:
        # Camera azimuth proxy: angle of the body position on its orbit.
        orbit_angle = np.arctan2(traj.p[frame_indices, 1], traj.p[frame_indices, 0])
    mid = int(np.clip(np.searchsorted(u, 0.49), 0, T - 1))
    az = float(orbit_angle[mid])
    occ_pos = np.tile(
        np.array([occ_orbit_radius * np.cos(az), occ_orbit_radius * np.sin(az), 0.3]),
        (T, 1),
    )
    occ_radius = occ_max_radius * occ_w
    return StressEvents(
        tex_scale=tex_scale,
        blob_scale=blob_scale,
        gain=gain,
        offset=offset,
        occ_pos=occ_pos,
        occ_radius=occ_radius,
        noise_read=np.full(T, noise_read_dn) if sensor_noise else None,
        noise_shot=np.full(T, noise_shot_gain) if sensor_noise else None,
        blur=np.ones(T) if motion_blur else None,
        vignette=np.full(T, vignette) if vignette > 0 else None,
        noise_seed=noise_seed,
    )


class JaxRenderer:
    """Precompute the scene constants once; render frames on device.

    Cites the same reference-world geometry as sim/render.py (wall cylinder
    + caps + blob landmarks); all per-frame math is jnp and jit/vmap-able."""

    def __init__(
        self,
        landmarks: np.ndarray,
        calib: StereoCalib = EUROC_CALIB,
        min_depth: float = 0.3,
        blob_radius: int = 4,
        seed: int = 5,
        r_wall: float = 12.0,
        z_cap: float = 8.0,
        dtype=jnp.float32,
        blur_taps: Tuple[float, ...] = (-0.5, 0.0, 0.5),
    ):
        rng = np.random.default_rng(seed)
        W, H = calib.cam0.resolution
        self.H, self.W = H, W
        self.r_wall = r_wall
        self.z_cap = z_cap
        self.min_depth = min_depth
        self.blob_radius = blob_radius
        self.blur_taps = tuple(blur_taps)
        self.dtype = dtype

        L = landmarks.shape[0]
        # Same draw order/shapes as render.render_stereo_sequence.
        self.amp = jnp.asarray(rng.uniform(60.0, 140.0, L), dtype)
        self.sx = jnp.asarray(rng.uniform(1.1, 1.8, L), dtype)
        self.sy = jnp.asarray(rng.uniform(1.1, 1.8, L), dtype)
        self.landmarks = jnp.asarray(landmarks, dtype)

        tex = _Texture(seed)
        self.tex_fa = jnp.asarray(tex.fa, dtype)
        self.tex_fz = jnp.asarray(tex.fz, dtype)
        self.tex_pa = jnp.asarray(tex.pa, dtype)
        self.tex_pz = jnp.asarray(tex.pz, dtype)
        self.tex_amp = jnp.asarray(tex.amp, dtype)

        T_ci0 = calib.cam0.T_cam_imu_mat()
        T01 = calib.T_cam0_cam1_mat()
        T_ci1 = T01 @ T_ci0
        self.cams = []
        self.vig_maps = []
        for T_ci, cam in ((T_ci0, calib.cam0), (T_ci1, calib.cam1)):
            rays = _ray_lut(cam.intrinsics, cam.distortion_coeffs, W, H)
            self.cams.append(
                dict(
                    R_ci=jnp.asarray(T_ci[:3, :3], dtype),
                    t_ci=jnp.asarray(T_ci[:3, 3], dtype),
                    rays=jnp.asarray(rays, dtype),
                    intr=jnp.asarray(cam.intrinsics, dtype),
                    dist=jnp.asarray(cam.distortion_coeffs, dtype),
                )
            )
            # Vignetting falloff map: normalized squared radius from the
            # principal point (1.0 at the farthest corner); a ``vignette``
            # value of v scales the corner intensity by (1 - v).
            cx, cy = cam.intrinsics[2], cam.intrinsics[3]
            uu, vv = np.meshgrid(np.arange(W) - cx, np.arange(H) - cy)
            r2 = uu * uu + vv * vv
            corners = [
                (0 - cx) ** 2 + (0 - cy) ** 2,
                (W - 1 - cx) ** 2 + (0 - cy) ** 2,
                (0 - cx) ** 2 + (H - 1 - cy) ** 2,
                (W - 1 - cx) ** 2 + (H - 1 - cy) ** 2,
            ]
            self.vig_maps.append(jnp.asarray(r2 / max(corners), dtype))

    # ---- per-frame pieces -------------------------------------------------

    def _texture(self, theta, z, tex_scale):
        out = jnp.full(theta.shape, 70.0, self.dtype)
        # (n,) coefficient arrays against (...,) angle fields.
        ang_a = theta[..., None] * self.tex_fa + self.tex_pa
        ang_z = z[..., None] * self.tex_fz + self.tex_pz
        ac = jnp.sum(self.tex_amp * jnp.sin(ang_a) * jnp.sin(ang_z), axis=-1)
        return out + tex_scale * ac

    def _raycast(self, R_c_w, o_w, rays, tex_scale):
        # HIGHEST precision: an accelerator's default f32 matmul may use
        # bf16 or TF32 passes, which would warp the rendered geometry by
        # ~px at the image edges —
        # the harness must be exact regardless of platform defaults.
        d = jnp.matmul(
            rays.reshape(-1, 3), R_c_w.T, precision=jax.lax.Precision.HIGHEST
        )
        o = o_w[None, :]
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = 2.0 * (o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1])
        c = o[:, 0] ** 2 + o[:, 1] ** 2 - self.r_wall**2
        disc = jnp.maximum(b * b - 4 * a * c, 0.0)
        t_cyl = (-b + jnp.sqrt(disc)) / jnp.maximum(2 * a, 1e-12)

        dz = jnp.where(jnp.abs(d[:, 2]) > 1e-9, d[:, 2], 1e-9)
        t_top = (self.z_cap - o[:, 2]) / dz
        t_bot = (-self.z_cap - o[:, 2]) / dz

        p_cyl_z = o[:, 2] + t_cyl * d[:, 2]
        use_cyl = (jnp.abs(p_cyl_z) <= self.z_cap) & (t_cyl > 0)
        t_cap = jnp.where(d[:, 2] > 0, t_top, t_bot)
        t = jnp.where(use_cyl, t_cyl, jnp.maximum(t_cap, 0.1))

        p = o + t[:, None] * d
        theta = jnp.arctan2(p[:, 1], p[:, 0])
        zc = jnp.where(
            use_cyl,
            p[:, 2],
            jnp.hypot(p[:, 0], p[:, 1]) * jnp.sign(p[:, 2]) * 0.6,
        )
        img = self._texture(theta, zc, tex_scale).reshape(self.H, self.W)
        return img, d.reshape(self.H, self.W, 3), t.reshape(self.H, self.W)

    def _project(self, p_cam, intr, dist):
        fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
        k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
        z = jnp.where(p_cam[:, 2] != 0, p_cam[:, 2], 1.0)
        x = p_cam[:, 0] / z
        y = p_cam[:, 1] / z
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return jnp.stack([xd * fx + cx, yd * fy + cy], axis=1)

    def _render_one_cam(self, cam, R_wb, p_b, p_imu, ev):
        R_ci, t_ci = cam["R_ci"], cam["t_ci"]
        R_w_c = R_ci @ R_wb
        R_c_w = R_w_c.T
        o_w = p_b + R_wb.T @ (-R_ci.T @ t_ci)

        img, d_w, t_bg = self._raycast(R_c_w, o_w, cam["rays"], ev["tex_scale"])

        # Landmark blobs.
        p_c = jnp.matmul(p_imu, R_ci.T, precision=jax.lax.Precision.HIGHEST) + t_ci
        vis = p_c[:, 2] > self.min_depth
        uv = self._project(jnp.where(vis[:, None], p_c, 1.0), cam["intr"], cam["dist"])
        r = self.blob_radius
        vis &= (uv[:, 0] > r + 3) & (uv[:, 0] < self.W - r - 4)
        vis &= (uv[:, 1] > r + 3) & (uv[:, 1] < self.H - r - 4)

        cx_i = jnp.round(uv[:, 0]).astype(jnp.int32)
        cy_i = jnp.round(uv[:, 1]).astype(jnp.int32)
        gy, gx = jnp.mgrid[-r : r + 1, -r : r + 1]
        gy, gx = gy.astype(jnp.int32), gx.astype(jnp.int32)
        du = gx[None].astype(self.dtype) + (cx_i.astype(self.dtype) - uv[:, 0])[:, None, None]
        dv = gy[None].astype(self.dtype) + (cy_i.astype(self.dtype) - uv[:, 1])[:, None, None]
        blob = (
            ev["blob_scale"]
            * self.amp[:, None, None]
            * jnp.exp(
                -0.5
                * (
                    (du / self.sx[:, None, None]) ** 2
                    + (dv / self.sy[:, None, None]) ** 2
                )
            )
        )
        blob = jnp.where(vis[:, None, None], blob, 0.0)
        iy = cy_i[:, None, None] + gy[None]
        ix = cx_i[:, None, None] + gx[None]
        # Clip instead of drop: invisible landmarks carry zero weight, and
        # visible ones are >= r+3 px inside the border by construction.
        iy = jnp.clip(iy, 0, self.H - 1)
        ix = jnp.clip(ix, 0, self.W - 1)
        img = img.at[iy, ix].add(blob)

        # World-space sphere occluder: flat-shaded, geometrically consistent
        # between the cameras; drawn over background and blobs (it sits in
        # front of the wall).
        oc = ev["occ_pos"] - o_w
        t_close = d_w @ oc  # rays are unit-norm
        dist2 = jnp.sum(oc * oc) - t_close * t_close
        hit = (
            (ev["occ_radius"] > 0)
            & (t_close > self.min_depth)
            & (dist2 < ev["occ_radius"] ** 2)
            & (t_close < t_bg)
        )
        return jnp.where(hit, 42.0, img)

    def _render_pair(self, R_wb, p_b, ev):
        """Pre-photometric (geometry-only) images for both cameras."""
        p_imu = jnp.matmul(
            self.landmarks - p_b, R_wb.T, precision=jax.lax.Precision.HIGHEST
        )
        return (
            self._render_one_cam(self.cams[0], R_wb, p_b, p_imu, ev),
            self._render_one_cam(self.cams[1], R_wb, p_b, p_imu, ev),
        )

    def _finalize(self, img, ev, cam_idx: int):
        """Photometric chain: vignette -> exposure gain/offset -> sensor
        noise -> quantization range clip.  Optional channels are skipped
        statically when their event entries are absent."""
        v = ev.get("vignette")
        if v is not None:
            img = img * (1.0 - v * self.vig_maps[cam_idx])
        img = ev["gain"] * img + ev["offset"]
        nr = ev.get("noise_read")
        if nr is not None:
            key = jax.random.fold_in(ev["noise_key"], cam_idx)
            sigma = jnp.sqrt(
                nr * nr + ev["noise_shot"] * jnp.maximum(img, 0.0)
            )
            img = img + sigma * jax.random.normal(key, img.shape, self.dtype)
        return jnp.clip(img, 0.0, 255.0)

    def render_frame(self, R_wb, p_b, ev):
        """(3,3), (3,), per-frame event dict -> (img0, img1)."""
        img0, img1 = self._render_pair(R_wb, p_b, ev)
        return self._finalize(img0, ev, 0), self._finalize(img1, ev, 1)

    @partial(jax.jit, static_argnums=0)
    def render_frames(self, R_taps, p_taps, ev_arrays):
        """Batched render: R_taps (T, K, 3, 3), p_taps (T, K, 3) exposure
        taps per frame (K=1 without motion blur), ``ev_arrays`` a dict of
        per-frame channel arrays -> ((T,H,W), (T,H,W)).

        With blur, the frame is (1-b) * center tap + b * mean(taps): b = 1
        is a full-exposure 3-tap shutter whose smear magnitude comes from
        the true pose change across the taps."""

        def one(R_k, p_k, ev):
            K = R_k.shape[0]
            i0s, i1s = jax.vmap(lambda R, p: self._render_pair(R, p, ev))(R_k, p_k)
            b = ev.get("blur")
            if b is None or K == 1:
                i0, i1 = i0s[K // 2], i1s[K // 2]
            else:
                i0 = (1.0 - b) * i0s[K // 2] + b * jnp.mean(i0s, axis=0)
                i1 = (1.0 - b) * i1s[K // 2] + b * jnp.mean(i1s, axis=0)
            return self._finalize(i0, ev, 0), self._finalize(i1, ev, 1)

        return jax.vmap(one)(R_taps, p_taps, ev_arrays)

    def render_sequence(
        self,
        traj: SimTrajectory,
        frame_indices: np.ndarray,
        events: Optional[StressEvents] = None,
        chunk: int = 64,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host convenience: chunked device render -> host arrays."""
        T = len(frame_indices)
        ev = events or StressEvents.nominal(T)
        frame_indices = np.asarray(frame_indices)
        n_traj = traj.p.shape[0]
        if ev.blur is not None:
            # Exposure taps at fractional trajectory steps (default
            # +/- 0.5 step = a ~5 ms shutter at the 200 Hz trajectory
            # rate), pose-interpolated so the taps sit CLOSE enough
            # (<= ~2-4 px at the scene's peak rates) to integrate into a
            # smooth streak rather than discrete ghost images — the first
            # 3-tap +/-1-step variant produced 4-8 px ghost spacing and
            # KLT locked onto the ghosts (36 s probe ATE 0.26 m).
            # The smear magnitude still comes from the TRUE pose change
            # over the exposure.
            offsets = np.asarray(self.blur_taps)
            R_np, p_np = _interp_pose_taps(traj, frame_indices, offsets, n_traj)
        else:
            R_np = traj.R_w_b[frame_indices][:, None]  # (T, 1, 3, 3)
            p_np = traj.p[frame_indices][:, None]
        R = jnp.asarray(R_np, self.dtype)  # (T, K, 3, 3)
        p = jnp.asarray(p_np, self.dtype)  # (T, K, 3)

        ev_arrays = dict(
            tex_scale=jnp.asarray(ev.tex_scale, self.dtype),
            blob_scale=jnp.asarray(ev.blob_scale, self.dtype),
            gain=jnp.asarray(ev.gain, self.dtype),
            offset=jnp.asarray(ev.offset, self.dtype),
            occ_pos=jnp.asarray(ev.occ_pos, self.dtype),
            occ_radius=jnp.asarray(ev.occ_radius, self.dtype),
        )
        if ev.blur is not None:
            ev_arrays["blur"] = jnp.asarray(ev.blur, self.dtype)
        if ev.vignette is not None:
            ev_arrays["vignette"] = jnp.asarray(ev.vignette, self.dtype)
        if ev.noise_read is not None:
            ev_arrays["noise_read"] = jnp.asarray(ev.noise_read, self.dtype)
            ev_arrays["noise_shot"] = jnp.asarray(ev.noise_shot, self.dtype)
            base = jax.random.PRNGKey(ev.noise_seed)
            ev_arrays["noise_key"] = jax.vmap(
                lambda i: jax.random.fold_in(base, i)
            )(jnp.arange(ev.noise_frame0, ev.noise_frame0 + T))

        outs0, outs1 = [], []
        for s0 in range(0, T, chunk):
            s1 = min(s0 + chunk, T)
            i0, i1 = self.render_frames(
                R[s0:s1],
                p[s0:s1],
                {k: a[s0:s1] for k, a in ev_arrays.items()},
            )
            outs0.append(np.asarray(i0))
            outs1.append(np.asarray(i1))
        return np.concatenate(outs0), np.concatenate(outs1)
