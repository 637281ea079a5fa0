"""Pyramidal Lucas–Kanade via precomputed correlation surfaces.

The GEMM formulation (``klt_gemm.py``) resamples the search patch every LK
iteration with batched ``(N,P,S)@(N,S,S)@(N,S,P)`` einsums — per-feature
matrices too small to keep a matrix unit busy, repeated every iteration.

Key identity: the LK right-hand side is *linear* in the sampled patch,

    b_x(f) = sum_ij (templ - patch(f))_ij * gx_ij
           = sum templ*gx  -  sum_ij gx_ij * bilinear(search, f + (i,j))

and bilinear sampling is itself linear in the search-patch pixels with
weights supported on integer shifts.  Therefore

    b_x(f) = tgx - bilinear_interp(Cx, f),
    Cx[u, v] = sum_ij gx[i, j] * search[u + i, v + j]

with Cx a one-time (K, K) cross-correlation of the (fixed, inverse-
compositional) template gradient with the search patch, K = S - P + 1.
The same holds for b_y with Cy.  This is *exact* (up to fp reassociation):
the entire iteration loop reduces to tent-weight construction + masked
reductions over (N, K, K) arrays — elementwise work, no per-feature
matmuls, no data-dependent memory access.

The correlation surfaces are computed once per level as a depthwise
convolution (features = channels, 2 filters per channel: gx and gy).

The iteration loop runs as a Pallas kernel through Triton on a GPU (one
launch per call, per-block early exit on the device) and as an XLA
``while_loop`` elsewhere — the CPU path and the kernel's reference.

Semantics match ``klt_gemm.py`` step for step (same clamped window walk,
same convergence test, same validity rules); equivalence is asserted in
tests.  Replaces vikit's ``optical_flow_multi_level``
(image_processor.cpp:410,569) like the other two implementations.
"""
from __future__ import annotations

import functools as _functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from .klt import KltResult, _MIN_EIG_THRESHOLD
from .klt_gemm import _SEARCH_RADIUS, _extract_patches, _sample, _tent_weights
from .linalg import solve2x2

# Where the LK iteration loop runs: "triton" (the Pallas kernel, compiled
# for the GPU), "interpret" (the same kernel on the Pallas interpreter —
# CPU tests) or "xla" (the while_loop reference).  ``None`` picks the
# backend's own: the kernel on a GPU, the while_loop elsewhere.
LOOP_IMPLS = ("triton", "interpret", "xla")

# Kernel tiling: features per program x the K*K surface padded to a power
# of two; two such f32 tiles (Cx, Cy) stay in registers for the whole loop.
_BLOCK_ROWS = 16
_NUM_WARPS = 8


def _resolve_loop(loop: str | None) -> str:
    if loop is None:
        return "triton" if jax.default_backend() == "gpu" else "xla"
    if loop not in LOOP_IMPLS:
        raise ValueError(f"loop={loop!r} is not one of {LOOP_IMPLS}")
    return loop


def _corr_surfaces(spatch: jnp.ndarray, gx: jnp.ndarray, gy: jnp.ndarray, P: int,
                   extra=()):
    """(N, K, K) cross-correlations of gx/gy (+ optional extra per-feature
    filters) with each search patch.

    Depthwise conv: each feature is a channel, with F filters per channel
    ((gx, gy) + extras).  Returns a tuple of F surfaces.
    """
    N, S, _ = spatch.shape
    filters = (gx, gy) + tuple(extra)
    F = len(filters)
    lhs = spatch[None]  # (1, N, S, S)  NCHW
    rhs = jnp.stack(filters, axis=1).reshape(F * N, 1, P, P)  # OIHW
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        feature_group_count=N,
        preferred_element_type=spatch.dtype,
    )  # (1, FN, K, K)
    K = S - P + 1
    out = out.reshape(N, F, K, K)
    if F == 2:
        return out[:, 0], out[:, 1]
    return tuple(out[:, i] for i in range(F))


def _iter_kernel(K: int, iters: int, eps: float, hi: float, nsurf: int):
    """One program runs the whole LK loop for a block of features and exits
    as soon as every lane of ITS block has converged (converged lanes are
    frozen, so a per-block exit equals the batch-wide one).

    ``sc`` rows: the 2x3 displacement rows B of the (bordered) normal-matrix
    inverse, the template correlations t0..t2, the start f0 and the
    converged flag.  ``nsurf`` = 3 adds the photometric surface (gain and
    offset modes); with 2 surfaces the third column of B is unused.

    Padding safety: for columns uv >= K*K, U = uv // K >= K > hi + 1, so
    the tent weight is exactly zero (and the padded surfaces are zero)."""

    def kernel(sc_ref, *refs):
        c_refs, out_ref = refs[:nsurf], refs[nsurf]
        f32 = jnp.float32
        uv = jax.lax.broadcasted_iota(jnp.int32, (1, c_refs[0].shape[1]), 1)
        U = (uv // K).astype(f32)
        V = (uv % K).astype(f32)
        b00, b01, b02, b10, b11, b12, t0, t1, t2, f0x, f0y, conv0 = (
            sc_ref[j, :] for j in range(12)
        )
        cs = [c[...] for c in c_refs]

        def cond(carry):
            _, _, conv, it = carry
            return (it < iters) & (jnp.min(conv) < 0.5)

        def body(carry):
            fx, fy, conv, it = carry
            fxs = jnp.clip(fx, 0.0, hi)[:, None]
            fys = jnp.clip(fy, 0.0, hi)[:, None]
            w2 = jnp.maximum(0.0, 1.0 - jnp.abs(U - fys)) * jnp.maximum(
                0.0, 1.0 - jnp.abs(V - fxs)
            )
            bx = t0 - jnp.sum(w2 * cs[0], axis=1)
            by = t1 - jnp.sum(w2 * cs[1], axis=1)
            dx = b00 * bx + b01 * by
            dy = b10 * bx + b11 * by
            if nsurf == 3:
                bt = t2 - jnp.sum(w2 * cs[2], axis=1)
                dx = dx + b02 * bt
                dy = dy + b12 * bt
            nfx = jnp.clip(fx + dx, 0.0, hi)
            nfy = jnp.clip(fy + dy, 0.0, hi)
            now = (jnp.sqrt(dx * dx + dy * dy) < eps).astype(f32)
            frozen = conv > 0.5
            fx = jnp.where(frozen, fx, nfx)
            fy = jnp.where(frozen, fy, nfy)
            return (fx, fy, jnp.maximum(conv, now), it + 1)

        fx, fy, _, _ = jax.lax.while_loop(
            cond, body, (f0x, f0y, conv0, jnp.zeros((), jnp.int32))
        )
        out_ref[0, :] = fx
        out_ref[1, :] = fy

    return kernel


@_functools.lru_cache(maxsize=None)
def _iterate_fn(K: int, iters: int, eps: float, hi: float, nsurf: int,
                interpret: bool):
    """Returns run(sc (12, N), *surfaces (N, K*K)) -> f (N, 2).

    ``custom_vmap`` folds any outer batch into the feature axis, so a
    (B, N) problem is one launch over B*N/rows programs."""
    KKp = pl.next_power_of_2(K * K)
    rows = _BLOCK_ROWS

    @jax.custom_batching.custom_vmap
    def run(sc, *cs):
        N = sc.shape[1]
        Np = -(-N // rows) * rows
        if Np != N:
            # Padded lanes start converged, so they never hold a block open.
            pad = jnp.zeros((12, Np - N), sc.dtype).at[11].set(1.0)
            sc = jnp.concatenate([sc, pad], axis=1)
        cs = [jnp.pad(c, ((0, Np - N), (0, KKp - K * K))) for c in cs]
        out = pl.pallas_call(
            _iter_kernel(K, iters, eps, hi, nsurf),
            grid=(Np // rows,),
            out_shape=jax.ShapeDtypeStruct((2, Np), sc.dtype),
            in_specs=[pl.BlockSpec((16, rows), lambda i: (0, i))]
            + [pl.BlockSpec((rows, KKp), lambda i: (i, 0))] * nsurf,
            out_specs=pl.BlockSpec((2, rows), lambda i: (0, i)),
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=_NUM_WARPS, num_stages=1
            ),
            interpret=interpret,
            name="klt_lk_iterate",
        )(jnp.pad(sc, ((0, 4), (0, 0))), *cs)
        return out[:, :N].T

    @run.def_vmap
    def _rule(axis_size, in_batched, sc, *cs):
        sc_b, *cs_b = in_batched
        if not sc_b:
            sc = jnp.broadcast_to(sc[None], (axis_size,) + sc.shape)
        sc = jnp.moveaxis(sc, 0, 1).reshape(12, -1)
        flat = []
        for x, b in zip(cs, cs_b):
            if not b:
                x = jnp.broadcast_to(x[None], (axis_size,) + x.shape)
            flat.append(x.reshape((-1,) + x.shape[2:]))
        out = run(sc, *flat)
        return out.reshape(axis_size, -1, 2), True

    return run


def _iterate_kernel(Cx, Cy, Ct, tq, f0, conv0, iters, eps, hi, interpret):
    """Run the LK iterations as one kernel launch.  Returns f (N, 2)."""
    N, K, _ = Cx.shape
    zero = jnp.zeros_like(tq.tgx)
    if Ct is not None:
        B = tq.Binv
        rows = [B[:, 0, 0], B[:, 0, 1], B[:, 0, 2], B[:, 1, 0], B[:, 1, 1],
                B[:, 1, 2], tq.tgx, tq.tgy, tq.st2]
    else:
        G = tq.G
        det = G[:, 0, 0] * G[:, 1, 1] - G[:, 0, 1] * G[:, 0, 1]
        inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        rows = [G[:, 1, 1] * inv_det, -G[:, 0, 1] * inv_det, zero,
                -G[:, 0, 1] * inv_det, G[:, 0, 0] * inv_det, zero,
                tq.tgx, tq.tgy, zero]
    sc = jnp.stack(rows + [f0[:, 0], f0[:, 1], conv0.astype(Cx.dtype)])
    surfaces = [Cx, Cy] if Ct is None else [Cx, Cy, Ct]
    run = _iterate_fn(K, iters, float(eps), float(hi), len(surfaces), interpret)
    return run(sc, *(c.reshape(N, K * K) for c in surfaces))


class TemplateQ(NamedTuple):
    """Per-feature template quantities for one alignment problem.

    ``tgx``/``tgy`` are already adjusted for the photometric normalization
    (``norm``): raw template-gradient correlations for norm='none',
    zero-meaned for 'zeromean'/'gain'.  Fields beyond ``tgy`` are None
    except where the norm needs them."""

    gx: jnp.ndarray  # (N, P, P) template x-gradient
    gy: jnp.ndarray  # (N, P, P)
    G: jnp.ndarray  # (N, 2, 2) normal matrix
    good: jnp.ndarray  # (N,) min-eig quality gate
    min_eig: jnp.ndarray  # (N,) per-pixel min eigenvalue of G (SNR proxy)
    tgx: jnp.ndarray  # (N,)
    tgy: jnp.ndarray  # (N,)
    sgx: jnp.ndarray | None = None  # (N,) sum of gx (zeromean/gain)
    sgy: jnp.ndarray | None = None
    tmpl_c: jnp.ndarray | None = None  # (N, P, P) zero-meaned template (gain)
    st2: jnp.ndarray | None = None  # (N,) sum (T - mean T)^2 (gain)
    Binv: jnp.ndarray | None = None  # (N, 2, 3) displacement rows of the
    # bordered (translation + gain) normal-matrix inverse (gain)


def _template_quantities(sp: jnp.ndarray, P: int, norm: str = "none") -> TemplateQ:
    """Template gradients + normal matrix + quality from a (N, P+2, P+2)
    interpolated super-patch (shared by the temporal/stereo/anchor/backward
    alignment problems).  For norm='none' the expressions and order match
    the historical inline block bit for bit.

    norm='zeromean': the template correlation constants are computed on the
    zero-meaned template, pairing with the mean-corrected correlation
    surfaces of ``_surfaces_for_norm`` — the LK residual becomes invariant
    to a brightness OFFSET between template and search patch (exposure
    offset drift, vignetting gradients).

    norm='gain': additionally solves the affine-photometric LK — unknowns
    (dx, dy, dbeta) with the gain correction ``beta`` re-estimated each
    iteration from one extra correlation surface (the zero-meaned template
    itself as a filter).  Under patch = a*template + b the augmented system
    is solved exactly by (0, 0, 1-a): the displacement estimate is UNBIASED
    under any gain+offset mismatch (the mechanism behind the noise-locked
    anchor bias and the low-SNR window drift, docs/STRESS_NOTES.md round 4).
    A Tikhonov damp on the beta block keeps gradient-colinear (linear ramp)
    templates from confounding gain with translation."""
    templ = sp[:, 1:-1, 1:-1]
    gx = 0.5 * (sp[:, 1:-1, 2:] - sp[:, 1:-1, :-2])
    gy = 0.5 * (sp[:, 2:, 1:-1] - sp[:, :-2, 1:-1])
    gxx = jnp.sum(gx * gx, (-2, -1))
    gxy = jnp.sum(gx * gy, (-2, -1))
    gyy = jnp.sum(gy * gy, (-2, -1))
    G = jnp.stack(
        [jnp.stack([gxx, gxy], -1), jnp.stack([gxy, gyy], -1)], -2
    )  # (N, 2, 2)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    disc = jnp.sqrt(jnp.maximum(0.25 * tr * tr - det, 0.0))
    min_eig = (0.5 * tr - disc) / (P * P)
    good = min_eig > _MIN_EIG_THRESHOLD
    tgx = jnp.sum(templ * gx, (-2, -1))  # (N,)
    tgy = jnp.sum(templ * gy, (-2, -1))
    if norm == "none":
        return TemplateQ(gx=gx, gy=gy, G=G, good=good, min_eig=min_eig,
                         tgx=tgx, tgy=tgy)

    n = float(P * P)
    mt = jnp.mean(templ, (-2, -1))
    sgx = jnp.sum(gx, (-2, -1))
    sgy = jnp.sum(gy, (-2, -1))
    tgx_c = tgx - mt * sgx
    tgy_c = tgy - mt * sgy
    if norm == "zeromean":
        return TemplateQ(gx=gx, gy=gy, G=G, good=good, min_eig=min_eig,
                         tgx=tgx_c, tgy=tgy_c, sgx=sgx, sgy=sgy)
    if norm not in ("gain", "offset"):
        raise ValueError(f"unknown klt norm {norm!r}")

    if norm == "offset":
        # Damped joint (translation, brightness-offset) solve: the border
        # is the CONSTANT photometric Jacobian (ones), so the offset
        # unknown costs no SNR under noise (unlike the gain unknown, whose
        # Jacobian is the noisy template) yet absorbs exposure-offset
        # mismatch on textured patches.  On DC-gradient (ramp) patches the
        # offset is translation-confounded; the 5% damp then recovers
        # near-raw-LK behavior instead of the hard-zeromean freeze (a
        # centered-gradient solve has NO signal on ramps — measured as the
        # mixed-v1 seed-0 blowup, docs/STRESS_NOTES.md round 5).
        n_px = float(P * P)
        st_sum = jnp.sum(templ, (-2, -1))
        Binv = _bordered_inverse_rows(
            gxx, gxy, gyy, sgx, sgy, n_px * (1.0 + 0.05) * jnp.ones_like(sgx)
        )
        return TemplateQ(gx=gx, gy=gy, G=G, good=good, min_eig=min_eig,
                         tgx=tgx, tgy=tgy, sgx=sgx, sgy=sgy,
                         st2=st_sum, Binv=Binv)

    tmpl_c = templ - mt[:, None, None]
    st2 = jnp.sum(tmpl_c * tmpl_c, (-2, -1))
    # Bordered normal matrix A = [[G, h], [h^T, st2 + damp]] with
    # h = (tgx_c, tgy_c); its Schur complement st2 - h^T G^-1 h vanishes
    # when the template is a linear ramp (gain ~ translation confounded),
    # so the beta block carries a 5 % relative Tikhonov damp.
    a22 = st2 * 1.05 + 1e-12
    Binv = _bordered_inverse_rows(gxx, gxy, gyy, tgx_c, tgy_c, a22)
    return TemplateQ(gx=gx, gy=gy, G=G, good=good, min_eig=min_eig,
                     tgx=tgx_c, tgy=tgy_c, sgx=sgx, sgy=sgy,
                     tmpl_c=tmpl_c, st2=st2, Binv=Binv)


def _bordered_inverse_rows(gxx, gxy, gyy, hx, hy, a22):
    """(N, 2, 3) displacement rows of inv([[gxx, gxy, hx], [gxy, gyy, hy],
    [hx, hy, a22]]) via cofactors — the photometric-augmented GN solve."""
    detA = (
        gxx * (gyy * a22 - hy * hy)
        - gxy * (gxy * a22 - hy * hx)
        + hx * (gxy * hy - gyy * hx)
    )
    inv_detA = 1.0 / jnp.where(jnp.abs(detA) > 1e-30, detA, 1e-30)
    B00 = (gyy * a22 - hy * hy) * inv_detA
    B01 = (hx * hy - gxy * a22) * inv_detA
    B02 = (gxy * hy - gyy * hx) * inv_detA
    B11 = (gxx * a22 - hx * hx) * inv_detA
    B12 = (gxy * hx - gxx * hy) * inv_detA
    return jnp.stack(
        [jnp.stack([B00, B01, B02], -1), jnp.stack([B01, B11, B12], -1)], -2
    )


def _surfaces_for_norm(spatch: jnp.ndarray, tq: TemplateQ, P: int, norm: str):
    """Correlation surfaces for one alignment problem under ``norm``.

    Returns (Cx, Cy, Ct): the (mean-corrected, for zeromean/gain) gradient
    correlation surfaces, plus the template-correlation surface for 'gain'
    (None otherwise).  The zero-mean correction folds into the FILTERS by
    linearity: sum (gx - mean gx) * patch = sum gx*patch - (sum gx / n) *
    sum patch, i.e. mean-centered gradient filters compute the corrected
    surfaces directly — 'zeromean' costs exactly the same conv as 'none',
    and the template filter of 'gain' needs no correction at all (the
    zero-meaned template already sums to zero)."""
    if norm == "none":
        Cx, Cy = _corr_surfaces(spatch, tq.gx, tq.gy, P)
        return Cx, Cy, None
    if norm == "offset":
        # Raw gradient surfaces + the box-sum surface (the offset
        # residual's correlation: bo = sum T - interp(C1)).
        Cx, Cy, C1 = _corr_surfaces(
            spatch, tq.gx, tq.gy, P, extra=(jnp.ones_like(tq.gx),)
        )
        return Cx, Cy, C1
    n = float(P * P)
    gxc = tq.gx - (tq.sgx / n)[:, None, None]
    gyc = tq.gy - (tq.sgy / n)[:, None, None]
    if norm == "zeromean":
        Cx, Cy = _corr_surfaces(spatch, gxc, gyc, P)
        return Cx, Cy, None
    Cx, Cy, Ct = _corr_surfaces(spatch, gxc, gyc, P, extra=(tq.tmpl_c,))
    return Cx, Cy, Ct


def _run_iterations(Cx, Cy, Ct, tq, f0, conv0, iters, eps, S, P, loop):
    """LK iteration loop on precomputed correlation surfaces; returns the
    converged window-origin coordinates f (N, 2).  ``loop`` (resolved, see
    LOOP_IMPLS) selects the kernel or the XLA while_loop — identical
    semantics.  ``Ct`` non-None selects the photometric (gain/offset)
    solve."""
    if loop != "xla":
        return _iterate_kernel(
            Cx, Cy, Ct, tq, f0, conv0, iters, eps, float(S - P - 1),
            interpret=(loop == "interpret"),
        )
    dtype = Cx.dtype
    K = Cx.shape[-1]
    lo = jnp.asarray(0.0, dtype)
    hi = jnp.asarray(S - P - 1.0, dtype)
    u_iota = jax.lax.broadcasted_iota(jnp.int32, (1, K), 1).astype(dtype)  # (1, K)
    tgx, tgy, G = tq.tgx, tq.tgy, tq.G

    def cond(carry):
        _, converged, it = carry
        return (it < iters) & ~jnp.all(converged)

    def body(carry):
        f, converged, it = carry
        fx = jnp.clip(f[:, 0], lo, hi)
        fy = jnp.clip(f[:, 1], lo, hi)
        wx = jnp.maximum(0.0, 1.0 - jnp.abs(u_iota - fx[:, None]))  # (N, K)
        wy = jnp.maximum(0.0, 1.0 - jnp.abs(u_iota - fy[:, None]))
        w2 = wy[:, :, None] * wx[:, None, :]  # (N, K, K)
        bx = tgx - jnp.sum(w2 * Cx, (-2, -1))
        by = tgy - jnp.sum(w2 * Cy, (-2, -1))
        if Ct is not None:
            bt = tq.st2 - jnp.sum(w2 * Ct, (-2, -1))
            b3 = jnp.stack([bx, by, bt], -1)  # (N, 3)
            delta = jnp.einsum("nij,nj->ni", tq.Binv, b3)
        else:
            delta = solve2x2(G, jnp.stack([bx, by], -1))
        # delta applies to the carried (possibly unclipped) f, then the
        # new iterate is clamped into the search range — klt_gemm order.
        new_f = jnp.clip(f + delta, lo, hi)
        now_conv = jnp.linalg.norm(delta, axis=-1) < eps
        f = jnp.where(converged[:, None], f, new_f)
        return (f, converged | now_conv, it + 1)

    f, _, _ = jax.lax.while_loop(cond, body, (f0, conv0, jnp.zeros((), jnp.int32)))
    return f


def _extract_at_origins(img, org, S):
    """(N, S, S) windows at integer origins ``org`` (float (N, 2) [x, y],
    already clipped to [0, W-S] x [0, H-S])."""

    def one(o):
        return jax.lax.dynamic_slice(img, (o[1], o[0]), (S, S))

    return jax.vmap(one)(org.astype(jnp.int32))


def _interp_template(img, pts, P):
    """(N, P+2, P+2) interpolated template super-patches at ``pts`` —
    the exact extraction + interpolation path of ``_track_level_corr``
    (bit-identical; the template-carry contract depends on it).

    Tent-weight resampling of a (P+4)-window: two small matmuls per
    feature, run at the frontend's matmul precision.  On the H100 it runs
    at the speed of four exact bilinear slices, with the same ATE
    (PERF.md)."""
    T, q = P + 4, P + 2
    tpatch, torg = _extract_patches(img, pts, T)
    first = pts - (P + 1) / 2.0 - torg
    Wy = _tent_weights(first[:, 1], q, T, img.dtype)
    Wx = _tent_weights(first[:, 0], q, T, img.dtype)
    return _sample(Wy, tpatch, Wx)  # (N, P+2, P+2)


def fused_stereo_supported(img_shape, win: int) -> bool:
    """True when the image is large enough for ``stereo_anchor_lr_fused``'s
    margined search-patch geometry."""
    return min(img_shape) >= win + 2 * _SEARCH_RADIUS + 4


def stereo_anchor_lr_fused(
    img0: jnp.ndarray,
    img1: jnp.ndarray,
    pts0: jnp.ndarray,
    guess: jnp.ndarray,
    valid_in: jnp.ndarray,
    win: int = 15,
    iters: int = 30,
    eps: float = 0.01,
    anchor_sp: jnp.ndarray | None = None,
    anchor_valid: jnp.ndarray | None = None,
    anchor_radius: float = 2.0,
    norm: str = "none",
    anchor_norm: str | None = None,
    loop: str | None = None,
):
    """Fused full-resolution stereo fine level: (optional) anchor-template
    refinement of ``pts0`` + forward LK img0->img1 + backward left-right
    round trip, sharing patch extractions across the three alignment
    problems.

    The unfused composition ran five patch extractions per frame for these
    stages; the fusion is an op-count reduction at (near-)identical
    numerics:

      big0 = S-window of img0 at pts0      — serves the anchor-refinement
             search (bit-identical to the unfused call) AND the backward
             round-trip search (unfused searched at the anchor-REFINED
             position; <= anchor_radius px range shift, decisions preserved
             — the range is +-9 px vs a ~1 px round-trip threshold);
      big1 = (S+2)-window of img1 at the disparity guess — rows/cols
             [1, S+1) are the forward search window (bit-identical interior;
             <= 1 px search-range shift within S/2+1 px of the image border)
             and the margins contain the (P+2)-window at any in-range
             forward result, so the backward template is tent-interpolated
             from it instead of re-extracted (same sample positions as the
             unfused extraction; fp association differs);
      the forward template keeps its own exact extraction path
      (_interp_template) — the template-carry contract
      (FrontendConfig.tmpl_carry) requires bit-identity with the temporal
      call's extraction.

    ``anchor_sp``/``anchor_valid`` cover the first A lanes (the survivor
    slice); remaining lanes pass through unrefined.  ``norm`` selects the
    photometric normalization of every alignment problem in the call
    (see ``_template_quantities``; 'none' is bit-identical to the
    historical path).  ``loop`` selects the LK loop (see LOOP_IMPLS).
    Returns
    (pts0_out, anchor_accept (A,) bool, KltResult forward, rt2 (N,)
    round-trip squared error — +inf where the backward track is invalid,
    sp forward templates (N, P+2, P+2), min_eig (N,) forward-template
    minimum gradient eigenvalue per pixel — the tracking-SNR proxy).

    Replaces the unfused stereoMatch + LR + anchor composition; reference
    anchor: image_processor.cpp:534-620 (single forward pass, no round
    trip or anchor — those are this build's safeguards, see config.py).
    """
    dtype = img0.dtype
    H, W = img0.shape
    P = win
    S = min(P + 2 * _SEARCH_RADIUS + 2, H, W)
    Sb = S + 2
    if min(H, W) < Sb or S < P + 2:
        raise ValueError(
            f"image {img0.shape} too small for fused stereo (needs >= {Sb})"
        )
    loop = _resolve_loop(loop)
    c_off = (P - 1) / 2.0
    r = P // 2 + 1

    def _inb(p):
        return (p[:, 0] >= r) & (p[:, 0] < W - r) & (p[:, 1] >= r) & (p[:, 1] < H - r)

    # --- Shared img0 window centered at the (pre-refinement) cam0 points.
    sorg0 = jnp.clip(
        jnp.floor(pts0) - (S // 2), 0, jnp.array([W - S, H - S], dtype)
    )
    big0 = _extract_at_origins(img0, sorg0, S)

    # --- Anchor refinement (first A lanes; bit-identical to the unfused
    # optical_flow_lk_corr_l0(img0, img0, pts0, pts0, tmpl_sp=anchor) call:
    # same search window, same template path, same iteration).
    pts0_out = pts0
    accept = None
    if anchor_sp is not None:
        A = anchor_sp.shape[0]
        a_norm = norm if anchor_norm is None else anchor_norm
        tqa = _template_quantities(anchor_sp, P, a_norm)
        Cxa, Cya, Cta = _surfaces_for_norm(big0[:A], tqa, P, a_norm)
        f0a = pts0[:A] - c_off - sorg0[:A]
        fa = _run_iterations(
            Cxa, Cya, Cta, tqa, f0a, ~tqa.good, iters, eps, S, P, loop
        )
        pa = fa + c_off + sorg0[:A]
        oka = tqa.good & _inb(pa) & _inb(pts0[:A])
        corr2 = jnp.sum((pa - pts0[:A]) ** 2, axis=1)
        acc = anchor_valid & oka & (corr2 <= anchor_radius**2)
        accept = acc
        pts0_out = pts0.at[:A].set(jnp.where(acc[:, None], pa, pts0[:A]))

    # --- Forward template at the refined positions (exact path).
    sp = _interp_template(img0, pts0_out, P)
    tq = _template_quantities(sp, P, norm)

    # --- Forward search: one (S+2)-window extraction; the +-1 margins
    # contain the backward-template window at any in-range forward result.
    guess2 = guess + (pts0_out - pts0)
    o1 = jnp.clip(
        jnp.floor(guess2) - (S // 2) - 1, 0, jnp.array([W - Sb, H - Sb], dtype)
    )
    big1 = _extract_at_origins(img1, o1, Sb)
    spatch = big1[:, 1 : 1 + S, 1 : 1 + S]
    so = o1 + 1.0
    Cx, Cy, Ct = _surfaces_for_norm(spatch, tq, P, norm)
    f0 = guess2 - c_off - so
    f = _run_iterations(Cx, Cy, Ct, tq, f0, ~tq.good, iters, eps, S, P, loop)
    pts1 = f + c_off + so
    okf = tq.good & _inb(pts1) & _inb(pts0_out)
    res = KltResult(pts=pts1, valid=valid_in & okf)

    # --- Backward round trip: template tent-interpolated from big1 at the
    # forward result (contained by the margins for all iterated lanes;
    # frozen/garbage lanes clamp and are masked by okf anyway), search on
    # big0, starting at the refined cam0 position.
    q = P + 2
    ob = jnp.clip(pts1 - (P + 1) / 2.0 - o1, 0.0, Sb - (P + 3.0))
    sp_b = _sample(
        _tent_weights(ob[:, 1], q, Sb, dtype), big1, _tent_weights(ob[:, 0], q, Sb, dtype)
    )
    tqb = _template_quantities(sp_b, P, norm)
    Cxb, Cyb, Ctb = _surfaces_for_norm(big0, tqb, P, norm)
    f0b = pts0_out - c_off - sorg0
    fb = _run_iterations(
        Cxb, Cyb, Ctb, tqb, f0b, ~tqb.good, iters, eps, S, P, loop
    )
    rt = fb + c_off + sorg0
    okb = tqb.good & _inb(rt) & _inb(pts1)
    rt2 = jnp.where(okb, jnp.sum((rt - pts0_out) ** 2, axis=1), jnp.inf)

    return pts0_out, accept, res, rt2, sp, tq.min_eig


def _track_level_corr(
    img_prev, img_curr, pts_prev, pts_curr0, win, iters, eps, final_level,
    tmpl_sp=None, want_tmpl=False, norm="none", loop=None,
):
    """One pyramid level for all N features (batched).

    ``tmpl_sp``: optional precomputed (N, P+2, P+2) interpolated template
    patches (as produced by a previous call with ``want_tmpl=True`` at the
    same (image, position) pairs) — skips template extraction entirely.
    With ``want_tmpl=True`` the return gains the template patches.
    ``norm``: photometric normalization (see _template_quantities)."""
    dtype = img_prev.dtype
    H, W = img_prev.shape
    P = win
    S = min(win + 2 * _SEARCH_RADIUS + 2, H, W)
    loop = _resolve_loop(loop)

    # --- Template + gradients (one-time cost).
    T = P + 4
    if S < P + 2 or min(H, W) < T:
        out = pts_curr0, jnp.ones(pts_curr0.shape[0], bool)
        return out + (tmpl_sp,) if want_tmpl else out
    sp = tmpl_sp if tmpl_sp is not None else _interp_template(img_prev, pts_prev, P)
    tq = _template_quantities(sp, P, norm)

    # --- Search patch around the initial guess + correlation surfaces.
    sorg = jnp.clip(
        jnp.floor(pts_curr0) - (S // 2), 0, jnp.array([W - S, H - S], dtype)
    )
    spatch = _extract_at_origins(img_curr, sorg, S)
    Cx, Cy, Ct = _surfaces_for_norm(spatch, tq, P, norm)  # (N, K, K)

    # Window-origin coordinates: f = pts - (P-1)/2 - sorg.  Carried
    # *unclipped* (matching klt_gemm: the initial guess may sit outside the
    # search range near image borders; sampling clamps, the first update
    # re-enters the range).
    c_off = (P - 1) / 2.0
    f0 = pts_curr0 - c_off - sorg  # (N, 2) [fx, fy]
    f = _run_iterations(Cx, Cy, Ct, tq, f0, ~tq.good, iters, eps, S, P, loop)
    pts = f + c_off + sorg

    good = tq.good
    if not final_level:
        ok = jnp.ones(pts.shape[0], bool)
    else:
        r = win // 2 + 1
        ok = (pts[:, 0] >= r) & (pts[:, 0] < W - r) & (pts[:, 1] >= r) & (pts[:, 1] < H - r)
        ok = ok & (pts_prev[:, 0] >= r) & (pts_prev[:, 0] < W - r)
        ok = ok & (pts_prev[:, 1] >= r) & (pts_prev[:, 1] < H - r)
        ok = good & ok
    return (pts, ok, sp) if want_tmpl else (pts, ok)


def optical_flow_lk_corr_l0(
    img_prev: jnp.ndarray,
    img_curr: jnp.ndarray,
    pts_prev: jnp.ndarray,
    pts_curr_init: jnp.ndarray,
    valid_in: jnp.ndarray,
    win: int = 15,
    iters: int = 30,
    eps: float = 0.01,
    tmpl_sp: jnp.ndarray | None = None,
    want_tmpl: bool = False,
    norm: str = "none",
    loop: str | None = None,
):
    """Single-level LK with template reuse: ``tmpl_sp`` (N, win+2, win+2)
    skips template extraction (the patches must come from a previous
    ``want_tmpl=True`` call at the same (image, position) pairs — the
    front-end carries the merged stereo call's templates into the next
    frame's temporal call, which reads the same image at the same points).
    Returns (KltResult, templates or None)."""
    out = _track_level_corr(
        img_prev, img_curr, pts_prev, pts_curr_init, win, iters, eps, True,
        tmpl_sp=tmpl_sp, want_tmpl=True, norm=norm, loop=loop,
    )
    pts, ok, sp = out
    res = KltResult(pts=pts, valid=valid_in & ok)
    return (res, sp) if want_tmpl else (res, None)


def optical_flow_pyr_lk_corr(
    pyr_prev: Sequence[jnp.ndarray],
    pyr_curr: Sequence[jnp.ndarray],
    pts_prev: jnp.ndarray,
    pts_curr_init: jnp.ndarray,
    valid_in: jnp.ndarray,
    win: int = 15,
    iters: int = 30,
    eps: float = 0.01,
    norm: str = "none",
    loop: str | None = None,
) -> KltResult:
    """Drop-in replacement for klt.optical_flow_pyr_lk (same semantics)."""
    L = len(pyr_prev)
    scale = 2.0 ** (L - 1)
    pts = pts_curr_init / scale
    valid = valid_in

    for lvl in range(L - 1, -1, -1):
        s = 2.0**lvl
        pts, ok = _track_level_corr(
            pyr_prev[lvl], pyr_curr[lvl], pts_prev / s, pts, win, iters, eps, lvl == 0,
            norm=norm, loop=loop,
        )
        valid = valid & ok
        if lvl > 0:
            pts = pts * 2.0

    return KltResult(pts=pts, valid=valid)
