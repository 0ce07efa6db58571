"""Watertight ray-triangle intersection (PBRT shear formulation), batched.

Algorithm of reference mathematics/intersection_taichi.py:94-161
(ray_triangle_hit2): translate to ray origin, permute so the dominant ray
axis is z, shear to align the ray with +z, compute 2D edge functions, and
reject only when the edge signs are mixed — shared edges/vertices then
never leak rays.

The reference falls back to float64 when an edge function is exactly zero
(intersection_taichi.py:128-136). f64 is slow on accelerators (SURVEY §7
"Hard parts"), so the fallback here is a **compensated difference-of-
products** (Dekker/Kahan two-product), pure f32 — it recovers the
correctly-signed residual of a*b - c*d even under catastrophic
cancellation, at ~10 elementwise ops,
only ever applied where the fast path returned exactly 0.
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1 for f32 Dekker splitting (24-bit mantissa)


def _two_product_err(a, b):
    """Error of the rounded product: fl(a*b) + err == a*b exactly."""
    p = a * b
    ah = a * _SPLIT
    ah = ah - (ah - a)
    al = a - ah
    bh = b * _SPLIT
    bh = bh - (bh - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def diff_of_products(a, b, c, d):
    """a*b - c*d with a compensated correction term (correct sign even when
    the naive f32 result cancels to 0)."""
    p1, e1 = _two_product_err(a, b)
    p2, e2 = _two_product_err(c, d)
    return (p1 - p2) + (e1 - e2)


# Fallback trigger: |a*b - c*d| <= (|a*b| + |c*d|) * 2^-22.
#
# Round 5 finding: triggering on e == 0.0 EXACTLY (the round-1..4 design,
# after PBRT's f64 fallback) is fusion-dependent — XLA freely contracts
# the mul/sub pair into an fma, in which case an exactly-cancelling
# a*b - c*d evaluates to the +/-1-ulp rounding residue of c*d instead of
# 0.0 and the fallback NEVER fires (measured on CPU jit: the 4096-ray
# shared-edge hunt leaks 2043 rays with the dop code absent, 0 with it
# present, because the dop operand reuse happens to suppress the
# contraction — i.e. correctness hinged on a fusion accident). A
# relative threshold of 2 ulp of the product magnitudes covers the
# contraction residue on every backend, and lanes under it get the
# compensated recomputation whose value does not depend on contraction
# of the surrounding code.
_EDGE_REL_TOL = 2.0 ** -22


def edge_fn(a, b, c, d):
    """Watertight 2D edge function a*b - c*d: fast product difference,
    compensated (diff_of_products) wherever cancellation leaves less
    than ~2 ulp of signal — see _EDGE_REL_TOL for why the trigger is a
    threshold, not ==0."""
    p1 = a * b
    p2 = c * d
    e = p1 - p2
    thr = (jnp.abs(p1) + jnp.abs(p2)) * _EDGE_REL_TOL
    return jnp.where(jnp.abs(e) <= thr, diff_of_products(a, b, c, d), e)


def _permute(v, kx, ky, kz):
    """Gather-free axis permutation for (..., 3) with per-element indices."""
    def pick(k):
        return jnp.where(
            k[..., None] == 0,
            v[..., 0:1],
            jnp.where(k[..., None] == 1, v[..., 1:2], v[..., 2:3]),
        )[..., 0]

    return jnp.stack([pick(kx), pick(ky), pick(kz)], axis=-1)


def watertight_terms(v0, v1, v2, ro, rd):
    """Broadcast watertight test terms for (N rays x T triangles).

    v0/v1/v2: (T, 3); ro/rd: (N, 3). Returns (valid_geom (N,T), t (N,T)) —
    `valid_geom` is the sign test only; range conditions (t0 < t < t1) are
    the caller's.
    """
    ad = jnp.abs(rd)
    kz = jnp.argmax(ad, axis=-1)          # (N,)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    d = _permute(rd, kx, ky, kz)          # (N, 3)

    sx = -d[:, 0] / d[:, 2]
    sy = -d[:, 1] / d[:, 2]
    sz = 1.0 / d[:, 2]

    def shear(p):  # p: (T, 3) -> (N, T, 3) permuted+sheared
        pt = p[None, :, :] - ro[:, None, :]
        pt = _permute(
            pt,
            jnp.broadcast_to(kx[:, None], pt.shape[:2]),
            jnp.broadcast_to(ky[:, None], pt.shape[:2]),
            jnp.broadcast_to(kz[:, None], pt.shape[:2]),
        )
        x = pt[..., 0] + sx[:, None] * pt[..., 2]
        y = pt[..., 1] + sy[:, None] * pt[..., 2]
        z = pt[..., 2]
        return x, y, z

    x0, y0, z0 = shear(v0)
    x1, y1, z1 = shear(v1)
    x2, y2, z2 = shear(v2)

    # compensated recomputation where cancellation leaves < ~2 ulp of
    # signal (threshold, NOT ==0: see _EDGE_REL_TOL — exact-zero
    # detection is destroyed by XLA fma contraction)
    e0 = edge_fn(x1, y2, y1, x2)
    e1 = edge_fn(x2, y0, y2, x0)
    e2 = edge_fn(x0, y1, y0, x1)

    mixed = ((e0 < 0) | (e1 < 0) | (e2 < 0)) & ((e0 > 0) | (e1 > 0) | (e2 > 0))
    det = e0 + e1 + e2
    t_scaled = (
        e0 * (z0 * sz[:, None]) + e1 * (z1 * sz[:, None]) + e2 * (z2 * sz[:, None])
    )
    safe_det = jnp.where(det == 0, 1.0, det)
    t = t_scaled / safe_det
    valid = (~mixed) & (jnp.abs(det) > 0)
    return valid, t


def intersect_watertight(scene, ro, rd, t0, t1):
    """Closest hit over all triangles with the watertight test.
    Same contract as core.intersect.intersect_brute (selectable as
    backend="watertight" through TraceTables / render_image / the CLI)."""
    v = scene.vertices
    f = scene.faces
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    valid, t = watertight_terms(v0, v1, v2, ro, rd)
    if jnp.ndim(t1) == 1:
        t1 = t1[:, None]
    valid = valid & (t > t0) & (t < t1)
    big = jnp.asarray(jnp.inf, t.dtype)
    t_masked = jnp.where(valid, t, big)
    tri = jnp.argmin(t_masked, axis=1).astype(jnp.int32)
    t_hit = jnp.take_along_axis(t_masked, tri[:, None], axis=1)[:, 0]
    hit = jnp.isfinite(t_hit)
    return hit, jnp.where(hit, t_hit, 0.0), tri


def occluded_watertight(scene, ro, rd, t0, t1):
    """Any-hit twin of intersect_watertight (shadow rays)."""
    v = scene.vertices
    f = scene.faces
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    valid, t = watertight_terms(v0, v1, v2, ro, rd)
    if jnp.ndim(t1) == 1:
        t1 = t1[:, None]
    return jnp.any(valid & (t > t0) & (t < t1), axis=1)
