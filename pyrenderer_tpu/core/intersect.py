"""Batched ray-triangle intersection (JAX): broadcast elementwise + matmul paths.

The reference's innermost hot loop is a scalar Möller–Trumbore test run
per-face inside each BVH leaf (reference mathematics/intersection_taichi.py:69
ray_triangle_hit; Numba batch variant mathematics/intersection.py:42-82).
Here every ray meets every triangle at once, as array programs:

1. ``intersect_brute`` — broadcast (N rays × T triangles) Möller–Trumbore in
   the reference's exact operation order (used for parity tests and as the
   correctness oracle; the CPU default).

2. ``intersect_matmul`` — every Möller–Trumbore
   quantity is a scalar triple product, i.e. a polynomial in (o, d) that is
   at most bilinear: f(o, d) = c0 + a·o + b·d + o^T C d. Stacking the
   coefficients of [det, u*det, v*det, t*det] for all T triangles gives a
   (16, 4T) matrix; a wavefront of N rays forms features
   phi = [1, o, d, o (x) d] in R^16 and ONE matmul phi @ W computes every
   ray-triangle test. Not auto-selected; kept as plain XLA.

Both return the same (hit, t, tri) up to floating-point association.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp

from pyrenderer_tpu.scene.types import Scene


def _gather_tris(scene: Scene):
    v = scene.vertices
    f = scene.faces
    v0 = v[f[:, 0]]
    v1 = v[f[:, 1]]
    v2 = v[f[:, 2]]
    return v0, v1 - v0, v2 - v0  # v0, e1, e2


def _mt_terms(v0, e1, e2, ro, rd):
    """Reference-ordered Möller–Trumbore terms for (N, T) ray-triangle pairs.

    Mirrors intersection_taichi.py:69-91: e1 x d, det = (e1 x d)·e2,
    s = o - v0, s x e2, t = -f (s x e2)·e1, u = -f (s x e2)·d,
    v = f (e1 x d)·s.
    """
    c_e1_d = jnp.cross(e1[None, :, :], rd[:, None, :])        # (N, T, 3)
    det = jnp.sum(c_e1_d * e2[None, :, :], axis=-1)           # (N, T)
    s = ro[:, None, :] - v0[None, :, :]
    c_s_e2 = jnp.cross(s, e2[None, :, :])
    safe_det = jnp.where(det == 0, 1.0, det)
    f = 1.0 / safe_det
    t = -f * jnp.sum(c_s_e2 * e1[None, :, :], axis=-1)
    u = -f * jnp.sum(c_s_e2 * rd[:, None, :], axis=-1)
    v = f * jnp.sum(c_e1_d * s, axis=-1)
    return det, t, u, v


def _accept(det, t, u, v, t0, t1):
    if jnp.ndim(t1) == 1:
        t1 = t1[:, None]
    return (
        (jnp.abs(det) > 0)
        & (t > t0)
        & (t < t1)
        & (u >= 0)
        & (u <= 1)
        & (v >= 0)
        & (1.0 - u - v >= 0)
    )


def intersect_brute_arrays(v0, e1, e2, ro, rd, t0, t1):
    """Closest hit over raw (T, 3) triangle arrays (v0, e1=v1-v0, e2=v2-v0).

    Returns (hit (N,) bool, t (N,), tri (N,) i32). Degenerate padding rows
    (e1 = e2 = 0 => det = 0) can never be accepted, so callers may pad the
    triangle set freely (used by dist/geometry.py shard padding)."""
    det, t, u, v = _mt_terms(v0, e1, e2, ro, rd)
    valid = _accept(det, t, u, v, t0, t1)
    big = jnp.asarray(jnp.inf, t.dtype)
    t_masked = jnp.where(valid, t, big)
    tri = jnp.argmin(t_masked, axis=1).astype(jnp.int32)
    t_hit = jnp.take_along_axis(t_masked, tri[:, None].astype(jnp.int32), axis=1)[:, 0]
    hit = jnp.isfinite(t_hit)
    return hit, jnp.where(hit, t_hit, 0.0), tri


def occluded_arrays(v0, e1, e2, ro, rd, t0, t1):
    """Any-hit shadow query over raw triangle arrays (see intersect_brute_arrays)."""
    det, t, u, v = _mt_terms(v0, e1, e2, ro, rd)
    return jnp.any(_accept(det, t, u, v, t0, t1), axis=1)


def intersect_brute(scene: Scene, ro, rd, t0, t1):
    """Closest hit over all triangles. Returns (hit (N,) bool, t (N,), tri (N,) i32).

    Ties resolve to the lowest face index, matching the reference's
    sequential strict-less-than scan (shapes.py:80-90)."""
    return intersect_brute_arrays(*_gather_tris(scene), ro, rd, t0, t1)


def occluded(scene: Scene, ro, rd, t0, t1):
    """Any-hit shadow query with per-ray t1 (the reference runs a full
    closest-hit BVH walk for this — tracing.py:103; any-hit suffices)."""
    return occluded_arrays(*_gather_tris(scene), ro, rd, t0, t1)


# ---------------------------------------------------------------------------
# Matmul path: intersection as one matrix product.
# ---------------------------------------------------------------------------

def build_tri_matrix(scene: Scene):
    """Coefficient matrix W: (16, T, 4) with outputs [det, u*det, v*det, t*det].

    Each output is c0 + a·o + b·d + sum_ij C_ij o_i d_j; coefficients are
    extracted by evaluating the exact triple-product formulas on basis
    vectors, so W inherits differentiability w.r.t. scene.vertices.
    """
    v0, e1, e2 = _gather_tris(scene)
    dtype = v0.dtype
    T = v0.shape[0]

    def quantities(o, d):
        # o, d: (3,) broadcast against (T, 3) triangles -> (T, 4)
        c_e1_d = jnp.cross(e1, d[None, :])
        det = jnp.sum(c_e1_d * e2, axis=-1)
        s = o[None, :] - v0
        c_s_e2 = jnp.cross(s, e2)
        t_det = -jnp.sum(c_s_e2 * e1, axis=-1)
        u_det = -jnp.sum(c_s_e2 * d[None, :], axis=-1)
        v_det = jnp.sum(c_e1_d * s, axis=-1)
        return jnp.stack([det, u_det, v_det, t_det], axis=-1)  # (T, 4)

    zero = jnp.zeros(3, dtype)
    eye = jnp.eye(3, dtype=dtype)
    c0 = quantities(zero, zero)                                    # (T, 4)
    co = jnp.stack([quantities(eye[i], zero) - c0 for i in range(3)])   # (3, T, 4)
    cd = jnp.stack([quantities(zero, eye[j]) - c0 for j in range(3)])   # (3, T, 4)
    cod = jnp.stack(
        [
            jnp.stack(
                [
                    quantities(eye[i], eye[j]) - c0 - co[i] - cd[j]
                    for j in range(3)
                ]
            )
            for i in range(3)
        ]
    )  # (3, 3, T, 4)
    w = jnp.concatenate(
        [c0[None], co, cd, cod.reshape(9, T, 4)], axis=0
    )  # (16, T, 4)
    return w


def ray_features(ro, rd):
    """phi = [1, o, d, o (x) d] : (N, 16)."""
    n = ro.shape[0]
    ones = jnp.ones((n, 1), ro.dtype)
    od = (ro[:, :, None] * rd[:, None, :]).reshape(n, 9)
    return jnp.concatenate([ones, ro, rd, od], axis=1)


def mt_terms_matmul(tri_matrix, ro, rd):
    """All (N, T) Möller–Trumbore terms via one matmul."""
    k, T, _ = tri_matrix.shape
    phi = ray_features(ro, rd)                                     # (N, 16)
    # Precision.HIGHEST is load-bearing: a reduced-precision default
    # (TF32 on the GPU) loses the geometric precision of the triple
    # products and silently misses intersections.
    raw = jnp.dot(
        phi,
        tri_matrix.reshape(k, T * 4),
        preferred_element_type=phi.dtype,
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, T, 4)
    det = raw[..., 0]
    safe_det = jnp.where(det == 0, 1.0, det)
    f = 1.0 / safe_det
    u = raw[..., 1] * f
    v = raw[..., 2] * f
    t = raw[..., 3] * f
    return det, t, u, v


def intersect_matmul(scene: Scene, ro, rd, t0, t1, tri_matrix=None):
    """Closest hit using the matmul formulation. Same contract as intersect_brute."""
    if tri_matrix is None:
        tri_matrix = build_tri_matrix(scene)
    det, t, u, v = mt_terms_matmul(tri_matrix, ro, rd)
    valid = _accept(det, t, u, v, t0, t1)
    big = jnp.asarray(jnp.inf, t.dtype)
    t_masked = jnp.where(valid, t, big)
    tri = jnp.argmin(t_masked, axis=1).astype(jnp.int32)
    t_hit = jnp.take_along_axis(t_masked, tri[:, None].astype(jnp.int32), axis=1)[:, 0]
    hit = jnp.isfinite(t_hit)
    return hit, jnp.where(hit, t_hit, 0.0), tri


def occluded_matmul(scene: Scene, ro, rd, t0, t1, tri_matrix=None):
    if tri_matrix is None:
        tri_matrix = build_tri_matrix(scene)
    det, t, u, v = mt_terms_matmul(tri_matrix, ro, rd)
    return jnp.any(_accept(det, t, u, v, t0, t1), axis=1)
