"""Analytic-primitive path tracer: spheres, planes, oriented AABBs.

The wavefront counterpart of the reference's standalone analytic renderer
(reference taichi_ref.py — a single self-contained file, deliberately
outside the Tungsten scene pipeline; this module mirrors that separation).
It reproduces, as one wavefront `lax.scan` program:

  - analytic intersectors: quadratic sphere with the reference's two-step
    root refinement (taichi_ref.py:108-142), plane (:145-153), slab AABB
    with entry-face normal (:156-190) and its transformed variant
    (:193-210);
  - the hardcoded Cornell-like scene: glass sphere, rotated specular box,
    five planes, area light (:220-287 intersect_scene; the scene constants
    are data shared with the reference, like the Cornell JSON);
  - MIS direct lighting — area-light sample + BRDF sample combined with
    the power heuristic (:368-397), visibility by re-intersection;
  - lambert / specular / glass materials with Schlick reflectance and the
    reference's branch structure (:400-434), as masked vector selects;
  - 5x5 stratified pixel sampling (:437-454) on the deterministic counter
    RNG (rng.py) instead of the reference's unseeded ti.random.

Everything is batched over rays (N, ...) with masks for divergence; the
handful of primitives is a static Python loop of vector min-combines (8
prims — a table would buy nothing).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pyrenderer_tpu import rng
from pyrenderer_tpu.core import sampling
from pyrenderer_tpu.core.bsdf import power_heuristic, reflect, schlick

INF = 1e10
EPS = 1e-4

MAT_NONE, MAT_LAMBERT, MAT_SPECULAR, MAT_GLASS, MAT_LIGHT = 0, 1, 2, 3, 4

# --- scene constants (data shared with taichi_ref.py:18-70) ---------------
CAMERA_POS = (0.0, 0.6, 3.0)
FOV = 0.8
MAX_DEPTH = 10
LIGHT_Y = 2.0 - EPS
LIGHT_X_MIN, LIGHT_X_RANGE = -0.25, 0.5
LIGHT_Z_MIN, LIGHT_Z_RANGE = 1.0, 0.12
LIGHT_AREA = LIGHT_X_RANGE * LIGHT_Z_RANGE
LIGHT_MIN = (LIGHT_X_MIN, LIGHT_Y, LIGHT_Z_MIN)
LIGHT_MAX = (LIGHT_X_MIN + LIGHT_X_RANGE, LIGHT_Y, LIGHT_Z_MIN + LIGHT_Z_RANGE)
LIGHT_COLOR = (0.9, 0.85, 0.7)
LIGHT_NORMAL = (0.0, -1.0, 0.0)
REFR_IDX = 2.4
SP1_CENTER = (0.4, 0.225, 1.75)
SP1_RADIUS = 0.22
BOX_MIN = (0.0, 0.0, 0.0)
BOX_MAX = (0.55, 1.1, 0.55)
STRATIFY = 5


def _box_transforms():
    rad = np.pi / 8.0
    c, s = np.cos(rad), np.sin(rad)
    rot = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])
    translate = np.eye(4)
    translate[:3, 3] = [-0.7, 0.0, 0.7]
    m = translate @ rot
    m_inv = np.linalg.inv(m)
    return m_inv.astype(np.float32), m_inv.T.astype(np.float32)


_BOX_M_INV, _BOX_M_INV_T = _box_transforms()


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


# --- analytic intersectors (vectorized over rays) -------------------------


def intersect_sphere(ro, rd, center, radius):
    """Quadratic sphere test with the reference's refinement step: advance
    to the first root, re-solve from there, accept only a positive forward
    root (taichi_ref.py:108-142). Returns (t, hit_pos); t = INF on miss."""
    center = jnp.asarray(center, ro.dtype)
    t_vec = ro - center
    b = 2.0 * _dot(t_vec, rd)
    c = _dot(t_vec, t_vec) - radius * radius
    delta = b * b - 4.0 * c
    near_ok = delta > -1e-4
    sdelta = jnp.sqrt(jnp.maximum(delta, 0.0))
    dist0 = 0.5 * (-b - sdelta)

    # refinement from the advanced position
    new_pos = ro + rd * dist0[:, None]
    t2 = new_pos - center
    b2 = 2.0 * _dot(t2, rd)
    c2 = _dot(t2, t2) - radius * radius
    delta2 = b2 * b2 - 4.0 * c2
    ok2 = delta2 > 0
    sdelta2 = jnp.sqrt(jnp.maximum(delta2, 0.0))
    ret = 0.5 * (-b2 - sdelta2) + dist0
    hit = near_ok & ok2 & (ret > 0)
    t = jnp.where(hit, ret, INF)
    hit_pos = new_pos + (0.5 * (-b2 - sdelta2))[:, None] * rd
    return t, hit_pos


def intersect_plane(ro, rd, point, normal):
    """Infinite plane (taichi_ref.py:145-153). Returns t (INF on miss)."""
    point = jnp.asarray(point, ro.dtype)
    normal = jnp.asarray(normal, ro.dtype)
    denom = _dot(rd, normal)
    t = jnp.where(
        jnp.abs(denom) > EPS, _dot(point - ro, normal) / denom, INF
    )
    return jnp.where(t > 0, t, INF)


def intersect_aabb(ro, rd, bmin, bmax):
    """Axis-aligned slab test returning the ENTRY face normal
    (taichi_ref.py:156-190). Returns (hit, t_near, t_far, normal)."""
    bmin = jnp.asarray(bmin, ro.dtype)
    bmax = jnp.asarray(bmax, ro.dtype)
    safe_d = jnp.where(rd == 0, 1e-20, rd)
    i1 = (bmin - ro) / safe_d
    i2 = (bmax - ro) / safe_d
    near = jnp.minimum(i1, i2)
    far = jnp.maximum(i1, i2)
    # degenerate axes: ray parallel and origin outside the slab -> miss
    outside = (rd == 0) & ((ro < bmin) | (ro > bmax))
    near_t = jnp.max(near, axis=-1)
    far_t = jnp.min(far, axis=-1)
    axis = jnp.argmax(near, axis=-1)
    near_is_max = jnp.take_along_axis(i2 < i1, axis[:, None], axis=-1)[:, 0]
    hit = (near_t <= far_t) & ~jnp.any(outside, axis=-1)
    sign = jnp.where(near_is_max, 1.0, -1.0)
    normal = jax.nn.one_hot(axis, 3, dtype=ro.dtype) * sign[:, None]
    return hit, near_t, far_t, normal


def intersect_aabb_transformed(ro, rd, bmin, bmax, m_inv, m_inv_t):
    """Oriented box: intersect in local space, normal back via the inverse
    transpose (taichi_ref.py:193-210)."""
    m_inv = jnp.asarray(m_inv, ro.dtype)
    m_inv_t = jnp.asarray(m_inv_t, ro.dtype)
    # HIGHEST: an f32 product may otherwise run in TF32 on the GPU
    hi = jax.lax.Precision.HIGHEST
    o_l = jnp.matmul(ro, m_inv[:3, :3].T, precision=hi) + m_inv[:3, 3]
    d_l = jnp.matmul(rd, m_inv[:3, :3].T, precision=hi)
    hit, t, _, n_l = intersect_aabb(o_l, d_l, bmin, bmax)
    hit = hit & (t > 0)
    n_w = jnp.matmul(n_l, m_inv_t[:3, :3].T, precision=hi)
    return hit, jnp.where(hit, t, INF), n_w


def intersect_light(ro, rd, tmax):
    hit, t, _, _ = intersect_aabb(ro, rd, LIGHT_MIN, LIGHT_MAX)
    ok = hit & (t > 0) & (t < tmax)
    return ok, jnp.where(ok, t, INF)


def intersect_scene(ro, rd):
    """Closest hit over the hardcoded scene (taichi_ref.py:222-287).

    Returns (t, normal, color, mat) — all (N, ...) arrays; mat is int32.
    """
    n = ro.shape[0]
    dtype = ro.dtype
    closest = jnp.full((n,), INF, dtype)
    normal = jnp.zeros((n, 3), dtype)
    color = jnp.zeros((n, 3), dtype)
    mat = jnp.full((n,), MAT_NONE, jnp.int32)

    def take(t_new, n_new, c_new, m_new, cond):
        nonlocal closest, normal, color, mat
        better = cond & (t_new > 0) & (t_new < closest)
        closest = jnp.where(better, t_new, closest)
        normal = jnp.where(better[:, None], n_new, normal)
        color = jnp.where(better[:, None], jnp.asarray(c_new, dtype), color)
        mat = jnp.where(better, m_new, mat)

    # glass sphere
    t, hp = intersect_sphere(ro, rd, SP1_CENTER, SP1_RADIUS)
    sn = sampling.safe_normalize(hp - jnp.asarray(SP1_CENTER, dtype))
    take(t, sn, (1.0, 1.0, 1.0), MAT_GLASS, t < INF)
    # rotated specular box
    bh, bt, bn = intersect_aabb_transformed(
        ro, rd, BOX_MIN, BOX_MAX, _BOX_M_INV, _BOX_M_INV_T
    )
    take(bt, bn, (0.8, 0.5, 0.4), MAT_SPECULAR, bh)
    # five planes (left red, right green, bottom/top/far gray)
    planes = [
        ((-1.1, 0.0, 0.0), (1.0, 0.0, 0.0), (0.65, 0.05, 0.05)),
        ((1.1, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.12, 0.45, 0.15)),
        ((0.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.93, 0.93, 0.93)),
        ((0.0, 2.0, 0.0), (0.0, -1.0, 0.0), (0.93, 0.93, 0.93)),
        ((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.93, 0.93, 0.93)),
    ]
    for point, pn, pc in planes:
        t = intersect_plane(ro, rd, point, pn)
        take(t, jnp.broadcast_to(jnp.asarray(pn, dtype), ro.shape), pc,
             MAT_LAMBERT, t < INF)
    # area light
    lh, lt = intersect_light(ro, rd, closest)
    take(lt, jnp.broadcast_to(jnp.asarray(LIGHT_NORMAL, dtype), ro.shape),
         LIGHT_COLOR, MAT_LIGHT, lh)
    return closest, normal, color, mat


def visible_to_light(p, wd):
    _, _, _, mat = intersect_scene(p + EPS * wd, wd)
    return mat == MAT_LIGHT


# --- lighting (taichi_ref.py:313-397) -------------------------------------


def area_light_pdf(p, wd):
    hit, t = intersect_light(p, wd, INF)
    l_cos = _dot(jnp.asarray(LIGHT_NORMAL, p.dtype), -wd)
    dist_sq = t * t * _dot(wd, wd)
    pdf = jnp.where(
        hit & (l_cos > EPS), dist_sq / (LIGHT_AREA * l_cos), 0.0
    )
    return pdf


def brdf_pdf(nrm, wd):
    return jnp.maximum(0.0, _dot(nrm, wd)) / np.pi


def sample_direct_light(p, nrm, hit_color, pixel, sample, bounce, seed):
    """MIS: one area-light sample + one BRDF sample, power heuristic."""
    dtype = p.dtype
    fl = (1.0 / np.pi) * hit_color * jnp.asarray(LIGHT_COLOR, dtype)

    ux, uz = rng.uniform2(seed, pixel, sample, bounce, rng.U_LIGHT_U, dtype)
    on_light = jnp.stack(
        [
            ux * LIGHT_X_RANGE + LIGHT_X_MIN,
            jnp.full_like(ux, LIGHT_Y),
            uz * LIGHT_Z_RANGE + LIGHT_Z_MIN,
        ],
        axis=1,
    )
    to_light = sampling.safe_normalize(on_light - p)
    l_pdf = area_light_pdf(p, to_light)
    b_pdf = brdf_pdf(nrm, to_light)
    vis = visible_to_light(p, to_light)
    ok = (_dot(to_light, nrm) > 0) & (l_pdf > 0) & (b_pdf > 0) & vis
    w = power_heuristic(l_pdf, b_pdf)
    nl = jnp.maximum(0.0, _dot(to_light, nrm))
    li = jnp.where(
        ok[:, None], fl * (w * nl / jnp.where(l_pdf == 0, 1.0, l_pdf))[:, None], 0.0
    )

    u1, u2 = rng.uniform2(seed, pixel, sample, bounce, rng.U_BSDF_1, dtype)
    bdir = sampling.rotate_z_to(nrm, sampling.cosine_sample_hemisphere(u1, u2))
    b_pdf2 = brdf_pdf(nrm, bdir)
    l_pdf2 = area_light_pdf(p, bdir)
    vis2 = visible_to_light(p, bdir)
    ok2 = (b_pdf2 > 0) & (l_pdf2 > 0) & vis2
    w2 = power_heuristic(b_pdf2, l_pdf2)
    nl2 = jnp.maximum(0.0, _dot(bdir, nrm))
    li = li + jnp.where(
        ok2[:, None],
        fl * (w2 * nl2 / jnp.where(b_pdf2 == 0, 1.0, b_pdf2))[:, None],
        0.0,
    )
    return li


def _refract(d, n, eta_ratio):
    """Reference refract (taichi_ref.py:82-93): returns (has_refr, dir)."""
    dt = _dot(d, n)
    discr = 1.0 - eta_ratio ** 2 * (1.0 - dt * dt)
    has = discr > 0
    rd = eta_ratio[:, None] * (d - n * dt[:, None]) - n * jnp.sqrt(
        jnp.maximum(discr, 0.0)
    )[:, None]
    return has, sampling.safe_normalize(rd)


def sample_ray_dir(indir, nrm, mat, pixel, sample, bounce, seed):
    """Next direction per material (taichi_ref.py:408-434), vectorized:
    lambert cosine sample, mirror reflect, glass schlick reflect/refract.
    Returns (dir, pdf)."""
    dtype = indir.dtype
    u1, u2 = rng.uniform2(seed, pixel, sample, bounce, rng.U_BSDF_0, dtype)
    lam = sampling.rotate_z_to(nrm, sampling.cosine_sample_hemisphere(u1, u2))
    lam_pdf = jnp.maximum(EPS, brdf_pdf(nrm, lam))

    spec = reflect(indir, nrm)

    cos_in = _dot(indir, nrm)
    going_out = cos_in > 0
    outn = jnp.where(going_out[:, None], -nrm, nrm)
    eta = jnp.where(going_out, REFR_IDX, 1.0 / REFR_IDX)
    cos = jnp.where(going_out, REFR_IDX * cos_in, -cos_in)
    has_refr, refr_dir = _refract(indir, outn, eta)
    refl_prob = jnp.where(has_refr, schlick(cos, REFR_IDX), 1.0)
    ur = rng.uniform(seed, pixel, sample, bounce, rng.U_BSDF_2, dtype)
    glass = jnp.where((ur < refl_prob)[:, None], reflect(indir, nrm), refr_dir)

    out = jnp.where(
        (mat == MAT_LAMBERT)[:, None], lam,
        jnp.where((mat == MAT_SPECULAR)[:, None], spec, glass),
    )
    pdf = jnp.where(mat == MAT_LAMBERT, lam_pdf, 1.0)
    return sampling.safe_normalize(out), pdf


# --- render (taichi_ref.py:440-491) ----------------------------------------


def trace(ro, rd, pixel, sample, seed, max_depth=MAX_DEPTH):
    """Wavefront radiance for N rays (masked bounce scan)."""
    dtype = ro.dtype
    n = ro.shape[0]

    def body(state, bounce):
        ro, rd, acc, thr, alive = state
        t, nrm, col, mat = intersect_scene(ro, rd)
        alive = alive & (mat != MAT_NONE)
        p = ro + t[:, None] * rd

        hit_light = alive & (mat == MAT_LIGHT)
        acc = acc + jnp.where(
            hit_light[:, None], thr * jnp.asarray(LIGHT_COLOR, dtype), 0.0
        )
        alive = alive & (mat != MAT_LIGHT)

        is_lam = mat == MAT_LAMBERT
        direct = sample_direct_light(p, nrm, col, pixel, sample, bounce, seed)
        acc = acc + jnp.where((alive & is_lam)[:, None], thr * direct, 0.0)

        new_dir, pdf = sample_ray_dir(rd, nrm, mat, pixel, sample, bounce, seed)
        lam_thr = (1.0 / np.pi) * col * (
            jnp.maximum(0.0, _dot(nrm, new_dir)) / pdf
        )[:, None]
        thr_mul = jnp.where(is_lam[:, None], lam_thr, col)
        thr = jnp.where(alive[:, None], thr * thr_mul, thr)
        ro = jnp.where(alive[:, None], p + EPS * new_dir, ro)
        rd = jnp.where(alive[:, None], new_dir, rd)
        return (ro, rd, acc, thr, alive), None

    init = (
        ro, rd,
        jnp.zeros((n, 3), dtype),
        jnp.ones((n, 3), dtype),
        jnp.ones((n,), bool),
    )
    (_, _, acc, _, _), _ = jax.lax.scan(
        body, init, jnp.arange(max_depth, dtype=jnp.uint32)
    )
    return acc


def camera_rays(res, sample, seed, dtype=jnp.float32):
    """Stratified primary rays (taichi_ref.py:441-455): the 5x5 stratum is
    chosen by pass index, the in-stratum jitter by the counter RNG."""
    w, h = res
    ys, xs = jnp.mgrid[0:h, 0:w]
    u = xs.reshape(-1).astype(dtype)
    v = ys.reshape(-1).astype(dtype)
    pixel = (ys.reshape(-1) * w + xs.reshape(-1)).astype(jnp.uint32)
    sample_arr = jnp.full_like(pixel, sample)
    str_x = (sample // STRATIFY) % STRATIFY
    str_y = sample % STRATIFY
    jx, jy = rng.uniform2(seed, pixel, sample_arr, 0, rng.U_PIXEL_X, dtype)
    aspect = w / h
    d = jnp.stack(
        [
            2.0 * FOV * (u + (str_x + jx) / STRATIFY) / h - FOV * aspect - 1e-5,
            2.0 * FOV * (v + (str_y + jy) / STRATIFY) / h - FOV - 1e-5,
            -jnp.ones_like(u),
        ],
        axis=1,
    )
    rd = sampling.safe_normalize(d)
    ro = jnp.broadcast_to(jnp.asarray(CAMERA_POS, dtype), rd.shape)
    return ro, rd, pixel, sample_arr


@partial(jax.jit, static_argnames=("res", "spp", "seed", "max_depth"))
def render(res=(200, 200), spp=4, seed=0, max_depth=MAX_DEPTH):
    """Accumulated HDR frame (H, W, 3), y flipped to row-0-top."""
    w, h = res

    def one(sample_idx):
        ro, rd, pixel, sample_arr = camera_rays(res, sample_idx, seed)
        return trace(ro, rd, pixel, sample_arr, seed, max_depth=max_depth)

    acc = jax.lax.map(one, jnp.arange(spp, dtype=jnp.uint32)).sum(0)
    return acc.reshape(h, w, 3)[::-1] / spp


def tonemap(hdr, gain=100.0):
    """The reference's display transform: sqrt(mean * 100) (taichi_ref.py
    :487-491 — the x100 gain is what makes this dim physical scene
    displayable; `render` already folds in the accumulation divide)."""
    return jnp.sqrt(jnp.clip(hdr * gain, 0.0, None))
