"""Batched primary-ray generation (JAX).

Reproduces the reference CPU camera semantics (core/camera.py:41-72
generate_ray): sensor plane at ``focal_dist`` along -z in camera space,
``sensor_height = tan(fov/2) * focal_dist``, square-aperture jitter on the
ray origin, and the row-vector world transform ``homogeneous(v) @ iview``.
(The Taichi twin's aperture bug — scaling the lens jitter by focal distance,
camera_taichi.py:56-57 — is intentionally NOT reproduced; SURVEY §2.19 says
to follow the CPU camera.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pyrenderer_tpu import rng
from pyrenderer_tpu.scene.types import Camera


def generate_rays(camera: Camera, pixel_x, pixel_y, sample_id, seed: int,
                  strata: int = 0):
    """Primary rays for pixel coords (x right, y up-from-bottom).

    pixel_x, pixel_y: (...,) int32; sample_id: scalar or (...,) int32.
    strata > 1 enables stratified (jittered-grid) pixel sampling over a
    strata x strata grid walked by sample_id (the capability of reference
    taichi_ref.py:437-454; Tungsten's stratified_sampler flag).
    Returns (ro, rd): (..., 3) arrays in the camera's dtype.
    """
    w, h = camera.resolution
    dtype = camera.iview.dtype
    pixel_id = (pixel_y * w + pixel_x).astype(jnp.uint32)

    jx, jy = rng.uniform2(seed, pixel_id, sample_id, rng.CAMERA_BOUNCE, rng.U_PIXEL_X, dtype)
    if strata > 1:
        stratum = jnp.asarray(sample_id, jnp.uint32) % (strata * strata)
        sx = (stratum % strata).astype(dtype)
        sy = (stratum // strata).astype(dtype)
        jx = (sx + jx) / strata
        jy = (sy + jy) / strata
    u = (pixel_x.astype(dtype) + jx) / w
    v = (pixel_y.astype(dtype) + jy) / h

    fov = camera.fov_deg * (jnp.pi / 180.0)
    sensor_h = jnp.tan(fov / 2) * camera.focal_dist
    sensor_w = sensor_h * (w / h)

    cx = u - 0.5
    cy = v - 0.5
    d_cam = jnp.stack(
        [
            cx * sensor_w * 2.0,
            cy * sensor_h * 2.0,
            -camera.focal_dist * jnp.ones_like(cx),
        ],
        axis=-1,
    )

    lx, ly = rng.uniform2(seed, pixel_id, sample_id, rng.CAMERA_BOUNCE, rng.U_LENS_X, dtype)
    ap = camera.aperture
    o_cam = jnp.stack(
        [
            jnp.where(ap > 0, ap * lx - ap / 2, 0.0),
            jnp.where(ap > 0, ap * ly - ap / 2, 0.0),
            jnp.zeros_like(lx),
        ],
        axis=-1,
    )

    rot = camera.iview[:3, :3]  # row-vector: world = cam_vec @ iview
    trans = camera.iview[3, :3]
    # HIGHEST: an f32 product may otherwise run in TF32 on the GPU, which
    # moves rays by ~1e-3 relative
    hi = jax.lax.Precision.HIGHEST
    rd = jnp.matmul(d_cam - o_cam, rot, precision=hi)
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    ro = jnp.matmul(o_cam, rot, precision=hi) + trans
    return ro, rd


def morton_pixel_order(w: int, h: int):
    """Permutation putting flattened row-major pixels into Morton (Z-curve)
    order, and its inverse. NumPy, host-side, computed once per resolution.

    Why: the GPU runs consecutive rays together (a warp, a kernel
    program); in row-major order a run of 128 rays is a 1x128 scanline
    sliver whose frustum crosses many acceleration-structure nodes, while
    a Morton run is a ~12x11 screen block whose rays walk similar BVH
    paths. Ordering is invisible to the estimator (the RNG is keyed on
    pixel id, not trace order).

    Returns (perm, inv_perm), both (w*h,) int64 with
    flat_morton = flat_row_major[perm] and flat_row_major = flat_morton[inv_perm].
    """
    import numpy as np

    ys, xs = np.mgrid[0:h, 0:w]
    xs = xs.reshape(-1).astype(np.uint64)
    ys = ys.reshape(-1).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    code = (spread(xs) << np.uint64(1)) | spread(ys)
    perm = np.argsort(code, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def hilbert_pixel_order(w: int, h: int):
    """Row-major -> Hilbert-curve pixel permutation (and inverse).

    Stronger tile locality than the Z-curve: consecutive Hilbert cells
    are always screen-adjacent (no quadrant jumps), so a 128-ray
    wavefront tile is a compact connected blob instead of a Z-block with
    up-to-half-grid seams. Vectorized xy->d (bitwise rotate/reflect per
    level) on the next-pow2 square; arbitrary w x h handled by argsort
    of the valid cells' indices, like morton_pixel_order.

    Kept selectable via PYRENDERER_PIXEL_ORDER for locality experiments;
    not measured against Morton on the GPU.
    """
    import numpy as np

    n = 1 << int(np.ceil(np.log2(max(w, h, 2))))
    ys, xs = np.mgrid[0:h, 0:w]
    x = xs.reshape(-1).astype(np.int64)
    y = ys.reshape(-1).astype(np.int64)
    d = np.zeros(x.size, np.int64)
    s = n // 2
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate/reflect the sub-quadrant (vectorized Wikipedia rot())
        refl = (ry == 0) & (rx == 1)
        x_r = np.where(refl, s - 1 - (x & (s - 1)), x & (s - 1))
        y_r = np.where(refl, s - 1 - (y & (s - 1)), y & (s - 1))
        swap = ry == 0
        x, y = np.where(swap, y_r, x_r), np.where(swap, x_r, y_r)
        s //= 2
    perm = np.argsort(d, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv


def pixel_order(w: int, h: int, kind: str = "morton"):
    """Trace-order permutation selector ("morton" default, "hilbert",
    "row" = identity). Ordering is invisible to the estimator (RNG is
    keyed on pixel id); it only shapes wavefront-tile screen locality."""
    if kind == "hilbert":
        return hilbert_pixel_order(w, h)
    if kind == "row":
        import numpy as np

        ident = np.arange(w * h)
        return ident, ident.copy()
    if kind != "morton":
        # a typo'd env knob must not silently measure Morton while the
        # user believes they measured something else
        raise ValueError(f"unknown pixel order {kind!r} "
                         "(expected 'morton', 'hilbert', or 'row')")
    return morton_pixel_order(w, h)
