"""Whole-table ray-triangle intersection as a Pallas kernel for the GPU.

The pure-XLA path (core/intersect.py `intersect_brute`) evaluates every
(ray, triangle) pair as broadcast (N, T) arrays and then reduces them with
an argmin. This kernel fuses the whole query instead: one program owns a
block of BLOCK_RAYS rays, one ray per thread; each ray and its running
(t, tri) minimum stay in registers while the program loops over the
triangle table, so device memory sees only the ray inputs and the per-ray
outputs. It is the GPU form of the reference's innermost loop (reference
mathematics/intersection_taichi.py:69 ray_triangle_hit inside the
shapes.py:80-90 per-face scan).

Layout:
- rays arrive as seven structure-of-arrays vectors (ox, oy, oz, dx, dy, dz,
  t1), padded to a multiple of BLOCK_RAYS, so each program's loads are
  coalesced;
- the (9, T) triangle table [v0 | e1 | e2] is read with scalar loads that
  every thread of a program shares; at the table sizes this path serves
  (a few thousand triangles) it stays resident in L1/L2.

The kernel goes through Pallas's Triton route (`backend="triton"`), named
explicitly. It compiles only for the GPU; elsewhere it runs with
`interpret=True` (tests) or raises.

Accept test and strict-less-than closest update reproduce the reference
semantics, so ties resolve to the lowest face index.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from pyrenderer_tpu.kernels import vma

BLOCK_RAYS = 128      # rays per program: one per thread of 4 warps
NUM_WARPS = 4
UNROLL = 4            # triangles per loop iteration; the table is padded to it
MISS_T = 3.0e38


def check_platform(interpret: bool) -> None:
    """The kernel compiles for the GPU only: refuse anything else unless
    the caller asked for the Pallas interpreter."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "backend='pallas' compiles for the GPU only; this process runs "
            f"on '{jax.default_backend()}'. Use backend='auto' or 'brute', "
            "or pass interpret=True to run the kernel in the interpreter."
        )


def pack_triangles(vertices, faces):
    """(9, T) float32 triangle table [v0 | e1 | e2], one column per face."""
    v0 = vertices[faces[:, 0]]
    e1 = vertices[faces[:, 1]] - v0
    e2 = vertices[faces[:, 2]] - v0
    return jnp.concatenate([v0.T, e1.T, e2.T], axis=0).astype(jnp.float32)


def _mt_test(tri, ti, o, d, t0, t1):
    """Möller–Trumbore for triangle `ti` against the program's rays.

    Same operation order as core/intersect._mt_terms. Returns (ok, t),
    where ok also requires t0 < t < t1."""
    v0x, v0y, v0z = tri[0, ti], tri[1, ti], tri[2, ti]
    e1x, e1y, e1z = tri[3, ti], tri[4, ti], tri[5, ti]
    e2x, e2y, e2z = tri[6, ti], tri[7, ti], tri[8, ti]
    ox, oy, oz = o
    dx, dy, dz = d

    # c = cross(e1, d)
    cx = e1y * dz - e1z * dy
    cy = e1z * dx - e1x * dz
    cz = e1x * dy - e1y * dx
    det = cx * e2x + cy * e2y + cz * e2z
    inv = 1.0 / jnp.where(det == 0, 1.0, det)

    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    # q = cross(s, e2)
    qx = sy * e2z - sz * e2y
    qy = sz * e2x - sx * e2z
    qz = sx * e2y - sy * e2x

    t = -inv * (qx * e1x + qy * e1y + qz * e1z)
    u = -inv * (qx * dx + qy * dy + qz * dz)
    v = inv * (cx * sx + cy * sy + cz * sz)

    ok = (
        (jnp.abs(det) > 0)
        & (t > t0)
        & (t < t1)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (1.0 - u - v >= 0.0)
    )
    return ok, t


def _closest_kernel(n_groups, t0, tri, ox, oy, oz, dx, dy, dz, t1,
                    t_out, tri_out):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    t1v = t1[...]

    def group(g, carry):
        t_best, tri_best = carry
        for k in range(UNROLL):
            ti = g * UNROLL + k
            ok, t = _mt_test(tri, ti, o, d, t0, t1v)
            # strict less-than: ties keep the lower face index
            better = ok & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            tri_best = jnp.where(better, ti, tri_best)
        return t_best, tri_best

    # constant initial carries (not loaded from a ref): the interpreter
    # then types the loop the same way inside a check_vma shard_map
    init = (jnp.full(t1v.shape, MISS_T, jnp.float32),
            jnp.full(t1v.shape, -1, jnp.int32))
    t_best, tri_best = jax.lax.fori_loop(0, n_groups, group, init)
    t_out[...] = t_best
    tri_out[...] = tri_best


def _anyhit_kernel(n_groups, t0, tri, ox, oy, oz, dx, dy, dz, t1, hit_out):
    o = (ox[...], oy[...], oz[...])
    d = (dx[...], dy[...], dz[...])
    t1v = t1[...]

    def cond(carry):
        g, hit = carry
        # rays with an empty interval (dead lanes, padding) can never be
        # occluded: count them as settled so the block can stop early. A
        # min over int32, since Triton has no boolean all-reduce. (Kept
        # inside the loop: the interpreter types loop bodies consistently
        # under a check_vma shard_map, top-level mixed operands not.)
        settled = hit | (t1v <= t0)
        return (g < n_groups) & (jnp.min(settled.astype(jnp.int32)) == 0)

    def body(carry):
        g, hit = carry
        for k in range(UNROLL):
            ok, _ = _mt_test(tri, g * UNROLL + k, o, d, t0, t1v)
            hit = hit | ok
        return g + 1, hit

    _, hit = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros(t1v.shape, jnp.bool_)))
    hit_out[...] = hit.astype(jnp.int32)


def _pad_table(tri_table):
    """Pad the table to a multiple of UNROLL with all-zero columns: e1 =
    e2 = 0 gives det == 0, which the accept test rejects."""
    pad = -tri_table.shape[1] % UNROLL
    return jnp.pad(tri_table, ((0, 0), (0, pad))) if pad else tri_table


def _ray_planes(ro, rd, t1):
    """(N, 3) rays and scalar or (N,) t1 -> seven padded (M,) vectors, M a
    multiple of BLOCK_RAYS. Padded lanes get t1 = 0 and never hit."""
    n = ro.shape[0]
    m = pl.cdiv(n, BLOCK_RAYS) * BLOCK_RAYS
    t1 = jnp.broadcast_to(jnp.asarray(t1, jnp.float32), (n,))
    cols = [ro[:, 0], ro[:, 1], ro[:, 2], rd[:, 0], rd[:, 1], rd[:, 2]]
    cols = [c.astype(jnp.float32) for c in cols] + [t1]
    if m != n:
        cols = [jnp.pad(c, (0, m - n)) for c in cols]
    return cols, n, m


def _call(kernel, name, tri_table, planes, m, out_dtypes, interpret):
    block = pl.BlockSpec((BLOCK_RAYS,), lambda i: (i,))
    # shard_map(check_vma) support: outputs inherit the rays' varying axes
    # (kernels/vma.py); the replicated table needs no cast
    v = vma.args_vma(*planes)
    return pl.pallas_call(
        kernel,
        out_shape=[vma.struct((m,), dt, v) for dt in out_dtypes],
        grid=(m // BLOCK_RAYS,),
        # the whole table, unblocked: the kernel reads it by scalar index
        in_specs=[pl.no_block_spec] + [block] * len(planes),
        out_specs=[block] * len(out_dtypes),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name=name,
    )(tri_table, *planes)


@partial(jax.jit, static_argnames=("t0", "interpret"))
def _closest(tri_table, ro, rd, t1, t0, interpret):
    tri_table = _pad_table(tri_table)
    planes, n, m = _ray_planes(ro, rd, t1)
    kernel = partial(_closest_kernel, tri_table.shape[1] // UNROLL, t0)
    t_best, tri_best = _call(kernel, "whole_table_closest_hit", tri_table,
                             planes, m, (jnp.float32, jnp.int32), interpret)
    tri = tri_best[:n]
    hit = tri >= 0
    return hit, jnp.where(hit, t_best[:n], 0.0), tri


@partial(jax.jit, static_argnames=("t0", "interpret"))
def _occluded(tri_table, ro, rd, t1, t0, interpret):
    tri_table = _pad_table(tri_table)
    planes, n, m = _ray_planes(ro, rd, t1)
    kernel = partial(_anyhit_kernel, tri_table.shape[1] // UNROLL, t0)
    (hit,) = _call(kernel, "whole_table_any_hit", tri_table, planes, m,
                   (jnp.int32,), interpret)
    return hit[:n] > 0


def closest_hit(tri_table, ro, rd, t0, t1, interpret=False):
    """Wavefront closest hit: ro, rd (N, 3); t1 scalar or (N,).

    Returns (hit (N,) bool, t (N,) f32, tri (N,) int32) matching
    core/intersect.py's contract. The selection is discrete: callers
    re-evaluate hit geometry differentiably (the integrator does), so the
    inputs are detached here. pallas_call has no autodiff rule, and without
    the stop_gradient a grad through the integrator would fail as soon as
    rays that carry tangents (bounce > 0) reach the kernel.
    """
    check_platform(interpret)
    ro, rd, t1 = jax.lax.stop_gradient((ro, rd, t1))
    return _closest(jax.lax.stop_gradient(tri_table), ro, rd, t1,
                    t0=float(t0), interpret=interpret)


def occluded(tri_table, ro, rd, t0, t1, interpret=False):
    """Any-hit shadow query (t1 per ray or scalar); no closest-hit update,
    and a block stops as soon as all its rays are occluded. Inputs are
    detached (see closest_hit)."""
    check_platform(interpret)
    ro, rd, t1 = jax.lax.stop_gradient((ro, rd, t1))
    return _occluded(jax.lax.stop_gradient(tri_table), ro, rd, t1,
                     t0=float(t0), interpret=interpret)
