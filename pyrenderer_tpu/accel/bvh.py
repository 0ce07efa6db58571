"""LBVH accelerator: Morton-ordered build + stackless escape-pointer layout.

Re-designs the reference's two BVHs for flat arrays:
  - build: Morton-code sort + median split over the sorted order (the
    reference's Taichi BVH did median splits with NO spatial sort —
    reference accelerators/bvh_taichi.py:81-86, its sort_obj_list dead at
    :24 — so any split quality here is an upgrade; its CPU SAH builder
    bvh.py:70-106 is object-level only);
  - layout: flattened pre-order nodes with escape ("next") pointers exactly
    in the spirit of bvh_taichi.py:93-104/:142-160, as parallel arrays;
  - traversal: stackless while-loop per ray (reference
    intersection_taichi.py:256-287), vmapped; slab AABB test with the PBRT
    conservative gamma widening (reference bvh_taichi.py:169-190 `t_far *=
    1 + 2*gamma(3)`; mathematics/bbox.py:6-26).

Build runs on host NumPy at scene-load time (it is part of scene I/O, like
the reference's World.commit); traversal is JAX. Small scenes take the
whole-table path instead (no divergence, the table stays in cache);
core/integrator.py resolve_backend picks this path past AUTO_BRUTE_MAX_TRIS
when a FlatBVH was prebuilt, and render_image / ProgressiveRenderer build
one automatically (core/integrator.py maybe_build_accel).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# float32 machine-epsilon-based conservative bound, PBRT gamma(3)
# (reference mathematics/constants.py:14-16)
_MACHINE_EPS = np.float32(np.finfo(np.float32).eps * 0.5)
GAMMA2_3 = float(2.0 * (3.0 * _MACHINE_EPS) / (1.0 - 3.0 * _MACHINE_EPS))

DEFAULT_LEAF_SIZE = 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlatBVH:
    """Parallel node arrays, pre-order. Inner node's first child is node+1;
    `escape` is where to go on a miss (or after a leaf); -1 terminates.
    `leaf_size` is static metadata (python-loop bound under jit)."""

    bbox_min: jnp.ndarray    # (M, 3) f32
    bbox_max: jnp.ndarray    # (M, 3) f32
    first: jnp.ndarray       # (M,) i32 — first tri in `order` (leaves), -1 inner
    count: jnp.ndarray       # (M,) i32 — leaf tri count, 0 for inner
    escape: jnp.ndarray      # (M,) i32
    order: jnp.ndarray       # (T,) i32 — traversal position -> original face id
    leaf_size: int = dataclasses.field(metadata=dict(static=True), default=4)

    @property
    def n_nodes(self) -> int:
        return self.bbox_min.shape[0]


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: (T, 3) in [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint32), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint32(0x030000FF)
        v = (v | (v << 8)) & np.uint32(0x0300F00F)
        v = (v | (v << 4)) & np.uint32(0x030C30C3)
        v = (v | (v << 2)) & np.uint32(0x09249249)
        return v

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_bvh(
    vertices, faces, leaf_size: int = DEFAULT_LEAF_SIZE, method: str = "auto"
) -> FlatBVH:
    """Host-side build dispatch.

    method: "sah" (native C++ 12-bucket SAH, pyrenderer_tpu/native/),
    "lbvh" (Python Morton median-split), or "auto" (SAH when the native
    library compiles, else LBVH).
    """
    if method in ("auto", "sah"):
        from pyrenderer_tpu import native

        v = np.asarray(vertices, np.float64)
        f = np.asarray(faces, np.int64)
        tri = v[f]
        out = native.build_sah_bvh_native(
            tri.min(axis=1).astype(np.float32),
            tri.max(axis=1).astype(np.float32),
            leaf_size,
        )
        if out is not None:
            return FlatBVH(
                bbox_min=jnp.asarray(out["bbox_min"]),
                bbox_max=jnp.asarray(out["bbox_max"]),
                first=jnp.asarray(out["first"]),
                count=jnp.asarray(out["count"]),
                escape=jnp.asarray(out["escape"]),
                order=jnp.asarray(out["order"]),
                leaf_size=leaf_size,
            )
        if method == "sah":
            raise RuntimeError("native SAH builder unavailable (g++ failed)")
    return build_lbvh(vertices, faces, leaf_size)


def build_lbvh(vertices, faces, leaf_size: int = DEFAULT_LEAF_SIZE) -> FlatBVH:
    """Host-side build. vertices (V, 3), faces (T, 3) — NumPy or device."""
    vertices = np.asarray(vertices, np.float64)
    faces = np.asarray(faces, np.int64)
    tri = vertices[faces]                       # (T, 3, 3)
    tri_min = tri.min(axis=1)
    tri_max = tri.max(axis=1)
    centroids = 0.5 * (tri_min + tri_max)
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    codes = _morton3((centroids - lo) / span)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    t = faces.shape[0]
    max_nodes = 4 * t + 1
    bmin = np.empty((max_nodes, 3), np.float32)
    bmax = np.empty((max_nodes, 3), np.float32)
    first = np.full(max_nodes, -1, np.int32)
    count = np.zeros(max_nodes, np.int32)
    escape = np.full(max_nodes, -1, np.int32)
    n_nodes = 0

    def alloc():
        nonlocal n_nodes
        n_nodes += 1
        return n_nodes - 1

    # iterative pre-order build (ranges over the morton-sorted tri order)
    stack = [(0, t, -1)]  # (lo, hi, escape)
    while stack:
        lo_i, hi_i, esc = stack.pop()
        idx = alloc()
        ids = order[lo_i:hi_i]
        bmin[idx] = tri_min[ids].min(axis=0)
        bmax[idx] = tri_max[ids].max(axis=0)
        escape[idx] = esc
        if hi_i - lo_i <= leaf_size:
            first[idx] = lo_i
            count[idx] = hi_i - lo_i
        else:
            mid = (lo_i + hi_i) // 2
            # pre-order: left = idx+1 (pushed last, popped first); left's
            # escape is the right child, whose index is idx+1+size(left).
            left_size = _subtree_size(mid - lo_i, leaf_size)
            right_idx = idx + 1 + left_size
            stack.append((mid, hi_i, esc))          # right
            stack.append((lo_i, mid, right_idx))    # left
    assert n_nodes <= max_nodes
    return FlatBVH(
        bbox_min=jnp.asarray(bmin[:n_nodes]),
        bbox_max=jnp.asarray(bmax[:n_nodes]),
        first=jnp.asarray(first[:n_nodes]),
        count=jnp.asarray(count[:n_nodes]),
        escape=jnp.asarray(escape[:n_nodes]),
        order=jnp.asarray(order),
        leaf_size=leaf_size,
    )


def _subtree_size(n_tris: int, leaf_size: int) -> int:
    """Node count of the deterministic median-split subtree over n_tris."""
    if n_tris <= leaf_size:
        return 1
    mid = n_tris // 2
    return 1 + _subtree_size(mid, leaf_size) + _subtree_size(n_tris - mid, leaf_size)


def _slab_hit(bmin, bmax, ro, inv_d, t0, t1):
    """Conservative slab test (reference bvh_taichi.py:169-190)."""
    lo = (bmin - ro) * inv_d
    hi = (bmax - ro) * inv_d
    t_near = jnp.minimum(lo, hi)
    t_far = jnp.maximum(lo, hi) * (1.0 + GAMMA2_3)
    tmin = jnp.maximum(jnp.max(t_near), t0)
    tmax = jnp.minimum(jnp.min(t_far), t1)
    return tmin <= tmax


def traverse(bvh: FlatBVH, tri_v0, tri_e1, tri_e2, ro, rd, t0, t1, any_hit=False):
    """Stackless closest-hit (or any-hit) traversal, vmapped over rays.

    tri_v0/e1/e2: (T, 3) in TRAVERSAL order (already permuted by bvh.order).
    ro, rd: (N, 3); t1 scalar or (N,). Returns (hit, t, tri_orig).
    """
    leaf_size = bvh.leaf_size
    t1v = jnp.broadcast_to(t1, ro.shape[:1]).astype(ro.dtype)

    def one_ray(o, d, t_limit):
        inv_d = 1.0 / jnp.where(d == 0, 1e-20, d)

        def cond(state):
            cur, t_best, tri_best, done = state
            return (cur >= 0) & (~done)

        def body(state):
            cur, t_best, tri_best, done = state
            is_leaf = bvh.count[cur] > 0
            hit_box = _slab_hit(
                bvh.bbox_min[cur], bvh.bbox_max[cur], o, inv_d,
                t0, jnp.minimum(t_best, t_limit),
            )

            # leaf: test up to leaf_size triangles (masked)
            def leaf_tests(carry):
                t_best, tri_best = carry
                base = bvh.first[cur]
                for i in range(leaf_size):
                    ti = base + i
                    valid = (i < bvh.count[cur])
                    tj = jnp.clip(ti, 0, tri_v0.shape[0] - 1)
                    v0, e1, e2 = tri_v0[tj], tri_e1[tj], tri_e2[tj]
                    c_e1_d = jnp.cross(e1, d)
                    det = jnp.sum(c_e1_d * e2)
                    inv = 1.0 / jnp.where(det == 0, 1.0, det)
                    s = o - v0
                    c_s_e2 = jnp.cross(s, e2)
                    tt = -inv * jnp.sum(c_s_e2 * e1)
                    uu = -inv * jnp.sum(c_s_e2 * d)
                    vv = inv * jnp.sum(c_e1_d * s)
                    ok = (
                        valid
                        & (jnp.abs(det) > 0)
                        & (tt > t0)
                        & (tt < jnp.minimum(t_best, t_limit))
                        & (uu >= 0) & (uu <= 1) & (vv >= 0) & (1 - uu - vv >= 0)
                    )
                    t_best = jnp.where(ok, tt, t_best)
                    tri_best = jnp.where(ok, tj, tri_best)
                return t_best, tri_best

            # a select, not lax.cond: under vmap a batched cond becomes a
            # select anyway, and a select keeps shard_map's varying-axes
            # typing (check_vma) consistent between the two branches
            do_leaf = is_leaf & hit_box
            t_leaf, tri_leaf = leaf_tests((t_best, tri_best))
            t_best = jnp.where(do_leaf, t_leaf, t_best)
            tri_best = jnp.where(do_leaf, tri_leaf, tri_best)
            # next node: into child if inner box hit, else escape
            cur = jnp.where(hit_box & (~is_leaf), cur + 1, bvh.escape[cur])
            done = done | (any_hit & (tri_best >= 0))
            return cur, t_best, tri_best, done

        # carries derive from the ray (not fresh constants) so that under
        # shard_map they inherit the ray's mesh-varying type
        zero = o[0] * 0
        izero = zero.astype(jnp.int32)
        init = (izero, zero + jnp.inf, izero - 1, zero != 0)
        cur, t_best, tri_best, _ = jax.lax.while_loop(cond, body, init)
        return t_best, tri_best

    t_best, tri_best = jax.vmap(one_ray)(ro, rd, t1v)
    hit = tri_best >= 0
    tri_orig = jnp.where(hit, bvh.order[jnp.maximum(tri_best, 0)], 0)
    return hit, jnp.where(hit, t_best, 0.0), tri_orig.astype(jnp.int32)
