"""Geometry sharding: triangles partitioned over a "gp" mesh axis.

This is the renderer's scene-size scaling axis (SURVEY §5.7): rays stay
put, each device holds only ITS shard of the triangle set, and the global
closest hit is a cross-device min-reduction. The reference has no
analog — its whole scene lives on the one device (Taichi fields,
intersection_taichi.py:189 World) — so this is a pure north-star addition.

Mechanism per bounce (all inside one shard_map body, so XLA overlaps the
collectives with the next chunk's compute):
  1. every device runs closest-hit against its local (T/gp)-triangle shard;
  2. per-ray local best-t is `all_gather`-ed over "gp" (one f32/ray per
     device) and argmin-ed — the winning device is unique per ray;
  3. the winner contributes the global face id and, later, the packed
     (N, K=16/24) shading rows, via masked `psum` (everyone else sends
     exact zeros) — so each bounce also carries one K-float row per ray
     over the "gp" axis, not just the scalar t;
  4. NEE shadow rays reduce with a boolean-or `psum`.

Hit selection is detached in the integrator (core/integrator.py), so the
collectives only carry primal data; gradients w.r.t. the face-table shards
flow through the masked psum's transpose and land on the owning device's
shard — then back to (vertices, albedo, emission) through the host-side
pack, exactly mirroring the single-device autodiff path.

Pixels shard over "dp" simultaneously: the mesh is ("dp", "gp").
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core import intersect as isect
from pyrenderer_tpu.core.camera import generate_rays
from pyrenderer_tpu.core.integrator import (
    TraceTables,
    default_backend,
    pack_face_data,
    pack_light_data,
    trace_reference,
)
from pyrenderer_tpu.kernels import pallas_intersect as pk
from pyrenderer_tpu.scene.types import Camera, Scene

sg = jax.lax.stop_gradient


def make_geom_mesh(n_devices: int | None = None, gp: int | None = None,
                   dp: int | None = None) -> Mesh:
    """Build a ("dp", "gp") mesh: pixel tiles x triangle shards."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if gp is None and dp is None:
        dp, gp = 1, n
    elif gp is None:
        gp = n // dp
    elif dp is None:
        dp = n // gp
    assert dp * gp == n, f"dp*gp must equal device count ({dp}*{gp} != {n})"
    # all-to-all links: a plain reshape of the device list (dist/render.py)
    return Mesh(np.asarray(devices[:n]).reshape(dp, gp), ("dp", "gp"))


def _pad_to(x, rows):
    pad = rows - x.shape[0]
    if pad == 0:
        return x
    return jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


def shard_geometry(scene: Scene, cfg: RenderConfig, gp: int):
    """Host-side shard prep: (gp, T/gp, ...) stacked triangle + face tables.

    Padding rows are all-zero: e1 = e2 = 0 makes the Möller–Trumbore det 0,
    which the accept test rejects, so pads can never win a hit.
    Returns (tri_shards (v0, e1, e2), face_data_shards, light_data).
    """
    extended = cfg.estimator != "reference"
    face_data = pack_face_data(scene, extended=extended)
    light_data = pack_light_data(scene, use_emission=extended)

    v = sg(scene.vertices)  # hit selection is detached; grads ride face_data
    f = scene.faces
    v0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - v0
    e2 = v[f[:, 2]] - v0

    t = f.shape[0]
    t_local = (t + gp - 1) // gp
    rows = t_local * gp
    shard = lambda x: _pad_to(x, rows).reshape(gp, t_local, *x.shape[1:])
    return (shard(v0), shard(e1), shard(e2)), shard(face_data), light_data


def _strip_scene(scene: Scene) -> Scene:
    """Keep only the light metadata the integrator reads from `scene` when
    every geometry access goes through custom hooks — so the replicated
    per-device footprint stays O(lights), not O(triangles)."""
    z3 = jnp.zeros((1, 3), scene.vertices.dtype)
    return scene._replace(
        vertices=z3,
        faces=jnp.zeros((1, 3), jnp.int32),
        normal_sign=jnp.zeros((1,), scene.normal_sign.dtype),
        face_material=jnp.zeros((1,), jnp.int32),
    )


def render_field_geometry_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    pixel_x,
    pixel_y,
):
    """Mean radiance (N, 3) with triangles sharded over "gp" and pixels over
    "dp". Numerically identical to the single-device render (the min/argmin
    combine and masked psums are exact — no reassociation of sums).

    Each device intersects its own shard with the platform's whole-table
    path (core.integrator.default_backend: the Pallas kernel on the GPU,
    the broadcast XLA path elsewhere), O(T_local) per ray.
    """
    gp = mesh.shape["gp"]
    tri_shards, face_shards, light_data = shard_geometry(scene, cfg, gp)
    use_kernel = default_backend() == "pallas"
    t_local = face_shards.shape[1]
    scene_l = _strip_scene(scene)
    strata = int(math.ceil(math.sqrt(cfg.spp))) if cfg.stratified else 0
    w = camera.resolution[0]
    big = jnp.asarray(jnp.inf, scene.vertices.dtype)

    dp = mesh.shape["dp"]
    n_rays_total = pixel_x.shape[0]
    assert n_rays_total % (dp * gp) == 0, (
        f"pixel count {n_rays_total} must divide over dp*gp = {dp * gp}"
    )

    in_specs = (P(), P(), P("dp"), P("dp"),
                P("gp"), P("gp"), P("gp"), P("gp"), P())

    # Every gp device computes the identical (N/dp, 3) block (the hit
    # combine is a psum), so each device RETURNS its own gp-slice of the
    # rows and the out spec reassembles them. Exact: pure data movement,
    # no math. check_vma on: the bounce-scan carries enter gp-varying
    # (rays promoted below via pcast) and psum-combined body outputs
    # are re-promoted to match (integrator_pbrt._match_vma), so the
    # static varying-axes checker types the whole body; the parity
    # tests (tests/test_dist_geometry.py) also verify replication
    # dynamically.
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(("dp", "gp")),
        check_vma=True,
    )
    def shard_render(scene_l, camera, px, py, v0s, e1s, e2s, fds, light_data):
        v0l, e1l, e2l, fdl = v0s[0], e1s[0], e2s[0], fds[0]
        base = jax.lax.axis_index("gp").astype(jnp.int32) * t_local

        if use_kernel:
            tri_l = jnp.concatenate([v0l.T, e1l.T, e2l.T], axis=0)

            def local_closest(ro, rd, t1):
                return pk.closest_hit(tri_l, ro, rd, cfg.t_min, t1)

            def local_occluded(ro, rd, t1):
                return pk.occluded(tri_l, ro, rd, cfg.t_min, t1)
        else:
            def local_closest(ro, rd, t1):
                return isect.intersect_brute_arrays(
                    v0l, e1l, e2l, ro, rd, cfg.t_min, t1
                )

            def local_occluded(ro, rd, t1):
                return isect.occluded_arrays(
                    v0l, e1l, e2l, ro, rd, cfg.t_min, t1
                )

        def closest(ro, rd, t1):
            hit_l, t_l, tri_l = local_closest(ro, rd, t1)
            t_m = jnp.where(hit_l, t_l.astype(big.dtype), big)
            t_all = jax.lax.all_gather(t_m, "gp")          # (gp, N) — tiny
            winner = jnp.argmin(t_all, axis=0)             # unique per ray
            t_min = jnp.min(t_all, axis=0)
            mine = (winner == jax.lax.axis_index("gp")) & hit_l
            tri_g = jax.lax.psum(
                jnp.where(mine, tri_l + base, 0).astype(jnp.int32), "gp"
            )
            hit_g = jnp.isfinite(t_min)
            return hit_g, jnp.where(hit_g, t_min, 0.0), tri_g

        def any_hit(ro, rd, t1):
            occ_l = local_occluded(ro, rd, t1)
            return jax.lax.psum(occ_l.astype(jnp.int32), "gp") > 0

        def fetch_face(tri_g):
            mine = (tri_g >= base) & (tri_g < base + t_local)
            idx = jnp.clip(tri_g - base, 0, t_local - 1)
            row = jnp.take(fdl, idx, axis=0)
            return jax.lax.psum(jnp.where(mine[:, None], row, 0.0), "gp")

        tables = TraceTables.custom(fdl, light_data, closest, any_hit, fetch_face)
        pixel_id = (py * w + px).astype(jnp.uint32)

        def one_sample(s):
            sample = jnp.full_like(pixel_id, s)
            ro, rd = generate_rays(camera, px, py, sample, cfg.seed, strata=strata)
            # primary rays are gp-invariant (every gp device traces the same
            # wavefront); the bounce step's outputs are typed gp-varying
            # (they flow through gp-sharded triangle tables before the exact
            # psum/all_gather combines), so promote the scan's init to match
            # — this is what lets check_vma=True typecheck the body
            ro, rd = jax.lax.pcast((ro, rd), ("gp",), to="varying")
            if cfg.estimator == "reference":
                return trace_reference(
                    scene_l, cfg, ro, rd, pixel_id, sample, cfg.seed, tables=tables
                )
            from pyrenderer_tpu.core.integrator_pbrt import trace_pbrt

            return trace_pbrt(
                scene_l, cfg, ro, rd, pixel_id, sample, cfg.seed, tables=tables
            )

        local = jax.lax.map(one_sample, jnp.arange(cfg.spp, dtype=jnp.uint32)).sum(0)
        local = local / cfg.spp
        chunk = local.shape[0] // gp
        gp_idx = jax.lax.axis_index("gp")
        return jax.lax.dynamic_slice_in_dim(local, gp_idx * chunk, chunk)

    return shard_render(scene_l, camera, pixel_x, pixel_y, *tri_shards,
                        face_shards, light_data)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def train_step_geometry(
    params,
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    target,
    pixel_x,
    pixel_y,
    lr,
):
    """Inverse-rendering step with the scene geometry sharded over "gp".

    Gradients w.r.t. the face-table shards arrive on their owning devices
    (psum transpose) and are re-assembled into dense (vertices, albedo,
    emission) grads by the host-side shard pack's transpose.
    """

    def loss_fn(params):
        vertices, albedo, emission = params
        s = scene._replace(vertices=vertices, albedo=albedo, emission=emission)
        img = render_field_geometry_sharded(s, camera, cfg, mesh, pixel_x,
                                            pixel_y)
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = tuple(p - lr * g for p, g in zip(params, grads))
    return loss, new_params
