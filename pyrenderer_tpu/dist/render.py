"""Multi-chip rendering: pixel-tile x spp sharding over a device mesh.

The reference's only parallelism is joblib process fan-out over pixels
(reference main.py:51-53) and a Taichi per-pixel parallel-for
(main_taichi.py:89); there is no cross-device machinery at all (SURVEY
§2.2). Here the device-mesh equivalents:

- mesh axes ("dp", "sp"): pixel tiles shard over "dp", samples-per-pixel
  shard over "sp". Radiance accumulation is associative, so spp sharding is
  one `psum` per frame (the collective analog of the reference's
  progressive `pixels += color` accumulation, main_taichi.py:98-99).
- the inverse-rendering training step differentiates straight through the
  `shard_map`; scene-parameter gradients all-reduce automatically (the
  psum transpose), which is the gradient path BASELINE's north star
  describes.

The cards of one host are joined all to all (NVLink), so the mesh is a
plain reshape of the device list: no axis order is cheaper than another.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core.integrator import TraceTables, render_sample
from pyrenderer_tpu.scene.types import Camera, Scene


def make_mesh(n_devices: int | None = None, dp: int | None = None, sp: int | None = None) -> Mesh:
    """Build a (dp, sp) mesh. Defaults: all devices on dp, sp=1."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    assert dp * sp == n, f"dp*sp must equal device count ({dp}*{sp} != {n})"
    return Mesh(np.asarray(devices[:n]).reshape(dp, sp), ("dp", "sp"))


def render_field_sharded(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    pixel_x,
    pixel_y,
    accel=None,
):
    """Mean radiance (N, 3) for the given pixels, sharded (dp: pixels,
    sp: spp). The scene is replicated (it is small next to the ray state);
    for huge scenes see dist/geometry.py's "gp" triangle sharding.

    `accel` (optional): a prebuilt accelerator (FlatBVH from
    core.integrator.maybe_build_accel) — replicated over the mesh like the
    scene, so LARGE scenes run the accelerated traversal inside the
    shard_map instead of silently falling back to the O(T) whole-table
    path. Build it on host arrays BEFORE any jit (topology can't be
    traced); pass it through train_step's `accel` argument.
    """
    sp_size = mesh.shape["sp"]
    assert cfg.spp % sp_size == 0, "spp must divide over the sp mesh axis"
    local_spp = cfg.spp // sp_size
    from pyrenderer_tpu.core.integrator import resolve_backend

    backend = resolve_backend("auto", scene.faces.shape[0], accel)

    def body(scene, camera, px, py, accel):
        sp_idx = jax.lax.axis_index("sp")
        tables = TraceTables(scene, cfg, backend, accel=accel)

        def one_sample(s):
            sample_id = (sp_idx * local_spp + s).astype(jnp.uint32)
            return render_sample(
                scene, camera, cfg, cfg.seed, sample_id, px, py, tables=tables
            )

        local = jax.lax.map(one_sample, jnp.arange(local_spp, dtype=jnp.uint32)).sum(0)
        return jax.lax.psum(local, "sp") / cfg.spp

    if accel is None:
        shard_render = partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P("dp"), P("dp")),
            out_specs=P("dp"),
        )(lambda scene, camera, px, py: body(scene, camera, px, py, None))
        return shard_render(scene, camera, pixel_x, pixel_y)
    shard_render = partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("dp"), P("dp"), P()),
        out_specs=P("dp"),
    )(body)
    return shard_render(scene, camera, pixel_x, pixel_y, accel)


def pixel_grid(camera: Camera):
    """All pixel coords (x right, y up-from-bottom), flattened row-major."""
    w, h = camera.resolution
    ys, xs = jnp.mgrid[0:h, 0:w]
    return xs.reshape(-1).astype(jnp.int32), ys.reshape(-1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def train_step(
    params: Tuple,
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    target,
    pixel_x,
    pixel_y,
    lr,
    accel=None,
):
    """One inverse-rendering step: render -> L2 loss vs target -> SGD on
    (vertices, albedo, emission). Differentiates through the shard_map;
    parameter grads all-reduce via the psum transpose.

    params: (vertices, albedo, emission); target: (N, 3) radiance.
    lr: scalar, or a (lr_vertices, lr_albedo, lr_emission) tuple to give
    each parameter family its own step size (0 freezes it — e.g. albedo-
    only recovery in examples/invrender.py).
    accel: optional prebuilt accelerator for large scenes (replicated; see
    render_field_sharded). Hit selection is detached, so a fixed accel
    built from the CURRENT vertices stays a valid traversal oracle for the
    small vertex perturbations of a training step.
    Returns (loss, new_params).
    """

    def loss_fn(params):
        vertices, albedo, emission = params
        s = scene._replace(vertices=vertices, albedo=albedo, emission=emission)
        img = render_field_sharded(s, camera, cfg, mesh, pixel_x, pixel_y,
                                   accel=accel)
        return jnp.mean((img - target) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    lrs = lr if isinstance(lr, tuple) else (lr, lr, lr)
    new_params = tuple(p - l * g for p, l, g in zip(params, lrs, grads))
    return loss, new_params
