"""Geometry (triangle) sharding over the "gp" mesh axis — dist/geometry.py.

The sharded closest-hit min-combine and masked-psum shading fetches are
exact (no sum reassociation in the combines themselves), but end-to-end
compilation may fuse differently than the single-device render, so the
comparisons use tight-but-nonzero tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core.integrator import TraceTables, render_sample
from pyrenderer_tpu.dist.geometry import (
    make_geom_mesh,
    render_field_geometry_sharded,
    train_step_geometry,
)
from pyrenderer_tpu.scene import load_tungsten


import os

_CORNELL = os.path.join(os.path.dirname(__file__), "data", "cornell_box.json")


@pytest.fixture(scope="module")
def cornell():
    scene, camera, cfg = load_tungsten(_CORNELL, dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, scene)
    camera = camera._replace(resolution=(16, 16))
    return scene, camera, cfg


def _pixels(camera, n=64):
    w, h = camera.resolution
    idx = np.arange(n) * 3 % (w * h)
    return (jnp.asarray(idx % w, jnp.int32), jnp.asarray(idx // w, jnp.int32))


def _reference_render(scene, camera, cfg, px, py):
    tables = TraceTables(scene, cfg, "brute")
    out = 0.0
    for s in range(cfg.spp):
        out = out + render_sample(
            scene, camera, cfg, cfg.seed, jnp.uint32(s), px, py, tables=tables
        )
    return out / cfg.spp


@pytest.mark.parametrize("dp,gp", [(1, 8), (2, 4)])
def test_geometry_sharded_matches_single_device(cornell, dp, gp):
    scene, camera, cfg = cornell
    cfg = cfg.replace(max_bounces=3, spp=2, seed=5)
    px, py = _pixels(camera)
    mesh = make_geom_mesh(8, gp=gp, dp=dp)
    got = render_field_geometry_sharded(scene, camera, cfg, mesh, px, py)
    want = _reference_render(scene, camera, cfg, px, py)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-6)


def test_geometry_sharded_pbrt_estimator(cornell):
    scene, camera, cfg = cornell
    cfg = cfg.replace(max_bounces=3, spp=2, seed=1, estimator="pbrt")
    px, py = _pixels(camera)
    mesh = make_geom_mesh(8, gp=4, dp=2)
    got = render_field_geometry_sharded(scene, camera, cfg, mesh, px, py)
    want = _reference_render(scene, camera, cfg, px, py)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5, atol=2e-6)


def test_geometry_sharded_gradients_match(cornell):
    """Scene-parameter grads through the sharded render == unsharded grads
    (the masked-psum transpose must reassemble the dense gradient)."""
    scene, camera, cfg = cornell
    cfg = cfg.replace(max_bounces=2, spp=1, seed=3)
    px, py = _pixels(camera, n=32)
    mesh = make_geom_mesh(8, gp=4, dp=2)
    target = jnp.zeros((px.shape[0], 3), jnp.float32)

    def loss_sharded(params):
        v, a, e = params
        s = scene._replace(vertices=v, albedo=a, emission=e)
        img = render_field_geometry_sharded(s, camera, cfg, mesh, px, py)
        return jnp.mean((img - target) ** 2)

    def loss_single(params):
        v, a, e = params
        s = scene._replace(vertices=v, albedo=a, emission=e)
        img = _reference_render(s, camera, cfg, px, py)
        return jnp.mean((img - target) ** 2)

    params = (scene.vertices, scene.albedo, scene.emission)
    g_sharded = jax.grad(loss_sharded)(params)
    g_single = jax.grad(loss_single)(params)
    for gs, g1 in zip(g_sharded, g_single):
        assert bool(jnp.all(jnp.isfinite(gs)))
        np.testing.assert_allclose(
            np.asarray(gs), np.asarray(g1), rtol=5e-4, atol=1e-7
        )


def test_train_step_geometry_runs(cornell):
    scene, camera, cfg = cornell
    cfg = cfg.replace(max_bounces=2, spp=2, seed=0)
    px, py = _pixels(camera, n=32)
    mesh = make_geom_mesh(8, gp=8, dp=1)
    target = jnp.zeros((px.shape[0], 3), jnp.float32)
    params = (scene.vertices, scene.albedo, scene.emission)
    loss, new_params = train_step_geometry(
        params, scene, camera, cfg, mesh, target, px, py, jnp.float32(1e-3)
    )
    assert np.isfinite(float(loss)) and float(loss) > 0
    for p, q in zip(params, new_params):
        assert q.shape == p.shape
        assert bool(jnp.all(jnp.isfinite(q)))
