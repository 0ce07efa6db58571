"""BASELINE config 3: full BSDF set + MIS NEE + russian roulette ("pbrt" mode)."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core.integrator import render_image
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.tungsten import build_scene


CFG = RenderConfig(
    max_bounces=5, spp=2, seed=7, estimator="pbrt", russian_roulette_start=3
)


def _scene_data(cornell_path, metal_glass=False):
    with open(cornell_path) as f:
        data = json.load(f)
    if metal_glass:
        for b in data["bsdfs"]:
            if b["name"] == "TallBox":
                b.update(type="metal", roughness=0.1)
            if b["name"] == "ShortBox":
                b.update(type="dielectric", ior=1.5)
    return data


@pytest.mark.parametrize("metal_glass", [False, True])
def test_pbrt_parity_f64(cornell_path, metal_glass):
    data = _scene_data(cornell_path, metal_glass)
    scene, camera, _ = build_scene(data, dtype=np.float64)
    camera = camera._replace(resolution=(12, 12))
    with jax.enable_x64(True):
        scene_j = jax.tree.map(jnp.asarray, scene)
        camera_j = camera._replace(iview=jnp.asarray(camera.iview))
        img_jax = np.asarray(render_image(scene_j, camera_j, CFG))
    img_ref = ref.render_image(scene, camera, CFG, dtype=np.float64)
    assert np.isfinite(img_jax).all()
    assert img_jax.max() > 0.05  # nontrivial transport (12x12/2spp can miss
    # the small light panel directly; test_pbrt_uses_scene_emission covers it)
    np.testing.assert_allclose(img_jax, img_ref, rtol=1e-8, atol=1e-9)


def test_pbrt_uses_scene_emission(cornell_path):
    """Direct light pixels must carry the scene's (17,12,4) radiance.

    The light panel subtends a narrow band near the top of the frame
    (slope ~0.138-0.146 of the 0.172 half-fov); render just that band at
    192x192 and find a direct-hit pixel."""
    from pyrenderer_tpu.core.integrator import render_block

    data = _scene_data(cornell_path)
    scene, camera, _ = build_scene(data, dtype=np.float32)
    res = 192
    camera = camera._replace(resolution=(res, res))
    cfg = CFG.replace(spp=4)
    ys, xs = np.mgrid[160:176, 64:128]  # y up from bottom: top band
    px = jnp.asarray(xs.reshape(-1), jnp.int32)
    py = jnp.asarray(ys.reshape(-1), jnp.int32)
    out = np.asarray(
        render_block(
            jax.tree.map(jnp.asarray, scene), camera, cfg, cfg.seed, cfg.spp, px, py
        )
    )
    bright = out[np.argmax(out[:, 0])]
    assert bright[0] > 10
    np.testing.assert_allclose(bright[0] / bright[1], 17 / 12, rtol=0.05)


def test_russian_roulette_unbiased_mean(cornell_path):
    """RR must not bias the estimate: deep-bounce render with RR vs without,
    means agree within Monte-Carlo noise."""
    data = _scene_data(cornell_path)
    scene, camera, _ = build_scene(data, dtype=np.float32)
    camera = camera._replace(resolution=(16, 16))
    scene_j = jax.tree.map(jnp.asarray, scene)
    base = CFG.replace(max_bounces=8, spp=48, seed=11)
    img_rr = np.asarray(render_image(scene_j, camera, base.replace(russian_roulette_start=2)))
    img_norr = np.asarray(render_image(scene_j, camera, base.replace(russian_roulette_start=99)))
    assert abs(img_rr.mean() - img_norr.mean()) / img_norr.mean() < 0.05


def test_metal_reflects(cornell_path):
    """A mirror tall box must show colored wall reflections (red tint on its
    face visible from the camera side)."""
    data = _scene_data(cornell_path, metal_glass=True)
    scene, camera, _ = build_scene(data, dtype=np.float32)
    camera = camera._replace(resolution=(32, 32))
    cfg = CFG.replace(spp=8, max_bounces=6)
    img = np.asarray(render_image(jax.tree.map(jnp.asarray, scene), camera, cfg))
    assert np.isfinite(img).all()
    assert img.mean() > 0.01
