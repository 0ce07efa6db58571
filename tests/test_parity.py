"""BASELINE config 1: matched-seed image parity, JAX wavefront vs NumPy oracle.

The reference has no seedable RNG, so parity is defined against our own CPU
reference (SURVEY §7 "Hard parts"): both sides draw from the same
counter-based threefry stream and implement the same "reference" estimator
semantics independently (JAX: core/integrator.py; NumPy: ref/scalar.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core.integrator import render_image
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.tungsten import load_tungsten


CFG = RenderConfig(max_bounces=4, spp=2, seed=3, estimator="reference")


@pytest.fixture(scope="module")
def cornell64(cornell_path):
    return load_tungsten(cornell_path, dtype=np.float64)


def _small_camera(camera, res=16):
    return camera._replace(resolution=(res, res))


def test_image_parity_f64(cornell64):
    """Tight allclose in float64: same math, independent implementations."""
    scene, camera, _ = cornell64
    camera = _small_camera(camera, 16)
    with jax.enable_x64(True):
        scene_j = jax.tree.map(jnp.asarray, scene)
        camera_j = camera._replace(iview=jnp.asarray(camera.iview))
        img_jax = np.asarray(render_image(scene_j, camera_j, CFG))
    img_ref = ref.render_image(scene, camera, CFG, dtype=np.float64)

    assert img_jax.shape == img_ref.shape == (16, 16, 3)
    assert np.isfinite(img_jax).all()
    # Non-trivial image: light visible, walls lit
    assert img_jax.max() > 0.1
    np.testing.assert_allclose(img_jax, img_ref, rtol=1e-9, atol=1e-10)


def test_image_parity_f32(cornell_path):
    """float32 end-to-end: discrete decisions may flip on a few pixels at
    silhouettes; demand near-total agreement and tight error elsewhere."""
    scene, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    camera = _small_camera(camera, 16)
    img_jax = np.asarray(
        render_image(jax.tree.map(jnp.asarray, scene), camera, CFG)
    )
    img_ref = ref.render_image(scene, camera, CFG, dtype=np.float32)
    close = np.isclose(img_jax, img_ref, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.95
    assert np.median(np.abs(img_jax - img_ref)) < 1e-5
