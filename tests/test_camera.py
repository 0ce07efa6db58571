"""Camera ray-generation tests (reference core/camera.py:41-72 semantics)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pyrenderer_tpu.core.camera import generate_rays
from pyrenderer_tpu.ref import scalar as ref
from pyrenderer_tpu.scene.tungsten import load_tungsten


@pytest.fixture(scope="module")
def camera(cornell_path):
    _, cam, _ = load_tungsten(cornell_path, dtype=np.float32)
    return cam


def test_center_ray(camera):
    w, h = camera.resolution
    px = jnp.array([w // 2], jnp.int32)
    py = jnp.array([h // 2], jnp.int32)
    ro, rd = generate_rays(camera, px, py, jnp.uint32(0), seed=0)
    ro, rd = np.asarray(ro), np.asarray(rd)
    assert np.allclose(ro[0], [0, 1, 6.8], atol=1e-6)
    # jittered ray near the center: dominant -z, small x/y
    assert rd[0, 2] < -0.99
    assert abs(rd[0, 0]) < 0.01 and abs(rd[0, 1]) < 0.01
    assert np.allclose(np.linalg.norm(rd[0]), 1.0, atol=1e-6)


def test_fov_extent(camera):
    """Corner rays span tan(fov/2) vertically (fov=19.5 deg)."""
    w, h = camera.resolution
    px = jnp.array([w // 2, w // 2], jnp.int32)
    py = jnp.array([0, h - 1], jnp.int32)
    _, rd = generate_rays(camera, px, py, jnp.uint32(0), seed=0)
    rd = np.asarray(rd)
    half = np.tan(np.radians(19.5) / 2)
    slope_bottom = rd[0, 1] / -rd[0, 2]
    slope_top = rd[1, 1] / -rd[1, 2]
    assert -half <= slope_bottom < -half * 0.99
    assert half * 0.99 < slope_top <= half
    assert slope_bottom < 0 < slope_top


def test_depth_of_field(camera):
    """Aperture > 0: origins jitter on the lens square (reference CPU
    semantics, core/camera.py:59-61), oracle parity holds."""
    cam = camera._replace(
        aperture=jnp.asarray(0.2, jnp.float32),
        focal_dist=jnp.asarray(5.0, jnp.float32),
    )
    n = 64
    px = jnp.full((n,), 512, jnp.int32)
    py = jnp.full((n,), 512, jnp.int32)
    ro, rd = generate_rays(cam, px, py, jnp.arange(n, dtype=jnp.uint32), seed=1)
    ro = np.asarray(ro)
    # origins spread over the aperture square around the eye
    assert ro[:, 0].std() > 0.01 and ro[:, 1].std() > 0.01
    assert np.abs(ro[:, 0] - 0.0).max() <= 0.101
    # oracle parity for a DoF camera
    ro_n, rd_n = ref.generate_ray(cam, 512, 512, 7, 1, np.float32)
    ro_j, rd_j = generate_rays(
        cam, jnp.asarray([512], jnp.int32), jnp.asarray([512], jnp.int32),
        jnp.asarray([7], jnp.uint32), seed=1,
    )
    np.testing.assert_allclose(np.asarray(ro_j)[0], ro_n, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rd_j)[0], rd_n, atol=1e-6)


def test_matches_scalar_oracle(camera):
    """JAX ray gen must match the NumPy oracle bit-for-bit in draws, tightly in floats."""
    w, h = camera.resolution
    xs = np.array([0, 3, 511, 1023], np.int32)
    ys = np.array([0, 7, 600, 1023], np.int32)
    ro_j, rd_j = generate_rays(
        camera, jnp.asarray(xs), jnp.asarray(ys), jnp.uint32(5), seed=9
    )
    for i in range(len(xs)):
        ro_n, rd_n = ref.generate_ray(camera, int(xs[i]), int(ys[i]), 5, 9, np.float32)
        np.testing.assert_allclose(np.asarray(ro_j)[i], ro_n, atol=1e-6)
        np.testing.assert_allclose(np.asarray(rd_j)[i], rd_n, atol=1e-6)


def test_hilbert_pixel_order():
    """Hilbert order: a true space-filling curve (every cell once,
    consecutive cells screen-adjacent on pow2 squares) and a valid
    permutation on arbitrary rectangles. Kept selectable via
    core.camera.pixel_order for locality experiments."""
    import numpy as np

    from pyrenderer_tpu.core.camera import hilbert_pixel_order, pixel_order

    for (w, h) in [(8, 8), (16, 12), (13, 7)]:
        perm, inv = hilbert_pixel_order(w, h)
        assert sorted(perm) == list(range(w * h))
        assert np.array_equal(perm[inv], np.arange(w * h))
    perm, _ = hilbert_pixel_order(16, 16)
    ys, xs = np.mgrid[0:16, 0:16]
    x = xs.reshape(-1)[perm]
    y = ys.reshape(-1)[perm]
    step = np.abs(np.diff(x)) + np.abs(np.diff(y))
    assert step.max() == 1  # perfectly adjacent on a pow2 square
    p_m, _ = pixel_order(16, 16, "morton")
    p_h, _ = pixel_order(16, 16, "hilbert")
    p_r, _ = pixel_order(16, 16, "row")
    assert not np.array_equal(p_m, p_h)
    assert np.array_equal(p_r, np.arange(256))
