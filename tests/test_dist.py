"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core.integrator import render_block
from pyrenderer_tpu.dist.render import make_mesh, render_field_sharded, train_step
from pyrenderer_tpu.scene.tungsten import load_tungsten


@pytest.fixture(scope="module")
def setup(cornell_path):
    scene, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, scene)
    camera = camera._replace(resolution=(16, 16))
    cfg = RenderConfig(max_bounces=3, spp=4, seed=5)
    w, h = camera.resolution
    ys, xs = np.mgrid[0:h, 0:w]
    px = jnp.asarray(xs.reshape(-1), jnp.int32)
    py = jnp.asarray(ys.reshape(-1), jnp.int32)
    return scene, camera, cfg, px, py


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_matches_single(setup):
    """dp x sp sharded render must equal the single-device render exactly
    (same RNG counters; only the reduction layout differs)."""
    scene, camera, cfg, px, py = setup
    mesh = make_mesh(8, dp=4, sp=2)
    out_sharded = np.asarray(
        jax.jit(render_field_sharded, static_argnames=("cfg", "mesh"))(
            scene, camera, cfg, mesh, px, py
        )
    )
    out_single = np.asarray(render_block(scene, camera, cfg, cfg.seed, cfg.spp, px, py))
    np.testing.assert_allclose(out_sharded, out_single, rtol=2e-5, atol=1e-6)


def test_sharded_dp_only(setup):
    scene, camera, cfg, px, py = setup
    mesh = make_mesh(8, dp=8, sp=1)
    out = np.asarray(
        jax.jit(render_field_sharded, static_argnames=("cfg", "mesh"))(
            scene, camera, cfg, mesh, px, py
        )
    )
    assert np.isfinite(out).all()
    assert out.max() > 0.1


def test_config5_scene_sharded(cornell_path):
    """BASELINE config 5 shape: the Cornell+mesh scene, pixel tiles over dp
    and spp over sp (full scale runs on real hardware; this validates the
    sharded program end-to-end)."""
    import os

    path = os.path.join(
        os.path.dirname(os.path.abspath(cornell_path)), "..", "..",
        "scenes", "cornell_mesh.json",
    )
    scene, camera, cfg = load_tungsten(os.path.abspath(path))
    assert scene.faces.shape[0] == 5 * 2 + 12 + 12 + 2
    camera = camera._replace(resolution=(16, 16))
    cfg = RenderConfig(max_bounces=4, spp=8, seed=1, estimator="pbrt",
                       stratified=True)
    scene_j = jax.tree.map(jnp.asarray, scene)
    mesh = make_mesh(8, dp=4, sp=2)
    w, h = camera.resolution
    ys, xs = np.mgrid[0:h, 0:w]
    px = jnp.asarray(xs.reshape(-1), jnp.int32)
    py = jnp.asarray(ys.reshape(-1), jnp.int32)
    out = np.asarray(
        jax.jit(render_field_sharded, static_argnames=("cfg", "mesh"))(
            scene_j, camera, cfg, mesh, px, py
        )
    )
    single = np.asarray(
        render_block(scene_j, camera, cfg, cfg.seed, cfg.spp, px, py)
    )
    np.testing.assert_allclose(out, single, rtol=2e-5, atol=1e-6)
    assert out.mean() > 0.01


def test_train_step_runs_and_descends(setup):
    scene, camera, cfg, px, py = setup
    mesh = make_mesh(8, dp=4, sp=2)
    target = jnp.zeros((px.shape[0], 3), jnp.float32)
    params = (scene.vertices, scene.albedo, scene.emission)
    loss1, params2 = train_step(
        params, scene, camera, cfg, mesh, target, px, py, jnp.float32(0.05)
    )
    assert np.isfinite(float(loss1)) and float(loss1) > 0
    # albedo gradient must be nonzero (reference-mode estimator shades albedo)
    d_albedo = np.asarray(params2[1]) - np.asarray(params[1])
    assert np.abs(d_albedo).max() > 0
    loss2, _ = train_step(
        params2, scene, camera, cfg, mesh, target, px, py, jnp.float32(0.05)
    )
    assert float(loss2) < float(loss1)


def test_sharded_bvh_accel_replicated():
    """Large (>4096-tri) scene through the dp x sp shard_map with a
    REPLICATED FlatBVH accel — the path dist/render.py:render_field_sharded
    takes for big scenes instead of the warned O(T) fallback."""
    from pyrenderer_tpu.core.integrator import maybe_build_accel, render_block
    from pyrenderer_tpu.scene.procgen import big_scene_data
    from pyrenderer_tpu.scene.tungsten import build_scene

    data = big_scene_data("terrain", res=64)
    scene, camera, cfg = build_scene(data, dtype=np.float32)
    accel = maybe_build_accel(scene, "auto")
    scene = jax.tree.map(jnp.asarray, scene)
    camera = camera._replace(resolution=(16, 16))
    cfg = cfg.replace(max_bounces=2, spp=2, seed=4)
    w, h = camera.resolution
    ys, xs = np.mgrid[0:h, 0:w]
    px = jnp.asarray(xs.reshape(-1), jnp.int32)
    py = jnp.asarray(ys.reshape(-1), jnp.int32)
    mesh = make_mesh(8, dp=4, sp=2)
    got = np.asarray(
        render_field_sharded(scene, camera, cfg, mesh, px, py, accel=accel)
    )
    want = np.asarray(
        render_block(scene, camera, cfg, cfg.seed, cfg.spp, px, py,
                     backend="bvh", accel=accel)
    )
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


def _kernel_rays(n, seed):
    rs = np.random.RandomState(seed)
    ro = jnp.asarray(rs.uniform(-0.8, 0.8, (n, 3)) + [0, 1, 0], jnp.float32)
    rd = rs.normal(size=(n, 3))
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True),
                     jnp.float32)
    return ro, rd


def test_pallas_kernel_lowers_inside_checked_shard_map(setup):
    """jax >= 0.9 shard_map(check_vma=True) rejects pallas_call outputs
    without explicit vma ("vma on jax.ShapeDtypeStruct must not be None").
    The dp/sp render runs the whole-table kernel inside such a shard_map on
    the GPU; here the compiled (Triton) path is traced and lowered for CUDA
    through a checked 8-device mesh, where that bug bit, without running.
    kernels/vma.py carries the rays' varying axes onto the outputs."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from pyrenderer_tpu.kernels import pallas_intersect as pk

    scene, camera, cfg, px, py = setup
    tri_table = pk.pack_triangles(scene.vertices, scene.faces)
    mesh = make_mesh(8, dp=8, sp=1)
    n = 1024
    ro, rd = _kernel_rays(n, 3)
    t1 = jnp.full((n,), 1.0, jnp.float32)

    def body(ro, rd, t1):
        h, t, f = pk._closest(tri_table, ro, rd, 1e5, t0=1e-5,
                              interpret=False)
        occ = pk._occluded(tri_table, ro, rd, t1, t0=1e-5, interpret=False)
        return h, t, f, occ

    sharded = jax.jit(partial(
        jax.shard_map, mesh=mesh, in_specs=(P("dp"),) * 3,
        out_specs=(P("dp"),) * 4, check_vma=True,
    )(body))
    shapes = jax.eval_shape(sharded, ro, rd, t1)
    assert [s.shape for s in shapes] == [(n,)] * 4
    lowered = sharded.trace(ro, rd, t1).lower(lowering_platforms=("cuda",))
    assert "triton" in lowered.as_text()


def test_pallas_kernel_executes_inside_checked_mesh(setup):
    """EXECUTE the whole-table kernel (interpret mode) inside the 8-device
    mesh under check_vma=True, closest and any hit, against brute."""
    from jax.sharding import PartitionSpec as P

    from pyrenderer_tpu.core import intersect as isect
    from pyrenderer_tpu.kernels import pallas_intersect as pk

    scene, camera, cfg, px, py = setup
    mesh = make_mesh(8, dp=8, sp=1)
    n = 1024
    tri_table = pk.pack_triangles(scene.vertices, scene.faces)
    ro, rd = _kernel_rays(n, 7)
    t1 = jnp.asarray(np.random.RandomState(8).uniform(0.1, 3.0, n),
                     jnp.float32)

    def body(ro, rd, t1):
        h, t, f = pk.closest_hit(tri_table, ro, rd, 1e-5, t1, interpret=True)
        occ = pk.occluded(tri_table, ro, rd, 1e-5, t1, interpret=True)
        return h, t, f, occ

    h, t, f, occ = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("dp"),) * 3,
        out_specs=(P("dp"),) * 4, check_vma=True))(ro, rd, t1)
    h2, t2, f2 = isect.intersect_brute(scene, ro, rd, 1e-5, t1)
    o2 = isect.occluded(scene, ro, rd, 1e-5, t1)
    h = np.asarray(h)
    assert np.array_equal(h, np.asarray(h2)) and h.any()
    np.testing.assert_allclose(np.asarray(t)[h], np.asarray(t2)[h],
                               rtol=1e-5, atol=1e-6)
    # rays through a quad's shared diagonal meet both halves at the same t
    # up to rounding; the two sides may pick either half
    assert (np.asarray(f)[h] == np.asarray(f2)[h]).mean() > 0.99
    assert np.array_equal(np.asarray(occ), np.asarray(o2))
