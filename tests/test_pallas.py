"""Whole-table Pallas kernel (kernels/pallas_intersect.py) in interpret mode
against the plain XLA path (core/intersect.py). The compiled kernel runs on
the GPU only: tests/test_gpu.py and chip_smoke.py check it there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrenderer_tpu.core import intersect as isect
from pyrenderer_tpu.kernels import pallas_intersect as pk


def _soup(n_tris, seed):
    """Random triangle soup around the origin: (v0, e1, e2) and its table."""
    rs = np.random.RandomState(seed)
    v = rs.uniform(-1, 1, (n_tris, 3, 3)).astype(np.float32)
    v0 = jnp.asarray(v[:, 0])
    e1 = jnp.asarray(v[:, 1] - v[:, 0])
    e2 = jnp.asarray(v[:, 2] - v[:, 0])
    table = jnp.concatenate([v0.T, e1.T, e2.T], axis=0)
    return (v0, e1, e2), table


def _rays(n, seed):
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


@pytest.mark.parametrize("query", ["closest", "any"])
@pytest.mark.parametrize("n_tris", [1, 36, 65, 300])
@pytest.mark.parametrize("n_rays", [1, 100, 128, 1000])
def test_kernel_matches_brute(n_rays, n_tris, query):
    """Ray counts around the 128-ray block (padding), table sizes around
    the 4-triangle unroll (padding), both queries."""
    tris, table = _soup(n_tris, seed=n_tris)
    ro, rd = _rays(n_rays, seed=n_rays)
    if query == "closest":
        h, t, f = pk.closest_hit(table, ro, rd, 1e-5, 1e5, interpret=True)
        h2, t2, f2 = isect.intersect_brute_arrays(*tris, ro, rd, 1e-5, 1e5)
        assert h.shape == t.shape == f.shape == (n_rays,)
        assert f.dtype == jnp.int32
        h, h2 = np.asarray(h), np.asarray(h2)
        assert np.array_equal(h, h2)
        assert np.array_equal(np.asarray(f)[h], np.asarray(f2)[h])
        assert (np.asarray(f)[~h] == -1).all()
        # f32 association: t agrees to ~1 ulp of the triple products
        np.testing.assert_allclose(np.asarray(t)[h], np.asarray(t2)[h],
                                   rtol=1e-5, atol=1e-6)
        assert (np.asarray(t)[~h] == 0).all()
    else:
        t1 = 0.7
        occ = pk.occluded(table, ro, rd, 1e-5, t1, interpret=True)
        occ2 = isect.occluded_arrays(*tris, ro, rd, 1e-5, t1)
        assert occ.shape == (n_rays,) and occ.dtype == jnp.bool_
        assert np.array_equal(np.asarray(occ), np.asarray(occ2))


@pytest.mark.parametrize("query", ["closest", "any"])
def test_per_ray_t1_and_dead_lanes(query):
    """Per-ray t1, with a third of the lanes dead (t1 = 0, as the
    integrator traces terminated paths): dead lanes never hit."""
    tris, table = _soup(65, seed=1)
    ro, rd = _rays(300, seed=2)
    t1 = np.random.RandomState(3).uniform(0.05, 2.0, 300).astype(np.float32)
    t1[::3] = 0.0
    t1 = jnp.asarray(t1)
    if query == "closest":
        h, t, _ = pk.closest_hit(table, ro, rd, 1e-5, t1, interpret=True)
        h2, t2, _ = isect.intersect_brute_arrays(*tris, ro, rd, 1e-5, t1)
        assert np.array_equal(np.asarray(h), np.asarray(h2))
        assert (np.asarray(t)[np.asarray(h)] < np.asarray(t1)[np.asarray(h)]).all()
        assert not np.asarray(h)[::3].any()
    else:
        occ = pk.occluded(table, ro, rd, 1e-5, t1, interpret=True)
        occ2 = isect.occluded_arrays(*tris, ro, rd, 1e-5, t1)
        assert np.array_equal(np.asarray(occ), np.asarray(occ2))
        assert not np.asarray(occ)[::3].any()


def test_ties_resolve_to_lowest_index():
    """Duplicated triangles give exact t ties: the lowest face id wins, as
    in the reference's strict-less-than scan and in brute's argmin."""
    tris, table = _soup(40, seed=5)
    table = jnp.concatenate([table, table], axis=1)       # faces 40..79 dup
    ro, rd = _rays(500, seed=6)
    h, _, f = pk.closest_hit(table, ro, rd, 1e-5, 1e5, interpret=True)
    h = np.asarray(h)
    assert h.sum() > 50
    assert (np.asarray(f)[h] < 40).all()
    h2, _, f2 = isect.intersect_brute_arrays(
        *(jnp.concatenate([x, x]) for x in tris), ro, rd, 1e-5, 1e5)
    assert np.array_equal(np.asarray(f)[h], np.asarray(f2)[h])


def test_cornell_scene_table(cornell_path):
    """pack_triangles on a real scene: the kernel matches intersect_brute."""
    from pyrenderer_tpu.scene.tungsten import load_tungsten

    s, _, _ = load_tungsten(cornell_path, dtype=np.float32)
    s = jax.tree.map(jnp.asarray, s)
    table = pk.pack_triangles(s.vertices, s.faces)
    assert table.shape == (9, s.faces.shape[0]) and table.dtype == jnp.float32
    ro, rd = _rays(256, seed=7)
    ro = ro + jnp.asarray([0.0, 1.0, 0.0])
    h, t, f = pk.closest_hit(table, ro, rd, 1e-5, 1e5, interpret=True)
    h2, t2, f2 = isect.intersect_brute(s, ro, rd, 1e-5, 1e5)
    h = np.asarray(h)
    assert np.array_equal(h, np.asarray(h2))
    assert h.mean() > 0.5               # rays start inside the box
    assert np.array_equal(np.asarray(f)[h], np.asarray(f2)[h])


def test_inputs_are_detached():
    """The kernel has no autodiff rule: closest_hit stops gradients at its
    boundary, so a grad through a caller sees zero, not an error."""
    tris, table = _soup(36, seed=8)
    ro, rd = _rays(128, seed=9)

    def f(ro):
        _, t, _ = pk.closest_hit(table, ro, rd, 1e-5, 1e5, interpret=True)
        return t.sum()

    g = jax.grad(f)(ro)
    assert (np.asarray(g) == 0).all()


@pytest.mark.parametrize("query", ["closest", "any"])
def test_compiled_kernel_refused_off_gpu(query):
    """No quiet fallback: without interpret=True the GPU kernel refuses to
    run on another platform."""
    _, table = _soup(4, seed=0)
    ro, rd = _rays(8, seed=0)
    fn = pk.closest_hit if query == "closest" else pk.occluded
    with pytest.raises(RuntimeError, match="GPU only"):
        fn(table, ro, rd, 1e-5, 1e5)


def test_render_backend_pallas_refused_off_gpu(cornell_path):
    """Explicit backend='pallas' through the public render entry point
    raises on the CPU instead of falling back to brute."""
    from pyrenderer_tpu.core.integrator import render_image
    from pyrenderer_tpu.scene.tungsten import load_tungsten

    s, cam, cfg = load_tungsten(cornell_path, dtype=np.float32)
    cam = cam._replace(resolution=(4, 4))
    with pytest.raises(RuntimeError, match="GPU only"):
        render_image(jax.tree.map(jnp.asarray, s), cam,
                     cfg.replace(spp=1, max_bounces=1), backend="pallas")


def test_kernel_lowers_to_triton_for_cuda():
    """The compiled path lowers to a Triton custom call for the GPU (cross-
    lowering here: no GPU compiler runs, but every primitive must have a
    Triton lowering rule)."""
    _, table = _soup(36, seed=1)
    ro, rd = _rays(256, seed=1)
    for fn, t1 in ((pk._closest, 1e5), (pk._occluded, 0.5)):
        lowered = jax.jit(
            lambda ro, rd, fn=fn, t1=t1: fn(table, ro, rd, t1, t0=1e-5,
                                            interpret=False)
        ).trace(ro, rd).lower(lowering_platforms=("cuda",))
        assert "triton" in lowered.as_text()
