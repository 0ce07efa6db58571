"""Watertight intersector tests, incl. the reference's differential-fuzz
pattern (reference debug/run.py:111-124 compared its two intersectors)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrenderer_tpu.core import intersect as isect
from pyrenderer_tpu.core.watertight import (
    diff_of_products,
    intersect_watertight,
)
from pyrenderer_tpu.scene.tungsten import load_tungsten


@pytest.fixture(scope="module")
def scene(cornell_path):
    s, _, _ = load_tungsten(cornell_path, dtype=np.float32)
    return jax.tree.map(jnp.asarray, s)


def test_diff_of_products_cancellation():
    # classic catastrophic cancellation: a*b - c*d where both products round
    # to the same f32 value but the true difference is nonzero
    a = jnp.float32(1.0 + 2.0 ** -12)
    b = jnp.float32(1.0 - 2.0 ** -12)
    c = jnp.float32(1.0)
    d = jnp.float32(1.0 - 2.0 ** -24)
    naive = a * b - c * d
    comp = diff_of_products(a, b, c, d)
    exact = float(np.float64(a) * np.float64(b) - np.float64(c) * np.float64(d))
    assert abs(float(comp) - exact) < 1e-12
    # the naive result loses the tiny residual entirely
    assert float(naive) != float(comp) or exact == float(naive)


def test_differential_fuzz_vs_moller_trumbore(scene):
    """Both intersectors must agree on hits/t away from edges (the
    reference's A/B fuzz, debug/run.py)."""
    rs = np.random.RandomState(7)
    n = 2000
    ro = rs.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    ro[:, 1] += 1.0
    rd = rs.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro, rd = jnp.asarray(ro), jnp.asarray(rd)

    h1, t1, _ = jax.jit(intersect_watertight)(scene, ro, rd, 1e-5, 1e5)
    h2, t2, _ = isect.intersect_brute(scene, ro, rd, 1e-5, 1e5)
    agree = np.asarray(h1) == np.asarray(h2)
    assert agree.mean() > 0.999
    both = agree & np.asarray(h1)
    np.testing.assert_allclose(
        np.asarray(t1)[both], np.asarray(t2)[both], rtol=1e-4, atol=1e-5
    )


def test_watertight_no_edge_leak():
    """Rays aimed exactly at the shared diagonal of a quad's two triangles
    must ALWAYS hit — the watertight guarantee MT lacks."""
    from pyrenderer_tpu.scene.types import Scene

    verts = jnp.asarray(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], jnp.float32
    )
    faces = jnp.asarray([[0, 1, 2], [2, 3, 0]], jnp.int32)
    scene = Scene(
        vertices=verts, faces=faces,
        normal_sign=jnp.ones(2), face_material=jnp.zeros(2, jnp.int32),
        albedo=jnp.ones((1, 3)), emission=jnp.zeros((1, 3)),
        emissive=jnp.zeros(1, jnp.int32), sided=jnp.zeros(1, jnp.int32),
        mat_type=jnp.zeros(1, jnp.int32), ior=jnp.ones(1),
        roughness=jnp.zeros(1),
        light_faces=jnp.zeros((1, 1), jnp.int32), light_nfaces=jnp.ones(1, jnp.int32),
    )
    # points exactly on the diagonal x == y, z = 0
    ts = np.linspace(0.05, 0.95, 64).astype(np.float32)
    ro = jnp.stack([ts, ts, jnp.full_like(jnp.asarray(ts), 1.0)], axis=1)
    rd = jnp.broadcast_to(jnp.asarray([0, 0, -1.0], jnp.float32), (64, 3))
    hit, t, _ = intersect_watertight(scene, ro, rd, 1e-5, 1e5)
    assert bool(jnp.all(hit)), "watertight test leaked a shared-edge ray"
    np.testing.assert_allclose(np.asarray(t), 1.0, rtol=1e-5)


def test_watertight_backend_render_matches_brute(cornell_path):
    """backend="watertight" is a first-class product path: a full render
    through the public API agrees with brute (away-from-edge pixels are
    identical; edge pixels may legitimately differ by the leak fix)."""
    from pyrenderer_tpu.config import RenderConfig
    from pyrenderer_tpu.core.integrator import render_image

    scene, camera, _ = load_tungsten(cornell_path, dtype=np.float32)
    scene = jax.tree.map(jnp.asarray, scene)
    camera = camera._replace(resolution=(32, 32))
    cfg = RenderConfig(max_bounces=3, spp=2, seed=0, estimator="reference")
    img_w = np.asarray(render_image(scene, camera, cfg, backend="watertight"))
    img_b = np.asarray(render_image(scene, camera, cfg, backend="brute"))
    assert np.isfinite(img_w).all()
    close = np.isclose(img_w, img_b, rtol=1e-3, atol=1e-4).mean()
    assert close > 0.98


def test_watertight_occluded_matches_brute(scene):
    from pyrenderer_tpu.core.watertight import occluded_watertight

    rs = np.random.RandomState(3)
    ro = jnp.asarray(rs.uniform(-0.9, 0.9, (512, 3)) + [0, 1, 0], jnp.float32)
    rd = rs.normal(size=(512, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd = jnp.asarray(rd)
    for t1 in (0.5, 2.0):
        a = np.asarray(occluded_watertight(scene, ro, rd, 1e-5, t1))
        b = np.asarray(isect.occluded(scene, ro, rd, 1e-5, t1))
        assert (a == b).mean() > 0.995


def test_wavefront_shared_edge_no_leak():
    """Wavefront-scale leak hunt: thousands of rays aimed EXACTLY at points
    on the shared diagonal of a quad's two triangles. The watertight test
    must hit every one (the guarantee the module exists for); plain
    Moeller-Trumbore with its one-sided det test typically leaks a few.

    Reference: mathematics/intersection_taichi.py:94-161 is the watertight
    variant precisely because shapes are quads split into triangle pairs.
    """
    from pyrenderer_tpu.scene.types import Scene

    # unit quad in the z=0 plane split along the (0,0)-(1,1) diagonal
    verts = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    n_mat = 1
    scene = Scene(
        vertices=jnp.asarray(verts),
        faces=jnp.asarray(faces),
        face_material=jnp.zeros(2, jnp.int32),
        normal_sign=jnp.ones(2, jnp.float32),
        albedo=jnp.ones((n_mat, 3), jnp.float32) * 0.5,
        emission=jnp.zeros((n_mat, 3), jnp.float32),
        emissive=jnp.zeros(n_mat, jnp.float32),
        sided=jnp.zeros(n_mat, jnp.float32),
        mat_type=jnp.zeros(n_mat, jnp.int32),
        ior=jnp.ones(n_mat, jnp.float32),
        roughness=jnp.zeros(n_mat, jnp.float32),
        light_faces=jnp.zeros((1, 1), jnp.int32),
        light_nfaces=jnp.ones(1, jnp.int32),
    )
    n = 4096
    # diagonal points (a, a, 0), rays from skewed origins through them —
    # f32 arithmetic keeps the target exactly on the shared edge
    a = np.linspace(0.001, 0.999, n, dtype=np.float32)
    target = np.stack([a, a, np.zeros_like(a)], axis=1)
    ro = np.stack(
        [a * 0.3 + 0.1, a * 0.7 + 0.05, np.full_like(a, 2.0)], axis=1
    ).astype(np.float32)
    rd = target - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    hit_w, _, _ = intersect_watertight(
        scene, jnp.asarray(ro), jnp.asarray(rd), 1e-5, 1e5
    )
    assert np.asarray(hit_w).all(), (
        f"watertight leaked {int((~np.asarray(hit_w)).sum())} of {n} edge rays"
    )


def test_shared_edge_no_leak_under_jit_and_fusion():
    """The COMPILED (jitted) watertight test must be leak-free too.

    Round-5 regression guard: the e == 0.0 fallback trigger of rounds
    1-4 was fusion-dependent — under XLA jit the edge-function mul/sub
    can contract into an fma, an exactly-cancelling pair then leaves a
    +/-1-ulp residue instead of 0.0, and the compensated fallback never
    fires (2043/4096 on-edge rays leaked in a jitted leaf whose fallback
    code had been moved out of line). The eager-mode leak hunts above
    cannot catch that class — eager never fuses. The fix is the relative
    -threshold trigger (core/watertight._EDGE_REL_TOL); this test pins
    it under jit, including a variant compiled WITHOUT the compensation
    operand-reuse that accidentally suppressed the contraction before.
    """
    from pyrenderer_tpu.core import watertight as wt

    verts = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    v = jnp.asarray(verts)
    v0 = v[jnp.asarray(faces[:, 0])]
    v1 = v[jnp.asarray(faces[:, 1])]
    v2 = v[jnp.asarray(faces[:, 2])]
    n = 4096
    ts = np.linspace(1e-4, 1.0 - 1e-4, n).astype(np.float32)
    ro = jnp.asarray(
        np.stack([ts, ts, np.ones(n, np.float32)], axis=1))
    rd = jnp.asarray(
        np.broadcast_to(np.asarray([0.0, 0.0, -1.0], np.float32), (n, 3)))

    valid, t = jax.jit(wt.watertight_terms)(v0, v1, v2, ro, rd)
    hit = np.asarray(valid & (t > 1e-5) & (t < 10.0)).any(axis=1)
    assert hit.all(), f"jitted watertight leaked {(~hit).sum()}/{n}"

    # sanity: the raw (fallback-free) product difference under jit is NOT
    # reliably zero on these exactly-cancelling rays — the very hazard
    # the threshold exists for. If a future XLA stops contracting, this
    # canary goes vacuous (zeros), which is fine.
    def raw_edges(ro):
        x0, y0 = -ro[:, 0], -ro[:, 1]
        x2, y2 = 1.0 - ro[:, 0], 1.0 - ro[:, 1]
        return x2 * y0 - y2 * x0   # the diagonal edge function of face 0

    e_jit = np.asarray(jax.jit(raw_edges)(ro))
    e_eager = np.asarray(raw_edges(ro))
    assert (e_eager == 0).all()   # exact cancellation by construction
