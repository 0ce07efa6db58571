"""BASELINE config 2: .obj mesh + BVH traversal."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrenderer_tpu.accel import bvh as bvh_mod
from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core import intersect as isect
from pyrenderer_tpu.core.integrator import render_image
from pyrenderer_tpu.scene.obj import parse_obj
from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu.scene.types import Scene


def make_sphere_mesh(n_theta=20, n_phi=32):
    """UV-sphere triangle mesh (~2*n_theta*n_phi tris) for stress tests."""
    thetas = np.linspace(0, np.pi, n_theta + 1)
    phis = np.linspace(0, 2 * np.pi, n_phi, endpoint=False)
    verts = []
    idx = {}
    for i, th in enumerate(thetas):
        for j, ph in enumerate(phis):
            idx[(i, j)] = len(verts)
            verts.append(
                [np.sin(th) * np.cos(ph), np.cos(th), np.sin(th) * np.sin(ph)]
            )
    faces = []
    for i in range(n_theta):
        for j in range(n_phi):
            j2 = (j + 1) % n_phi
            a, b = idx[(i, j)], idx[(i, j2)]
            c, d = idx[(i + 1, j)], idx[(i + 1, j2)]
            if i > 0:
                faces.append([a, b, d])
            if i < n_theta - 1:
                faces.append([a, d, c])
    return np.asarray(verts), np.asarray(faces, np.int32)


def _mesh_scene(verts, faces):
    t = faces.shape[0]
    return Scene(
        vertices=jnp.asarray(verts, jnp.float32),
        faces=jnp.asarray(faces),
        normal_sign=jnp.ones(t, jnp.float32),
        face_material=jnp.zeros(t, jnp.int32),
        albedo=jnp.ones((1, 3), jnp.float32),
        emission=jnp.zeros((1, 3), jnp.float32),
        emissive=jnp.zeros(1, jnp.int32),
        sided=jnp.zeros(1, jnp.int32),
        mat_type=jnp.zeros(1, jnp.int32),
        ior=jnp.ones(1, jnp.float32),
        roughness=jnp.zeros(1, jnp.float32),
        light_faces=jnp.zeros((1, 1), jnp.int32),
        light_nfaces=jnp.ones(1, jnp.int32),
    )


def test_obj_parser():
    text = """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
f -4//1 -3//2 -2//3
"""
    v, f = parse_obj(text)
    assert v.shape == (4, 3)
    # quad fans into 2 tris + one more face
    assert f.shape == (3, 3)
    assert f[0].tolist() == [0, 1, 2]
    assert f[1].tolist() == [0, 2, 3]
    assert f[2].tolist() == [0, 1, 2]


def test_lbvh_structure():
    verts, faces = make_sphere_mesh(8, 12)
    bvh = bvh_mod.build_lbvh(verts, faces, leaf_size=4)
    first = np.asarray(bvh.first)
    count = np.asarray(bvh.count)
    escape = np.asarray(bvh.escape)
    # leaves cover every triangle exactly once
    covered = []
    for i in range(bvh.n_nodes):
        if count[i] > 0:
            covered.extend(range(first[i], first[i] + count[i]))
    assert sorted(covered) == list(range(faces.shape[0]))
    # escape pointers are forward (or -1), pre-order property
    assert escape[0] == -1
    for i in range(bvh.n_nodes):
        assert escape[i] == -1 or escape[i] > i
    # root bbox encloses the mesh
    np.testing.assert_allclose(np.asarray(bvh.bbox_min[0]), verts.min(0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(bvh.bbox_max[0]), verts.max(0), atol=1e-6)


def test_traversal_matches_brute_sphere():
    verts, faces = make_sphere_mesh(16, 24)  # 736 tris
    scene = _mesh_scene(verts, faces)
    bvh = bvh_mod.build_lbvh(scene.vertices, scene.faces)
    ordered = scene.faces[bvh.order]
    v = scene.vertices
    v0 = v[ordered[:, 0]]
    e1 = v[ordered[:, 1]] - v0
    e2 = v[ordered[:, 2]] - v0

    rs = np.random.RandomState(0)
    n = 512
    ro = jnp.asarray(rs.uniform(-2, 2, (n, 3)), jnp.float32)
    rd = rs.normal(size=(n, 3))
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True), jnp.float32)

    h1, t1, tri1 = jax.jit(
        lambda ro, rd: bvh_mod.traverse(bvh, v0, e1, e2, ro, rd, 1e-5, 1e5)
    )(ro, rd)
    h2, t2, tri2 = isect.intersect_brute(scene, ro, rd, 1e-5, 1e5)
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    hits = np.asarray(h1)
    np.testing.assert_allclose(
        np.asarray(t1)[hits], np.asarray(t2)[hits], rtol=1e-5, atol=1e-6
    )
    # same triangle modulo coplanar-edge ties
    assert (np.asarray(tri1)[hits] == np.asarray(tri2)[hits]).mean() > 0.99


def test_anyhit_traversal():
    verts, faces = make_sphere_mesh(8, 12)
    scene = _mesh_scene(verts, faces)
    bvh = bvh_mod.build_lbvh(scene.vertices, scene.faces)
    ordered = scene.faces[bvh.order]
    v = scene.vertices
    v0, e1, e2 = (
        v[ordered[:, 0]],
        v[ordered[:, 1]] - v[ordered[:, 0]],
        v[ordered[:, 2]] - v[ordered[:, 0]],
    )
    ro = jnp.asarray([[0, 0, 3.0], [0, 3.0, 0], [2.0, 2.0, 2.0]], jnp.float32)
    rd = jnp.asarray([[0, 0, -1.0], [1, 0, 0], [1, 0, 0]], jnp.float32)
    hit, _, _ = bvh_mod.traverse(bvh, v0, e1, e2, ro, rd, 1e-5, 1e5, any_hit=True)
    assert np.asarray(hit).tolist() == [True, False, False]


def test_mesh_scene_render_with_bvh(cornell_path):
    """config 2: cube.obj mesh scene rendered via the BVH backend."""
    import os

    scene_path = os.path.join(os.path.dirname(cornell_path), "..", "..", "scenes", "cube_mesh.json")
    scene, camera, cfg = load_tungsten(os.path.abspath(scene_path))
    assert scene.faces.shape[0] == 3 * 2 + 12 + 2  # 3 quads + cube mesh + light
    camera = camera._replace(resolution=(32, 32))
    cfg = cfg.replace(spp=4, max_bounces=4, estimator="pbrt")
    scene_j = jax.tree.map(jnp.asarray, scene)
    bvh = bvh_mod.build_lbvh(scene.vertices, scene.faces)
    img_bvh = np.asarray(render_image(scene_j, camera, cfg, backend="bvh", bvh=bvh))
    img_brute = np.asarray(render_image(scene_j, camera, cfg, backend="brute"))
    assert np.isfinite(img_bvh).all()
    assert img_bvh.mean() > 0.01
    # identical RNG + same hits -> nearly identical images
    close = np.isclose(img_bvh, img_brute, rtol=1e-3, atol=1e-4)
    assert close.mean() > 0.99


# ---------------------------------------------------------------------------
# The large-scene path end to end: auto selection, renders and gradients
# through the BVH on an 8k-triangle procgen terrain, against brute.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def terrain_scene():
    """Cornell walls + 8k-triangle procedural terrain (seeded)."""
    from pyrenderer_tpu.scene import procgen
    from pyrenderer_tpu.scene.tungsten import build_scene

    data = procgen.big_scene_data("terrain", res=64)
    scene, cam, cfg = build_scene(data, dtype=np.float32)
    return scene, cam, cfg


@pytest.mark.parametrize("platform,n_tris,accel,expected", [
    ("gpu", 36, False, "pallas"),
    ("gpu", 8204, True, "pallas"),
    ("gpu", 16384, True, "pallas"),
    ("gpu", 16385, True, "bvh"),
    ("cpu", 36, False, "brute"),
    ("cpu", 4096, True, "brute"),
    ("cpu", 8204, True, "bvh"),
])
def test_resolve_backend_per_platform(monkeypatch, platform, n_tris, accel,
                                      expected):
    """backend='auto' picks by platform and triangle count; no branch
    names any other platform."""
    from pyrenderer_tpu.core import integrator

    monkeypatch.setattr(integrator.jax, "default_backend", lambda: platform)
    got = integrator.resolve_backend("auto", n_tris,
                                     object() if accel else None)
    assert got == expected
    # explicit backend strings pass through untouched
    assert integrator.resolve_backend("brute", 10 ** 6, None) == "brute"
    assert integrator.resolve_backend("bvh", 10, object()) == "bvh"


def test_auto_without_accel_warns_and_uses_whole_table():
    from pyrenderer_tpu.core.integrator import (
        auto_brute_max_tris,
        resolve_backend,
    )

    with pytest.warns(UserWarning, match="no prebuilt"):
        assert resolve_backend("auto", auto_brute_max_tris() + 1) == "brute"


def test_auto_build_accel(terrain_scene):
    from pyrenderer_tpu.core.integrator import (
        auto_brute_max_tris,
        maybe_build_accel,
    )

    scene, _, _ = terrain_scene
    assert scene.faces.shape[0] > auto_brute_max_tris()
    assert isinstance(maybe_build_accel(scene, "auto"), bvh_mod.FlatBVH)
    assert isinstance(maybe_build_accel(scene, "bvh"), bvh_mod.FlatBVH)
    assert maybe_build_accel(scene, "brute") is None
    small = scene._replace(faces=scene.faces[:100])
    assert maybe_build_accel(small, "auto") is None


@pytest.mark.parametrize("estimator", ["reference", "pbrt"])
def test_render_bvh_matches_brute(terrain_scene, estimator):
    """32x32 end-to-end render through the public API with auto selection
    (-> bvh) against brute: identical RNG, so only fp-tie faces differ."""
    scene, cam, cfg = terrain_scene
    cam = cam._replace(resolution=(32, 32))
    cfg = cfg.replace(spp=2, max_bounces=3, estimator=estimator)
    sj = jax.tree.map(jnp.asarray, scene)
    img_auto = np.asarray(render_image(sj, cam, cfg))
    img_b = np.asarray(render_image(sj, cam, cfg, backend="brute"))
    assert np.isfinite(img_auto).all() and img_auto.max() > 0
    close = np.isclose(img_auto, img_b, rtol=1e-3, atol=1e-4).mean()
    assert close > 0.99


def test_grad_flows_with_bvh_backend(terrain_scene):
    """stop_gradient boundary: grad w.r.t. albedo works through the bvh
    backend (selection detached, shading re-evaluated differentiably)."""
    from pyrenderer_tpu.core.integrator import maybe_build_accel, render_block

    scene, cam, cfg = terrain_scene
    cam = cam._replace(resolution=(8, 8))
    cfg = cfg.replace(spp=1, max_bounces=2)
    accel = maybe_build_accel(scene, "auto")
    sj = jax.tree.map(jnp.asarray, scene)
    px, py = jnp.meshgrid(jnp.arange(8), jnp.arange(8))
    px = px.reshape(-1).astype(jnp.int32)
    py = py.reshape(-1).astype(jnp.int32)

    def loss(albedo, backend, accel):
        s = sj._replace(albedo=albedo)
        return jnp.sum(render_block(s, cam, cfg, 0, 1, px, py, backend, accel))

    g = np.asarray(jax.grad(loss)(sj.albedo, "bvh", accel))
    g_b = np.asarray(jax.grad(loss)(sj.albedo, "brute", None))
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, g_b, rtol=1e-3, atol=1e-5)


def test_bvh_adversarial_geometry():
    """Degenerate/hostile inputs through build + traversal: zero-area
    triangles, duplicated faces, coincident vertices, a huge-coordinate
    outlier — the build must not crash and the traversal must agree with
    the brute oracle away from the ill-conditioned outlier."""
    rs = np.random.RandomState(0)
    pts = rs.uniform(-1, 1, (600, 3)).astype(np.float32)
    pts[7] = pts[3]                                   # coincident vertices
    pts[11] = [1e6, 1e6, 1e6]                         # far outlier vertex
    faces = rs.randint(0, 600, (700, 3)).astype(np.int32)
    faces[5] = [3, 3, 3]                              # zero-area (point)
    faces[6] = [4, 4, 9]                              # zero-area (edge)
    faces[10] = faces[20]                             # duplicate face
    scene = _mesh_scene(pts, faces)
    bvh = bvh_mod.build_bvh(pts, faces)
    ordered = scene.faces[bvh.order]
    v = scene.vertices
    v0 = v[ordered[:, 0]]
    e1, e2 = v[ordered[:, 1]] - v0, v[ordered[:, 2]] - v0
    ro = jnp.asarray(rs.uniform(-0.9, 0.9, (256, 3)), jnp.float32)
    rd = rs.normal(size=(256, 3))
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True),
                     jnp.float32)
    h_v, t_v, f_v = bvh_mod.traverse(bvh, v0, e1, e2, ro, rd, 1e-5, 1e5)
    h_b, t_b, f_b = isect.intersect_brute(scene, ro, rd, 1e-5, 1e5)
    h_v, h_b = np.asarray(h_v), np.asarray(h_b)
    # triangles touching the 1e6 outlier are catastrophically conditioned
    # in f32, so rays that hit one only need statistical agreement
    outlier_faces = np.nonzero((faces == 11).any(axis=1))[0]
    touched = np.isin(np.asarray(f_b), outlier_faces) | np.isin(
        np.asarray(f_v), outlier_faces)
    assert np.array_equal(h_v[~touched], h_b[~touched])
    assert (h_v == h_b).mean() > 0.95
    both = h_b & h_v & ~touched
    np.testing.assert_allclose(np.asarray(t_v)[both], np.asarray(t_b)[both],
                               rtol=1e-3)
    occ_v, _, _ = bvh_mod.traverse(bvh, v0, e1, e2, ro, rd, 1e-5, 1.5,
                                   any_hit=True)
    occ_b = np.asarray(isect.occluded(scene, ro, rd, 1e-5, 1.5))
    assert (np.asarray(occ_v) == occ_b).mean() > 0.99
