"""Native C++ SAH BVH builder tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pyrenderer_tpu import native
from pyrenderer_tpu.accel import bvh as bvh_mod
from tests.test_bvh import _mesh_scene, make_sphere_mesh


def test_native_library_builds():
    lib = native.load_library()
    assert lib is not None, "g++ compile of bvh_builder.cpp failed"


def test_sah_structure_and_traversal_agreement():
    verts, faces = make_sphere_mesh(16, 24)
    scene = _mesh_scene(verts, faces)
    sah = bvh_mod.build_bvh(verts, faces, method="sah")
    lbvh = bvh_mod.build_lbvh(verts, faces)

    # leaves cover every triangle once
    first = np.asarray(sah.first)
    count = np.asarray(sah.count)
    covered = []
    for i in range(sah.n_nodes):
        if count[i] > 0:
            covered.extend(range(first[i], first[i] + count[i]))
    assert sorted(np.asarray(sah.order)[covered].tolist()) == list(
        range(faces.shape[0])
    )
    escape = np.asarray(sah.escape)
    assert escape[0] == -1
    assert all(e == -1 or e > i for i, e in enumerate(escape))

    # identical hits through both trees
    def tris(b):
        ordered = scene.faces[b.order]
        v = scene.vertices
        v0 = v[ordered[:, 0]]
        return v0, v[ordered[:, 1]] - v0, v[ordered[:, 2]] - v0

    rs = np.random.RandomState(1)
    n = 256
    ro = jnp.asarray(rs.uniform(-2, 2, (n, 3)), jnp.float32)
    rd = rs.normal(size=(n, 3))
    rd = jnp.asarray(rd / np.linalg.norm(rd, axis=1, keepdims=True), jnp.float32)
    h1, t1, tri1 = bvh_mod.traverse(sah, *tris(sah), ro, rd, 1e-5, 1e5)
    h2, t2, tri2 = bvh_mod.traverse(lbvh, *tris(lbvh), ro, rd, 1e-5, 1e5)
    assert np.array_equal(np.asarray(h1), np.asarray(h2))
    hits = np.asarray(h1)
    np.testing.assert_allclose(np.asarray(t1)[hits], np.asarray(t2)[hits], rtol=1e-5)


def test_sah_quality_not_worse():
    """SAH should touch no more nodes than the LBVH on average (coarse
    proxy: sum of leaf-subtree surface areas weighted by counts)."""
    verts, faces = make_sphere_mesh(16, 24)
    sah = bvh_mod.build_bvh(verts, faces, method="sah")
    lbvh = bvh_mod.build_lbvh(verts, faces)

    def cost(b):
        mn = np.asarray(b.bbox_min)
        mx = np.asarray(b.bbox_max)
        d = np.maximum(mx - mn, 0)
        sa = 2 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
        return sa.sum()

    assert cost(sah) <= cost(lbvh) * 1.1
