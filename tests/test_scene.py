"""Scene loader tests against independently computed expectations."""

import numpy as np
import pytest

from pyrenderer_tpu.scene.tungsten import load_tungsten
from pyrenderer_tpu.scene.transforms import (
    look_at_rowvec,
    make_transformation_matrix,
)
from pyrenderer_tpu.scene.types import MAT_LAMBERT, MAT_LIGHT


@pytest.fixture(scope="module")
def cornell(cornell_path):
    return load_tungsten(cornell_path, dtype=np.float64)


def test_counts(cornell):
    scene, camera, cfg = cornell
    # 5 wall quads * 2 + 2 cubes * 12 + light quad * 2 = 36 triangles
    assert scene.faces.shape == (36, 3)
    assert scene.vertices.shape == (5 * 4 + 2 * 24 + 4, 3)
    # 8 bsdfs + 1 per-primitive emission clone of "Light"
    assert scene.albedo.shape[0] == 9
    assert scene.light_faces.shape == (1, 2)
    assert int(scene.light_nfaces[0]) == 2


def test_floor_geometry(cornell):
    scene, _, _ = cornell
    # Floor: scale (2,4,2) then rotate 90 about y; quad template spans
    # (+-0.5, 0, +-0.5) -> world xz extent [-1,1]x[-1,1] at y=0.
    floor_faces = scene.faces[:2]
    verts = np.asarray(scene.vertices)[np.unique(floor_faces)]
    assert np.allclose(verts[:, 1], 0, atol=1e-12)
    assert np.allclose(sorted(verts[:, 0]), [-1, -1, 1, 1], atol=1e-9)
    assert np.allclose(sorted(verts[:, 2]), [-1, -1, 1, 1], atol=1e-9)


def test_normals_point_inward(cornell):
    """Stored per-face normals (sign * cross) should point into the box."""
    scene, _, _ = cornell
    v = np.asarray(scene.vertices)
    f = np.asarray(scene.faces)
    sign = np.asarray(scene.normal_sign)
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    n = np.cross(e1, e2)
    n = sign[:, None] * n / np.linalg.norm(n, axis=1, keepdims=True)
    # floor (faces 0,1) normal up; ceiling (2,3) down; back wall (4,5) +z
    assert np.allclose(n[0], [0, 1, 0], atol=1e-6)
    assert np.allclose(n[1], [0, 1, 0], atol=1e-6)
    assert np.allclose(n[2], [0, -1, 0], atol=1e-6)
    assert np.allclose(n[4], [0, 0, 1], atol=1e-6)
    # light (last two faces) points down toward the floor
    assert np.allclose(n[34], [0, -1, 0], atol=1e-5)
    assert np.allclose(n[35], [0, -1, 0], atol=1e-5)


def test_materials(cornell):
    scene, _, _ = cornell
    assert int(scene.mat_type[0]) == MAT_LAMBERT
    assert np.allclose(np.asarray(scene.albedo)[0], [0.63, 0.065, 0.05])
    light_mat = int(np.asarray(scene.face_material)[34])
    assert int(scene.mat_type[light_mat]) == MAT_LIGHT
    assert int(scene.emissive[light_mat]) == 1
    assert np.allclose(np.asarray(scene.emission)[light_mat], [17, 12, 4])
    assert np.allclose(np.asarray(scene.albedo)[light_mat], [1, 1, 1])


def test_camera_matrix(cornell):
    _, camera, _ = cornell
    # eye (0,1,6.8) looking at (0,1,0): view rotation is identity,
    # iview translation row recovers the eye.
    iview = np.asarray(camera.iview)
    assert np.allclose(iview[3, :3], [0, 1, 6.8], atol=1e-9)
    assert np.allclose(iview[:3, :3], np.eye(3), atol=1e-9)
    assert camera.resolution == (1024, 1024)


def test_config(cornell):
    _, _, cfg = cornell
    assert cfg.max_bounces == 16
    assert cfg.spp == 64
    # scene.json:277 asks for "filmic" — honored directly (the reference
    # parsed and ignored it; round 1 aliased it to reinhard)
    assert cfg.tonemap == "filmic"


def test_trs_composition_order():
    # T @ R @ S: scale happens first in object space.
    m = make_transformation_matrix(
        {"position": [1, 2, 3], "rotation": [0, 90, 0], "scale": [2, 1, 1]}
    )
    p = m @ np.array([1.0, 0, 0, 1])
    # scale x2 -> (2,0,0); rotate +90 about y -> (0,0,-2); translate -> (1,2,1)
    assert np.allclose(p[:3], [1, 2, 1], atol=1e-9)


def test_look_at_rowvec_roundtrip():
    eye = np.array([1.0, 2.0, 3.0])
    view = look_at_rowvec(eye, [0, 0, 0], [0, 1, 0])
    # eye maps to the camera-space origin under the row-vector convention
    homo = np.array([*eye, 1.0])
    assert np.allclose(homo @ view, [0, 0, 0, 1], atol=1e-12)


def test_validate_scene_gate(cornell_path):
    """build_scene rejects structurally broken scenes at load time
    (out-of-range face indices used to load fine and fail obscurely)."""
    import jax.numpy as jnp

    from pyrenderer_tpu.utils.checks import validate_scene

    scene, _, _ = load_tungsten(cornell_path)
    validate_scene(scene)  # the good scene passes
    bad = scene._replace(faces=jnp.asarray(scene.faces).at[0, 0].set(10_000))
    with pytest.raises(ValueError, match="face indices"):
        validate_scene(bad)


def test_resolve_backend_by_count():
    from pyrenderer_tpu.core.integrator import (
        auto_brute_max_tris,
        resolve_backend,
    )

    small, big = 36, auto_brute_max_tris() + 1
    assert resolve_backend("brute", big, False) == "brute"  # explicit wins
    assert resolve_backend("auto", small, False) in ("pallas", "brute")
    # large scene with a prebuilt accelerator -> bvh
    assert resolve_backend("auto", big, True) == "bvh"


def test_resolve_backend_warns_on_missing_accel():
    """auto + large scene + no accel falls back to O(T) with a loud hint
    at maybe_build_accel."""
    import warnings

    from pyrenderer_tpu.core.integrator import (
        auto_brute_max_tris,
        resolve_backend,
    )

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resolve_backend("auto", auto_brute_max_tris() + 1, None)
    assert any("maybe_build_accel" in str(w.message) for w in caught)

    # no warning when an accel is supplied or the scene is small
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        resolve_backend("auto", 36, None)
    assert not caught
