"""Wavefront path-tracing integrator: `lax.scan` over bounces on SoA buffers.

This is the data-parallel replacement for the reference's divergent per-pixel
megakernel (reference core/tracing.py:117 PathTracer.trace, launched from
main_taichi.py:89). The reference defined SoA ray/hit buffers but never used
them (core/ray_taichi.py:10-75) — here they are the design: every bounce is
one batched intersection + shading step over the whole wavefront, with
terminated lanes masked instead of diverging.

Details:
- intersection backends: "pallas" (fused whole-table Pallas kernel,
  kernels/pallas_intersect.py; the GPU default for small scenes), "brute"
  (broadcast XLA path; the default on CPU and the correctness oracle),
  "matmul" (bilinear-form formulation as one matrix product), "watertight"
  (PBRT shear test, core/watertight.py — no shared-edge leaks), and "bvh"
  (accel/bvh.py, auto-selected past AUTO_BRUTE_MAX_TRIS);
- per-hit shading data comes from ONE (N, 16) row gather of a packed
  per-face table (v0|e1|e2|albedo|sign|emissive|sided) instead of many
  scattered small gathers;
- paired RNG draws: one threefry evaluation yields two uniforms.

Estimator modes (cfg.estimator):
  "reference" — reproduces core/tracing.py semantics: emissive hits add the
  hardcoded light color (tracing.py:120,129-139: beta at bounce 0, beta*cos
  after), throughput update attenuation*cos/pdf*(1/pi) with the 0/0 NaN
  guard collapsing to zero (tracing.py:145-149), and NEE without area pdf or
  1/pi: emissive*cos1*cos2/dist^2 (tracing.py:92-108).

  "pbrt" — physically based: scene emission, NEE with area-measure pdf +
  power-heuristic MIS (the algorithm of taichi_ref.py:368-397 and the
  unused tracing.py:56 sample_direct_lighting2), russian roulette, and the
  metal/dielectric materials of core/bsdf_taichi.py / taichi_ref.py:408-434.

Differentiability: the estimator is PATHWISE (reparameterized)
differentiable — sampled directions are smooth maps of the fixed uniforms
and scene geometry, so gradients flow through the whole bounce chain, and
fixed-seed finite differences of the estimator match jax.grad exactly
(tests/test_grad.py). Only genuinely discrete decisions (hit selection,
visibility booleans, RR/Schlick branch choices) are constant a.e. and carry
no gradient. All sqrt/normalize sites use the NaN-safe double-where guards
in core/sampling.py — a single 0-gradient NaN would poison the whole image.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from pyrenderer_tpu import rng
from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core import intersect as isect
from pyrenderer_tpu.core import sampling
from pyrenderer_tpu.core.camera import generate_rays
from pyrenderer_tpu.core.sampling import INV_PI
from pyrenderer_tpu.kernels import pallas_intersect as pk
from pyrenderer_tpu.scene.types import Camera, Scene

sg = jax.lax.stop_gradient

# Reference tracing.py:120 — emissive surfaces contribute this hardcoded
# color in "reference" estimator mode (scene emission is ignored there).
REF_LIGHT_COLOR = (0.9, 0.85, 0.7)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _safe_normalize(v):
    return sampling.safe_normalize(v)


# Largest triangle count that backend="auto" routes to the whole-table
# path, per platform. Above it "bvh" (stackless escape-pointer traversal,
# accel/bvh.py) takes over, prebuilt on host by maybe_build_accel.
# gpu: measured end to end through render_image on one NVIDIA H100 80GB
#   HBM3 (700 W power limit), procgen terrain at 512^2 / 4 spp, whole-
#   table kernel vs bvh: 4,062 tris 0.12 vs 0.47 s, 8,204 tris 0.23 vs
#   0.52 s, 16,212 tris 0.45 vs 0.56 s (PERF.md). The kernel grows
#   linearly and bvh barely, so they cross near 20k tris; 16,384 is the
#   largest power of two below the last measured kernel win.
# cpu: not measured; the CPU serves tests, and the cap keeps brute's
#   (N, T) temporaries small there.
AUTO_BRUTE_MAX_TRIS = {"gpu": 16384, "cpu": 4096}


def auto_brute_max_tris() -> int:
    """AUTO_BRUTE_MAX_TRIS of the running platform."""
    return AUTO_BRUTE_MAX_TRIS[jax.default_backend()]


def default_backend() -> str:
    """Whole-table backend of the running platform: the fused Pallas
    kernel on the GPU, the broadcast XLA path everywhere else."""
    return "pallas" if jax.default_backend() == "gpu" else "brute"


def resolve_backend(backend: str, n_tris: int, accel=None) -> str:
    """Turn "auto" into a concrete backend for a scene of `n_tris` faces.

    Small scenes: the platform's whole-table path (default_backend).
    Large scenes: "bvh" over the prebuilt accelerator (render_image and
    ProgressiveRenderer build one automatically via maybe_build_accel),
    else the whole-table path, which is correct but O(T), with a loud
    warning. Explicit backend strings pass through unchanged."""
    if backend != "auto":
        return backend
    if n_tris <= auto_brute_max_tris():
        return default_backend()
    if accel is None:
        import warnings

        warnings.warn(
            f"backend='auto' with {n_tris} triangles but no prebuilt "
            "accelerator: falling back to the O(T) whole-table path. "
            "Build one with core.integrator.maybe_build_accel(scene, "
            "'auto') and pass it as accel=... (render_image and "
            "ProgressiveRenderer do this automatically).",
            stacklevel=2,
        )
        return default_backend()
    return "bvh"


def light_area_pdf(scene: Scene):
    """(T,) area-measure pdf of sampling each light face via the uniform
    prim -> uniform face -> uniform area chain: 1 / (L * nf * area).
    Zero on non-light faces. Differentiable w.r.t. vertices."""
    v = scene.vertices
    f = scene.faces
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    area = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
    n_lights = scene.light_faces.shape[0]
    pdf = jnp.zeros(f.shape[0], v.dtype)
    for li in range(n_lights):  # static, tiny
        nf = scene.light_nfaces[li]
        faces = scene.light_faces[li]
        pdf = pdf.at[faces].set(
            1.0 / (n_lights * nf * jnp.maximum(area[faces], 1e-12))
        )
    return pdf


def pack_face_data(scene: Scene, extended: bool = False):
    """Per-face shading table, one row fetch per hit.

    Base (T, 16): v0|e1|e2|albedo|sign|emissive|sided|pad.
    Extended, for the pbrt estimator (T, 24): ... |mat_type|emission(3)|
    ior|roughness|light_pdf_A|pad.
    Built once per trace from scene arrays (differentiable w.r.t. vertices
    and albedo/emission).
    """
    v = scene.vertices
    f = scene.faces
    v0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - v0
    e2 = v[f[:, 2]] - v0
    mat = scene.face_material
    alb = scene.albedo[mat]
    dtype = v.dtype
    cols = [
        v0, e1, e2, alb,
        scene.normal_sign[:, None].astype(dtype),
        (scene.emissive[mat] > 0)[:, None].astype(dtype),
        (scene.sided[mat] > 0)[:, None].astype(dtype),
    ]
    if not extended:
        cols.append(jnp.zeros((f.shape[0], 1), dtype))
    else:
        cols += [
            scene.mat_type[mat][:, None].astype(dtype),
            scene.emission[mat],
            scene.ior[mat][:, None].astype(dtype),
            scene.roughness[mat][:, None].astype(dtype),
            light_area_pdf(scene)[:, None],
            jnp.zeros((f.shape[0], 2), dtype),
        ]
    return jnp.concatenate(cols, axis=1)


def pack_light_data(scene: Scene, use_emission: bool):
    """(L * F_max, 16) per-light-face table: v0|v1|v2|em|sign|pdf_A|pad.

    em = emitter albedo as vec3 in "reference" mode (reference
    core/bsdf.py:54 evaluate) or scene emission radiance in "pbrt" mode.
    """
    v = scene.vertices
    lf = scene.light_faces.reshape(-1)
    f = scene.faces[lf]
    mat = scene.face_material[lf]
    em = scene.emission[mat] if use_emission else scene.albedo[mat]
    dtype = v.dtype
    cols = [
        v[f[:, 0]], v[f[:, 1]], v[f[:, 2]], em,
        scene.normal_sign[lf][:, None].astype(dtype),
        light_area_pdf(scene)[lf][:, None],
        jnp.zeros((lf.shape[0], 2), dtype),
    ]
    return jnp.concatenate(cols, axis=1)


class TraceTables(object):
    """Per-scene device tables shared across samples/passes of one jit.

    backend "bvh" requires a prebuilt accelerator (accel/bvh.py build_bvh
    runs on concrete host arrays: topology can't be traced) passed as
    `accel`.

    backend "custom" (built via TraceTables.custom) routes intersection and
    per-face shading fetches through caller-supplied closures — the hook the
    geometry-sharded path (dist/geometry.py) uses so each device only holds
    its own triangle shard."""

    closest_fn = None
    any_hit_fn = None
    fetch_face_fn = None

    @classmethod
    def custom(cls, face_data, light_data, closest_fn, any_hit_fn,
               fetch_face_fn=None):
        """Build tables around caller-supplied intersection closures.

        closest_fn(ro, rd, t1) -> (hit, t, tri); any_hit_fn(ro, rd, t1) ->
        occluded bool; fetch_face_fn(tri) -> (N, K) packed face rows
        (defaults to a fetch from face_data, which may be a local shard)."""
        self = cls.__new__(cls)
        self.backend = "custom"
        self.face_data = face_data
        self.light_data = light_data
        self.accel = None
        self.tri_table = None
        self.closest_fn = closest_fn
        self.any_hit_fn = any_hit_fn
        self.fetch_face_fn = fetch_face_fn
        return self

    def fetch_face(self, tri):
        """Packed shading row per hit id (a row gather; its cotangent is a
        scatter-add into the table, so grads reach the scene)."""
        if self.fetch_face_fn is not None:
            return self.fetch_face_fn(tri)
        return jnp.take(self.face_data, tri, axis=0)

    def __init__(self, scene: Scene, cfg: RenderConfig, backend: str, accel=None):
        backend = resolve_backend(backend, scene.faces.shape[0], accel)
        self.backend = backend
        extended = cfg.estimator != "reference"
        self.face_data = pack_face_data(scene, extended=extended)
        self.light_data = pack_light_data(scene, use_emission=extended)
        self.accel = accel
        self.tri_table = None
        if backend == "pallas":
            self.tri_table = pk.pack_triangles(sg(scene.vertices), scene.faces)
        elif backend == "matmul":
            self.tri_table = isect.build_tri_matrix(scene)
        elif backend == "bvh":
            if accel is None:
                raise ValueError(
                    "backend='bvh' needs a prebuilt accelerator "
                    "(core.integrator.maybe_build_accel / accel.bvh.build_bvh)"
                    " passed as accel=..."
                )
            v = sg(scene.vertices)
            ordered = scene.faces[accel.order]
            self.bvh_v0 = v[ordered[:, 0]]
            self.bvh_e1 = v[ordered[:, 1]] - self.bvh_v0
            self.bvh_e2 = v[ordered[:, 2]] - self.bvh_v0


def _closest(scene, tables, cfg, ro, rd, t1):
    b = tables.backend
    if b == "custom":
        return tables.closest_fn(ro, rd, t1)
    if b == "pallas":
        return pk.closest_hit(tables.tri_table, ro, rd, cfg.t_min, t1)
    if b == "matmul":
        return isect.intersect_matmul(scene, ro, rd, cfg.t_min, t1, tables.tri_table)
    if b == "bvh":
        from pyrenderer_tpu.accel import bvh as bvh_mod

        return bvh_mod.traverse(
            tables.accel, tables.bvh_v0, tables.bvh_e1, tables.bvh_e2,
            ro, rd, cfg.t_min, t1,
        )
    if b == "watertight":
        from pyrenderer_tpu.core.watertight import intersect_watertight

        return intersect_watertight(scene, ro, rd, cfg.t_min, t1)
    return isect.intersect_brute(scene, ro, rd, cfg.t_min, t1)


def _any_hit(scene, tables, cfg, ro, rd, t1):
    b = tables.backend
    if b == "custom":
        return tables.any_hit_fn(ro, rd, t1)
    if b == "pallas":
        return pk.occluded(tables.tri_table, ro, rd, cfg.t_min, t1)
    if b == "matmul":
        return isect.occluded_matmul(scene, ro, rd, cfg.t_min, t1, tables.tri_table)
    if b == "bvh":
        from pyrenderer_tpu.accel import bvh as bvh_mod

        hit, _, _ = bvh_mod.traverse(
            tables.accel, tables.bvh_v0, tables.bvh_e1, tables.bvh_e2,
            ro, rd, cfg.t_min, t1, any_hit=True,
        )
        return hit
    if b == "watertight":
        from pyrenderer_tpu.core.watertight import occluded_watertight

        return occluded_watertight(scene, ro, rd, cfg.t_min, t1)
    return isect.occluded(scene, ro, rd, cfg.t_min, t1)


def _sample_light_point(scene, tables, pixel_id, sample_id, bounce, seed, dtype):
    """Uniform light prim -> uniform face -> sqrt-barycentric point.

    Reference: intersection_taichi.py:194 sample_a_light (uniform prim pick,
    consuming a draw only when >1 light) -> shapes.py:63 sample_a_point
    (randInt face, sqrt-barycentric). One packed-row gather per ray.
    Returns (p2, n2, em).
    """
    n_lights, f_max = scene.light_faces.shape
    if n_lights > 1:
        up = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_LIGHT_PRIM, dtype)
        li = jnp.clip((up * n_lights).astype(jnp.int32), 0, n_lights - 1)
    else:
        li = jnp.zeros(pixel_id.shape, jnp.int32)
    nf = scene.light_nfaces[li].astype(dtype)
    uf = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_LIGHT_FACE, dtype)
    fi = jnp.clip((uf * nf).astype(jnp.int32), 0, scene.light_nfaces[li] - 1)
    row = jnp.take(tables.light_data, li * f_max + fi, axis=0)  # (N, 16)
    v0, v1, v2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
    em = row[:, 9:12]
    sign = row[:, 12]
    pdf_a = row[:, 13]
    u, v = rng.uniform2(seed, pixel_id, sample_id, bounce, rng.U_LIGHT_U, dtype)
    p2 = sampling.sample_triangle_point(v0, v1, v2, u, v)
    n2 = sign[:, None] * _safe_normalize(jnp.cross(v1 - v0, v2 - v0))
    return p2, n2, em, pdf_a


def trace_reference(
    scene: Scene,
    cfg: RenderConfig,
    ro,
    rd,
    pixel_id,
    sample_id,
    seed: int,
    tables: TraceTables | None = None,
    backend: str = "auto",
    with_stats: bool = False,
    collect_paths: bool = False,
):
    """Radiance for a wavefront of rays, 'reference' estimator semantics.

    ro, rd: (N, 3); pixel_id, sample_id: (N,) uint32. Returns (N, 3), or
    (radiance, rays_traced) when with_stats — rays_traced counts closest-hit
    rays for live lanes plus NEE shadow rays (the honest Mrays/s numerator;
    masked-dead lanes are excluded even though the SIMD work still happens).
    """
    dtype = ro.dtype
    if tables is None:
        tables = TraceTables(scene, cfg, backend)
    n = ro.shape[0]
    pixel_id = jnp.broadcast_to(pixel_id, (n,)).astype(jnp.uint32)
    sample_id = jnp.broadcast_to(sample_id, (n,)).astype(jnp.uint32)

    light_color = jnp.asarray(REF_LIGHT_COLOR, dtype)

    def bounce_step(state, bounce):
        ro, rd, beta, radiance, alive, n_rays = state
        alive_in = alive
        n_rays = n_rays + jnp.sum(alive, dtype=jnp.float32)

        # dead lanes trace with t1 = 0: every result is masked by `alive`
        # below anyway, and a zero interval lets the accelerated backends
        # (bvh, the any-hit kernel) cull their work instead of re-walking
        # stale rays
        t_clip = jnp.where(alive, jnp.asarray(cfg.t_max, dtype), 0.0)
        hit, _, tri = _closest(scene, tables, cfg, ro, rd, t_clip)
        tri = sg(jnp.maximum(tri, 0))
        hit = sg(hit)

        # One packed-row fetch; then
        # differentiable re-evaluation of the selected triangle's geometry
        # (the selection itself is detached).
        row = tables.fetch_face(tri)
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        albedo = row[:, 9:12]
        sign = row[:, 12]
        emissive = row[:, 13] > 0.5
        sided = row[:, 14] > 0.5

        c_e1_d = jnp.cross(e1, rd)
        det = _dot(c_e1_d, e2)
        safe_det = jnp.where(det == 0, 1.0, det)
        s = ro - v0
        c_s_e2 = jnp.cross(s, e2)
        t = -_dot(c_s_e2, e1) / safe_det
        p = ro + t[:, None] * rd

        n_geo = sign[:, None] * _safe_normalize(jnp.cross(e1, e2))
        flip = (~sided) & (_dot(n_geo, -rd) < 0)
        nrm = jnp.where(flip[:, None], -n_geo, n_geo)

        # Emissive hit (reference tracing.py:129-139): hardcoded light color,
        # weight 1 at bounce 0, cos afterwards; path terminates either way.
        d1 = _dot(-rd, nrm)
        is_light_hit = alive & hit & emissive
        le_weight = jnp.where(bounce == 0, jnp.ones_like(d1), d1)
        add_light = (is_light_hit & (d1 > 0))[:, None]
        radiance = radiance + jnp.where(add_light, light_color * beta * le_weight[:, None], 0.0)

        alive = alive & hit & (~emissive)

        # Lambert cosine sample in the shading frame (reference bsdf.py:30
        # scatter + shapes.py:105-109 frame rotation; pdf = |n·wi|/pi).
        # Pathwise (reparameterized) differentiability: wi is a smooth map of
        # the normal and the fixed uniforms, so gradients flow through the
        # sampled direction into later bounces — this is what makes
        # fixed-seed finite differences match jax.grad (tests/test_grad.py).
        u1, u2 = rng.uniform2(seed, pixel_id, sample_id, bounce, rng.U_BSDF_0, dtype)
        wi_local = sampling.cosine_sample_hemisphere(u1, u2)
        wi = sampling.rotate_z_to(nrm, wi_local)
        cos_wi = _dot(nrm, wi)
        pdf = jnp.abs(cos_wi) * INV_PI

        # tracing.py:145-149: attenuation*cos/pdf*(1/pi); NaN guard (0/0 when
        # n·wi == 0) recomputes with pdf=1e-4, which yields exactly 0.
        safe_pdf = jnp.where(pdf == 0, 1.0, pdf)
        scale = jnp.maximum(0.0, cos_wi) / safe_pdf * INV_PI
        new_beta = jnp.where((cos_wi != 0)[:, None], albedo * scale[:, None], 0.0)
        beta = jnp.where(alive[:, None], beta * new_beta, beta)

        # NEE (reference tracing.py:92-108): single light point, geometric
        # coupling emissive*cos1*cos2/dist^2, visibility by shadow ray.
        # Divergence from reference: distance along the ray (norm) instead of
        # the x-component ratio (tracing.py:100), and a relative margin so the
        # sampled light face itself never occludes.
        p2, n2, em, _ = _sample_light_point(
            scene, tables, pixel_id, sample_id, bounce, seed, dtype
        )
        to_light = p2 - p
        dist_sq = jnp.maximum(_dot(to_light, to_light), 1e-12)
        dist = jnp.sqrt(dist_sq)
        w = to_light / dist[:, None]
        shadow_t1 = jnp.where(alive, sg(dist) * (1.0 - cfg.shadow_eps), 0.0)
        occ = _any_hit(scene, tables, cfg, sg(p), sg(w), shadow_t1)
        n_rays = n_rays + jnp.sum(alive, dtype=jnp.float32)
        dot1 = _dot(nrm, w)
        dot2 = _dot(n2, -w)
        nee_ok = (alive & (~occ) & (dot1 > 0) & (dot2 > 0))[:, None]
        contrib = em * (dot1 * dot2 / dist_sq)[:, None]
        radiance = radiance + jnp.where(nee_ok, beta * contrib, 0.0)

        prev_alive = alive_in
        ro = jnp.where(alive[:, None], p, ro)
        rd = jnp.where(alive[:, None], wi, rd)
        ys = None
        if collect_paths:
            # per-bounce hit records (the RayLogger generalization, SURVEY
            # §5.5): hit point, shading normal, next direction, t, face id,
            # masks and running throughput
            ys = dict(
                hit_point=p, normal=nrm, wi=wi, t=t, tri=tri,
                hit=hit & prev_alive, alive=alive, beta=beta,
                radiance=radiance, nee_visible=(~occ) & alive,
                light_point=p2,
            )
        return (ro, rd, beta, radiance, alive, n_rays), ys

    # Carries are derived from `ro` (not fresh constants) so that under
    # shard_map they inherit the mesh-varying type the scan body produces.
    zeros = ro * 0
    init = (
        ro,
        rd,
        zeros + 1.0,                            # beta
        zeros,                                  # radiance
        zeros[:, 0] == 0,                       # alive (all True)
        jnp.sum(zeros[:, 0]).astype(jnp.float32),  # n_rays
    )
    final, ys = jax.lax.scan(
        bounce_step, init, jnp.arange(cfg.max_bounces, dtype=jnp.uint32)
    )
    radiance, n_rays = final[3], final[5]
    if collect_paths:
        return radiance, ys
    if with_stats:
        return radiance, n_rays
    return radiance


def render_sample(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    seed: int,
    sample_id,
    pixel_x,
    pixel_y,
    tables: TraceTables | None = None,
    backend: str = "auto",
    accel=None,
):
    """Radiance for one sample of a block of pixels. pixel_x/y: (N,) int32."""
    w, _h = camera.resolution
    pixel_id = (pixel_y * w + pixel_x).astype(jnp.uint32)
    sample_arr = jnp.full_like(pixel_id, sample_id) if jnp.ndim(sample_id) == 0 else sample_id
    strata = int(math.ceil(math.sqrt(cfg.spp))) if cfg.stratified else 0
    ro, rd = generate_rays(camera, pixel_x, pixel_y, sample_arr, seed, strata=strata)
    if tables is None:
        tables = TraceTables(scene, cfg, backend, accel=accel)
    if cfg.estimator == "reference":
        return trace_reference(
            scene, cfg, ro, rd, pixel_id, sample_arr, seed, tables=tables
        )
    from pyrenderer_tpu.core.integrator_pbrt import trace_pbrt

    return trace_pbrt(
        scene, cfg, ro, rd, pixel_id, sample_arr, seed, tables=tables
    )


@partial(jax.jit, static_argnames=("cfg", "seed", "spp", "backend"))
def render_block(
    scene, camera, cfg: RenderConfig, seed: int, spp: int, pixel_x, pixel_y,
    backend: str = "auto", accel=None,
):
    """Mean radiance over `spp` samples for a pixel block — one jitted unit."""
    tables = TraceTables(scene, cfg, backend, accel=accel)

    def one_sample(s):
        return render_sample(
            scene, camera, cfg, seed, s, pixel_x, pixel_y, tables=tables
        )

    total = jax.lax.map(one_sample, jnp.arange(spp, dtype=jnp.uint32)).sum(axis=0)
    return total / spp


def maybe_build_accel(scene: Scene, backend: str, accel=None):
    """Host-side accelerator auto-build for the entry points (driver,
    render_image).

    Builds a FlatBVH for "bvh", and for "auto" past auto_brute_max_tris().
    Must run on concrete (non-traced) scene arrays — call before entering
    jit."""
    if accel is not None:
        return accel
    if backend == "bvh" or (
        backend == "auto" and scene.faces.shape[0] > auto_brute_max_tris()
    ):
        from pyrenderer_tpu.accel.bvh import build_bvh

        return build_bvh(scene.vertices, scene.faces)
    return None


# back-compat alias (round-1 name; bvh= keeps its meaning for FlatBVH)
def maybe_build_bvh(scene: Scene, backend: str, bvh=None):
    return maybe_build_accel(scene, backend, accel=bvh)


def render_image(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    chunk: int = 1 << 16,
    backend: str = "auto",
    accel=None,
    bvh=None,
):
    """Full-frame mean-radiance HDR image, (H, W, 3), row 0 at the top.

    Host-side loop over pixel chunks; each chunk is one jitted
    render_block. Progressive/accumulating rendering lives in
    render/driver.py — this is the simple whole-frame entry.
    """
    import numpy as np

    from pyrenderer_tpu.core.camera import morton_pixel_order

    accel = maybe_build_accel(scene, backend, accel if accel is not None else bvh)
    # resolve the backend OUTSIDE jit: the concrete string becomes part of
    # render_block's static cache key
    backend = resolve_backend(backend, scene.faces.shape[0], accel)
    w, h = camera.resolution
    ys, xs = np.mgrid[0:h, 0:w]
    # trace pixels in Morton order: each run of consecutive rays is then a
    # compact screen block, so neighbouring threads walk similar BVH paths
    # (invisible to the estimator — RNG is keyed on pixel id)
    perm, inv_perm = morton_pixel_order(w, h)
    xs = jnp.asarray(xs.reshape(-1)[perm], jnp.int32)
    ys = jnp.asarray(ys.reshape(-1)[perm], jnp.int32)
    out = []
    for start in range(0, w * h, chunk):
        px = xs[start : start + chunk]
        py = ys[start : start + chunk]
        out.append(render_block(scene, camera, cfg, cfg.seed, cfg.spp, px, py, backend, accel))
    img = jnp.concatenate(out)[inv_perm].reshape(h, w, 3)
    # pixel y counts up from the bottom (taichi GUI convention,
    # main_taichi.py:89); flip so row 0 is the top of the image.
    return img[::-1]
