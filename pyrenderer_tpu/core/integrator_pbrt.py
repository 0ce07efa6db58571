"""Physically-based wavefront estimator ("pbrt" mode).

The algorithmically complete integrator the reference only sketched: its
standalone tracer (reference taichi_ref.py:368-397 sample_direct_light)
carries full MIS NEE over lambert/specular/glass materials, and its unused
`sample_direct_lighting2` (reference core/tracing.py:56-90) does area+brdf
two-strategy MIS with the power heuristic — but neither is wired into the
scene-driven renderer, which also lacks russian roulette and ignores scene
emission. This module provides all of it, wavefront-style:

- emission on hit with MIS against the light sampler (power heuristic,
  weight 1 at the camera vertex and after specular bounces);
- NEE from diffuse vertices: solid-angle-converted area pdf, MIS against
  the bsdf pdf;
- materials: lambert / metal (fuzzy mirror) / dielectric (Schlick+Snell),
  per core/bsdf.py;
- russian roulette on throughput after cfg.russian_roulette_start bounces.

RNG slots per bounce (oracle ref/scalar_pbrt.py mirrors exactly):
  uniform2(U_BSDF_0) -> (u1, u2)  lambert cosine / metal fuzz direction
  uniform(U_BSDF_2)  -> u3        metal fuzz radius / dielectric choice
  [uniform(U_LIGHT_PRIM) iff >1 light] uniform(U_LIGHT_FACE),
  uniform2(U_LIGHT_U) -> (u, v)   light point
  uniform(U_RR)      -> rr
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pyrenderer_tpu import rng
from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core import bsdf, sampling
from pyrenderer_tpu.core.sampling import INV_PI
from pyrenderer_tpu.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERT,
    MAT_METAL,
    Scene,
)

sg = jax.lax.stop_gradient


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _safe_normalize(v):
    return sampling.safe_normalize(v)


def _match_vma(x, ref):
    """Promote x's varying-manual-axes to ref's (no-op outside shard_map).

    Needed so `lax.scan` carries typecheck under `check_vma=True` when a
    body output is derived purely from collective-combined (invariant)
    values but its carry slot entered varying."""
    need = jax.typeof(ref).vma - jax.typeof(x).vma
    if not need:
        return x
    return jax.lax.pcast(x, tuple(sorted(need)), to="varying")


def trace_pbrt(
    scene: Scene,
    cfg: RenderConfig,
    ro,
    rd,
    pixel_id,
    sample_id,
    seed: int,
    tables=None,
    backend: str = "auto",
    with_stats: bool = False,
):
    from pyrenderer_tpu.core.integrator import (
        TraceTables,
        _any_hit,
        _closest,
        _sample_light_point,
    )

    dtype = ro.dtype
    if tables is None:
        tables = TraceTables(scene, cfg, backend)
    n = ro.shape[0]
    pixel_id = jnp.broadcast_to(pixel_id, (n,)).astype(jnp.uint32)
    sample_id = jnp.broadcast_to(sample_id, (n,)).astype(jnp.uint32)

    def bounce_step(state, bounce):
        ro, rd, beta, radiance, alive, prev_pdf, prev_spec, n_rays = state
        n_rays = n_rays + jnp.sum(alive, dtype=jnp.float32)

        # dead lanes trace a zero interval — see trace_reference
        t_clip = jnp.where(alive, jnp.asarray(cfg.t_max, dtype), 0.0)
        hit, _, tri = _closest(scene, tables, cfg, ro, rd, t_clip)
        tri = sg(jnp.maximum(tri, 0))
        hit = sg(hit)

        row = tables.fetch_face(tri)
        v0, e1, e2 = row[:, 0:3], row[:, 3:6], row[:, 6:9]
        albedo = row[:, 9:12]
        sign = row[:, 12]
        emissive = row[:, 13] > 0.5
        sided = row[:, 14] > 0.5
        mat_type = row[:, 15].astype(jnp.int32)
        emission = row[:, 16:19]
        ior = row[:, 19]
        roughness = row[:, 20]
        hit_pdf_a = row[:, 21]

        # differentiable hit geometry (selection detached)
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

        # ---- emission with MIS against the light sampler ----
        cos_l = _dot(-rd, nrm)
        dist_sq_hit = jnp.maximum(t * t, 1e-12)
        # pdf of having sampled this point via NEE, in solid angle
        pdf_light_sa = hit_pdf_a * dist_sq_hit / jnp.maximum(cos_l, 1e-6)
        w_mis = jnp.where(
            (bounce == 0) | prev_spec,
            1.0,
            bsdf.power_heuristic(prev_pdf, pdf_light_sa),
        )
        add_em = (alive & hit & emissive & (cos_l > 0))[:, None]
        radiance = radiance + jnp.where(add_em, emission * beta * w_mis[:, None], 0.0)

        alive = alive & hit & (~emissive)
        is_lambert = mat_type == MAT_LAMBERT
        is_metal = mat_type == MAT_METAL
        is_diel = mat_type == MAT_DIELECTRIC

        # ---- NEE from diffuse vertices (MIS partner) ----
        p2, n2, em, pdf_a = _sample_light_point(
            scene, tables, pixel_id, sample_id, bounce, seed, dtype
        )
        to_light = p2 - p
        dist_sq = jnp.maximum(_dot(to_light, to_light), 1e-12)
        dist = jnp.sqrt(dist_sq)
        wl = to_light / dist[:, None]
        cos_surf = _dot(nrm, wl)
        cos_light = _dot(n2, -wl)
        nee_candidate = alive & is_lambert & (cos_surf > 0) & (cos_light > 0)
        shadow_t1 = jnp.where(
            nee_candidate, sg(dist) * (1.0 - cfg.shadow_eps), 0.0
        )
        occ = _any_hit(scene, tables, cfg, sg(p), sg(wl), shadow_t1)
        n_rays = n_rays + jnp.sum(alive, dtype=jnp.float32)
        pdf_nee_sa = pdf_a * dist_sq / jnp.maximum(cos_light, 1e-6)
        pdf_bsdf_here = bsdf.lambert_pdf(nrm, wl)
        w_nee = bsdf.power_heuristic(pdf_nee_sa, pdf_bsdf_here)
        f_val = albedo * INV_PI
        contrib = f_val * em * (w_nee * cos_surf / jnp.maximum(pdf_nee_sa, 1e-12))[:, None]
        radiance = radiance + jnp.where(
            (nee_candidate & (~occ))[:, None], beta * contrib, 0.0
        )

        # ---- BSDF sampling ----
        u1, u2 = rng.uniform2(seed, pixel_id, sample_id, bounce, rng.U_BSDF_0, dtype)
        u3 = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_BSDF_2, dtype)

        wi_l, pdf_l = bsdf.lambert_sample(nrm, u1, u2)
        wi_m, metal_ok = bsdf.metal_sample(rd, nrm, roughness, u1, u2, u3)
        wi_d = bsdf.dielectric_sample(rd, n_geo, ior, u3)

        wi = jnp.where(
            is_lambert[:, None], wi_l, jnp.where(is_metal[:, None], wi_m, wi_d)
        )
        # throughput scale: lambert f*cos/pdf = albedo; metal albedo (or die);
        # dielectric unity (clear glass)
        scale_l = albedo
        scale_m = albedo * metal_ok[:, None].astype(dtype)
        scale_d = jnp.ones_like(albedo)
        scale = jnp.where(
            is_lambert[:, None], scale_l, jnp.where(is_metal[:, None], scale_m, scale_d)
        )
        beta = jnp.where(alive[:, None], beta * scale, beta)
        alive = alive & jnp.where(is_metal, metal_ok, True)

        prev_pdf = jnp.where(is_lambert, pdf_l, 1.0)
        # match the carry's varying-manual-axes: is_lambert flows from the
        # psum-combined face fetch and is typed shard-invariant under a
        # geometry-sharded shard_map (dist/geometry.py, check_vma=True),
        # while the carry slot entered shard-varying via the promoted rays
        prev_spec = _match_vma(~is_lambert, state[6])

        # ---- russian roulette (absent in the reference; SURVEY §7 north-star) ----
        u_rr = rng.uniform(seed, pixel_id, sample_id, bounce, rng.U_RR, dtype)
        p_cont = jnp.clip(jnp.max(beta, axis=-1), 0.05, 1.0)
        do_rr = bounce >= cfg.russian_roulette_start
        survive = (~do_rr) | (u_rr < p_cont)
        rr_scale = jnp.where(do_rr, 1.0 / p_cont, 1.0)
        beta = jnp.where((alive & survive)[:, None], beta * rr_scale[:, None], beta)
        alive = alive & survive

        ro = jnp.where(alive[:, None], p, ro)
        rd = jnp.where(alive[:, None], wi, rd)
        return (ro, rd, beta, radiance, alive, prev_pdf, prev_spec, n_rays), None

    zeros = ro * 0
    init = (
        ro,
        rd,
        zeros + 1.0,
        zeros,
        zeros[:, 0] == 0,
        zeros[:, 0] + 1.0,      # prev_pdf
        zeros[:, 0] != 0,       # prev_spec (False)
        jnp.sum(zeros[:, 0]).astype(jnp.float32),
    )
    final, _ = jax.lax.scan(
        bounce_step, init, jnp.arange(cfg.max_bounces, dtype=jnp.uint32)
    )
    radiance, n_rays = final[3], final[7]
    if with_stats:
        return radiance, n_rays
    return radiance
