"""Headline benchmark: Mrays/s on one GPU at 4 bounces.

Prints ONE JSON line: {"metric", "value", "unit", "device"}, where device
is {"platform", "kind", "count"} as JAX reports them. The card's name and
power limit go to stderr. Refuses to run on anything but a GPU.

Rays counted = live closest-hit rays + NEE shadow rays (dead masked lanes
excluded), as accumulated inside the integrator's bounce scan.

Env knobs:
  BENCH_SCENE   cornell (default, the headline 36-tri Bitterli box) |
                spheres | terrain8k | terrain100k | terrain330k |
                terrain500k | blob82k — procgen large scenes
                (scene/procgen.py) go through the BVH accelerator
  BENCH_BACKEND auto (default) | pallas | matmul | brute | bvh | watertight
  BENCH_SPP     timed full-frame passes (default 16; 4 for large scenes)
  BENCH_RES     resolution (default 1024; 512 for large scenes)
  BENCH_CHUNK   rays per dispatch chunk (default 2^16 = a 256x256 Morton
                screen block)
  BENCH_ESTIMATOR  reference (default) | pbrt
"""

import json
import os
import sys
import time
from functools import partial

import numpy as np

SCENES = {
    # name -> (loader kwargs, default res, default spp, metric name)
    "cornell": (None, 1024, 16, "cornell_box_4bounce_mrays_per_sec_per_chip"),
    "spheres": (None, 1024, 16, "spheres_4bounce_mrays_per_sec_per_chip"),
    "terrain8k": (dict(kind="terrain", res=64), 512, 4,
                  "terrain8k_4bounce_mrays_per_sec_per_chip"),
    "terrain100k": (dict(kind="terrain", res=224), 512, 4,
                    "terrain100k_4bounce_mrays_per_sec_per_chip"),
    "terrain330k": (dict(kind="terrain", res=406), 512, 2,
                    "terrain330k_4bounce_mrays_per_sec_per_chip"),
    "terrain500k": (dict(kind="terrain", res=501), 512, 2,
                    "terrain500k_4bounce_mrays_per_sec_per_chip"),
    "blob82k": (dict(kind="blob", subdivisions=6), 512, 4,
                "blob82k_4bounce_mrays_per_sec_per_chip"),
}


def load_bench_scene(name):
    from pyrenderer_tpu.scene import load_tungsten

    procgen_kw, res, spp, metric = SCENES[name]
    if procgen_kw is None:
        root = os.path.dirname(os.path.abspath(__file__))
        json_name = "cornell_box.json" if name == "cornell" else f"{name}.json"
        scene, camera, _ = load_tungsten(
            os.path.join(root, "scenes", json_name)
        )
    else:
        from pyrenderer_tpu.scene.procgen import big_scene_data
        from pyrenderer_tpu.scene.tungsten import build_scene

        scene, camera, _ = build_scene(big_scene_data(**procgen_kw))
    return scene, camera, res, spp, metric


def main():
    import jax
    import jax.numpy as jnp

    from pyrenderer_tpu.utils.compile_cache import use_checkout_cache
    from pyrenderer_tpu.utils.profiling import gpu_card

    use_checkout_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; found {jax.devices()[0]}")
    print(f"card: {gpu_card()}", file=sys.stderr)

    from pyrenderer_tpu.config import RenderConfig
    from pyrenderer_tpu.core.camera import generate_rays
    from pyrenderer_tpu.core.integrator import (
        TraceTables,
        maybe_build_accel,
        trace_reference,
    )

    scene_name = os.environ.get("BENCH_SCENE", "cornell")
    estimator = os.environ.get("BENCH_ESTIMATOR", "reference")
    scene, camera, def_res, def_spp, metric = load_bench_scene(scene_name)

    res = int(os.environ.get("BENCH_RES", str(def_res)))
    spp = int(os.environ.get("BENCH_SPP", str(def_spp)))
    chunk = int(os.environ.get("BENCH_CHUNK", str(1 << 16)))
    backend = os.environ.get("BENCH_BACKEND", "auto")

    # accelerator build runs on host arrays, outside jit
    accel = maybe_build_accel(scene, backend)
    scene = jax.tree.map(jnp.asarray, scene)

    camera = camera._replace(resolution=(res, res))
    cfg = RenderConfig(max_bounces=4, spp=spp, seed=0, estimator=estimator)
    w, h = camera.resolution

    from pyrenderer_tpu.core.camera import pixel_order

    # Morton pixel order, exactly as render_image traces a real frame: each
    # 128-ray tile is then a compact screen block (coherent primaries)
    ys, xs = np.mgrid[0:h, 0:w]
    perm, _ = pixel_order(
        w, h, os.environ.get("PYRENDERER_PIXEL_ORDER", "morton"))
    xs = jnp.asarray(xs.reshape(-1)[perm], jnp.int32)
    ys = jnp.asarray(ys.reshape(-1)[perm], jnp.int32)

    n_chunks = (w * h + chunk - 1) // chunk
    # chunked pixel coords: (n_chunks, chunk) — statically indexed inside jit
    # so the whole benchmark is ONE dispatch
    pad = n_chunks * chunk - w * h
    xs_c = jnp.pad(xs, (0, pad)).reshape(n_chunks, chunk)
    ys_c = jnp.pad(ys, (0, pad)).reshape(n_chunks, chunk)

    @partial(jax.jit, static_argnames=("n_samples",))
    def bench_all(scene, xs_c, ys_c, first_sample, n_samples):
        tables = TraceTables(scene, cfg, backend, accel=accel)

        def one_sample(carry, s):
            total, rays = carry
            for c in range(n_chunks):
                px, py = xs_c[c], ys_c[c]
                pixel_id = (py * w + px).astype(jnp.uint32)
                sample = jnp.full_like(pixel_id, s)
                ro, rd = generate_rays(camera, px, py, sample, cfg.seed)
                if estimator == "reference":
                    rad, n_rays = trace_reference(
                        scene, cfg, ro, rd, pixel_id, sample, cfg.seed,
                        tables=tables, with_stats=True,
                    )
                else:
                    from pyrenderer_tpu.core.integrator_pbrt import trace_pbrt

                    rad, n_rays = trace_pbrt(
                        scene, cfg, ro, rd, pixel_id, sample, cfg.seed,
                        tables=tables, with_stats=True,
                    )
                total = total + rad.sum(axis=0)
                rays = rays + n_rays
            return (total, rays), None

        init = (jnp.zeros(3), jnp.zeros(()))
        (total, rays), _ = jax.lax.scan(
            one_sample, init,
            first_sample + jnp.arange(n_samples, dtype=jnp.uint32),
        )
        return total, rays

    tag = "" if estimator == "reference" else f",{estimator}"
    print(
        f"bench[{scene_name}{tag}]: {w}x{h}, {scene.faces.shape[0]} tris, "
        f"{spp} passes, chunk={chunk} ({n_chunks} chunks/pass), "
        f"backend={backend}, device={jax.devices()[0]}",
        file=sys.stderr,
    )

    # warmup / compile
    t0 = time.perf_counter()
    jax.block_until_ready(
        bench_all(scene, xs_c, ys_c, jnp.uint32(0), n_samples=spp))
    print(f"warmup {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    out = jax.block_until_ready(
        bench_all(scene, xs_c, ys_c, jnp.uint32(0), n_samples=spp))
    dt = time.perf_counter() - t0
    mean_rad, total_rays = np.asarray(out[0]), float(out[1])

    mrays = total_rays / dt / 1e6
    mean_val = float(mean_rad.sum()) / (w * h * spp * 3)  # noqa: already host
    print(
        f"{dt:.2f}s, {total_rays/1e6:.1f} Mrays, mean radiance {mean_val:.5f}",
        file=sys.stderr,
    )
    dev = jax.devices()[0]
    row = {
        "metric": metric
        + ("_" + estimator if estimator != "reference" else ""),
        "value": mrays,
        "unit": "Mrays/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(row))


if __name__ == "__main__":
    main()
