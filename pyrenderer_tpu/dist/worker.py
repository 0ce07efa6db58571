"""Multi-process render worker: `python -m pyrenderer_tpu.dist.worker ...`.

One OS process per GPU. Launch one per card with --coordinator
<localhost:port> --num-processes N --process-id i; each process pins
itself to card i (multihost.initialize). For CPU validation, --cpu-devices
K gives each process K virtual CPU devices; the global mesh then spans
processes over gloo (tests/test_multihost.py, perf/scaling.py
--processes N).

Each process renders the SAME SPMD program; process 0 writes the assembled
HDR image (--out) and every process prints one timing/parity JSON line to
stdout (prefixed "RESULT ") for harnesses to scrape.

Reference crosswalk: this replaces joblib process fan-out with pickled
scenes and gathered return values (reference main.py:51-55) — here the
"gather" is a device collective and the scene uploads once per process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pyrenderer_tpu.dist.worker")
    p.add_argument("scene", help="Tungsten scene JSON path")
    p.add_argument("--coordinator", default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="force CPU backend with this many virtual devices")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sp", type=int, default=1, help="spp mesh-axis size")
    p.add_argument("--reps", type=int, default=1, help="timed repetitions")
    p.add_argument("--out", default=None, help="process 0 writes HDR .npy here")
    p.add_argument("--train-steps", type=int, default=0,
                   help="also run N inverse-rendering train steps over the "
                        "global mesh (gradient allreduce crosses processes); "
                        "RESULT gains train_losses + grad stats")
    args = p.parse_args(argv)

    if args.cpu_devices:
        # must precede first backend touch: the config route for the
        # platform and XLA_FLAGS for the device count
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from pyrenderer_tpu.dist import multihost
    from pyrenderer_tpu.utils.compile_cache import use_checkout_cache

    use_checkout_cache()

    multi = multihost.initialize(
        args.coordinator, args.num_processes, args.process_id
    )
    pid = jax.process_index()

    import jax.numpy as jnp
    import numpy as np

    from pyrenderer_tpu.scene import load_tungsten

    scene, camera, cfg = load_tungsten(args.scene)
    camera = camera._replace(resolution=(args.res, args.res))
    cfg = cfg.replace(
        spp=args.spp, max_bounces=args.depth, seed=args.seed,
        estimator="reference", resolution=None,
    )
    mesh = multihost.make_host_mesh(sp=args.sp)

    img = multihost.render_image_multihost(scene, camera, cfg, mesh)  # warmup
    t0 = time.perf_counter()
    for _ in range(args.reps):
        img = multihost.render_image_multihost(scene, camera, cfg, mesh)
    dt = (time.perf_counter() - t0) / args.reps

    px, py = multihost._global_pixel_arrays(camera, mesh)
    n_rays = float(
        np.asarray(
            multihost._count_rays(
                jax.tree.map(jnp.asarray, scene), camera, cfg, mesh, px, py
            )
        )
    ) * cfg.spp

    result = {
        "process_id": pid,
        "num_processes": jax.process_count(),
        "global_devices": len(jax.devices()),
        "multi": multi,
        "time_s": dt,
        "mrays_per_s": n_rays / dt / 1e6,
        "image_mean": float(img.mean()),
    }

    if args.train_steps > 0:
        # Inverse-rendering train steps over the SAME global mesh: the
        # scene-parameter gradients all-reduce through the shard_map's
        # psum transpose, which crosses the process boundary (NCCL/gloo)
        # whenever the dp axis spans processes — the BASELINE config-5
        # path. Losses and per-family gradient statistics go into RESULT
        # so the harness can assert 2-process == 1-process
        # (tests/test_multihost.py::test_two_process_train_step).
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pyrenderer_tpu.dist.render import train_step

        jscene = jax.tree.map(jnp.asarray, scene)
        params = (jscene.vertices, jscene.albedo, jscene.emission)
        n_px = args.res * args.res
        sharding = NamedSharding(mesh, P("dp"))
        target = jax.make_array_from_callback(
            (n_px, 3), sharding, lambda idx: np.zeros((n_px, 3), np.float32)[idx]
        )
        lr = jnp.float32(1e-3)
        losses = []
        for _ in range(args.train_steps):
            loss, params = train_step(
                params, jscene, camera, cfg, mesh, target, px, py, lr
            )
            losses.append(float(loss))

        # true gradients at the final params (recovering them from the f32
        # SGD delta would truncate small-grad/large-value families like
        # emission to zero). Global (dp-sharded) arrays are passed as jit
        # ARGUMENTS, and all statistics reduce to replicated scalars
        # inside the jit — fetching a scalar is process-local everywhere.
        from pyrenderer_tpu.dist.render import render_field_sharded

        @jax.jit
        def _grad_stats(ps, target, px, py):
            def _loss(ps):
                s = jscene._replace(vertices=ps[0], albedo=ps[1],
                                    emission=ps[2])
                img = render_field_sharded(s, camera, cfg, mesh, px, py)
                return jnp.mean((img - target) ** 2)

            grads = jax.grad(_loss)(ps)
            return (
                tuple(jnp.abs(g).mean() for g in grads),
                tuple(jnp.abs(p).mean() for p in ps),
            )

        gstats, pstats = _grad_stats(params, target, px, py)
        result["train_losses"] = losses
        result["grad_mean_abs"] = [float(g) for g in gstats]
        result["param_mean_abs"] = [float(p) for p in pstats]

    if pid == 0 and args.out:
        np.save(args.out, img)
    print("RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
