"""Inverse rendering end-to-end: recover a wall albedo from a target image.

The differentiable render is the one capability the reference (a forward
path tracer, no autodiff anywhere) cannot express at all — this example is
the north-star demo (SURVEY §7): render a target with the true scene, start
from a perturbed albedo, and descend on pixel L2 straight THROUGH the
path tracer (dist/render.py train_step: render -> loss -> grads, with the
scene-parameter gradient all-reduced over the device mesh by the psum
transpose).

Run (any backend):
    python examples/invrender.py [--res 64] [--spp 4] [--steps 80]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--res", type=int, default=48)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--lr", type=float, default=30.0, help="albedo learning rate")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax

    from pyrenderer_tpu.utils.compile_cache import use_checkout_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    use_checkout_cache()

    import jax.numpy as jnp
    import numpy as np

    from pyrenderer_tpu.config import RenderConfig
    from pyrenderer_tpu.dist.render import (
        make_mesh,
        pixel_grid,
        render_field_sharded,
        train_step,
    )
    from pyrenderer_tpu.scene import load_tungsten

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    scene, camera, _ = load_tungsten(os.path.join(root, "scenes", "cornell_box.json"))
    scene = jax.tree.map(jnp.asarray, scene)
    camera = camera._replace(resolution=(args.res, args.res))
    cfg = RenderConfig(max_bounces=3, spp=args.spp, seed=0, estimator="reference")
    mesh = make_mesh(1)
    px, py = pixel_grid(camera)

    target = render_field_sharded(scene, camera, cfg, mesh, px, py)

    # perturb the left wall's albedo (material 0 in the cornell scene is
    # found by color — the reddest one)
    alb = np.asarray(scene.albedo)
    wall = int(np.argmax(alb[:, 0] - alb[:, 1]))
    true_albedo = alb[wall].copy()
    alb_init = alb.copy()
    alb_init[wall] = [0.5, 0.5, 0.5]
    params = (scene.vertices, jnp.asarray(alb_init), scene.emission)

    print(f"optimizing albedo of material {wall} (true {true_albedo.round(3)})")
    loss0 = None
    for step in range(args.steps):
        loss, params = train_step(
            params, scene, camera, cfg, mesh, target, px, py,
            (0.0, args.lr, 0.0),  # albedo-only recovery
        )
        loss = float(loss)
        if loss0 is None:
            loss0 = loss
        if step % 10 == 0 or step == args.steps - 1:
            cur = np.asarray(params[1])[wall]
            print(f"step {step:3d}  loss {loss:.3e}  albedo {cur.round(3)}")

    final = np.asarray(params[1])[wall]
    err = float(np.abs(final - true_albedo).max())
    print(f"done: loss {loss0:.3e} -> {loss:.3e} ({loss0 / max(loss, 1e-30):.1f}x), "
          f"albedo max err {err:.4f}")
    return 0 if loss < loss0 / 10 else 1


if __name__ == "__main__":
    sys.exit(main())
