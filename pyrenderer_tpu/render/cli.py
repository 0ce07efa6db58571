"""CLI: `python -m pyrenderer_tpu.render.cli scene.json [flags]`.

The reference's CLI was `main.py`'s argparse (reference main.py:109-119,
including its `type=bool` bug where `-d False` is truthy — not reproduced)
plus hardcoded constants in main_taichi.py. Here every integrator/renderer
knob from the scene JSON is honored and overridable.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pyrenderer_tpu",
        description="differentiable Monte-Carlo path tracer (JAX)",
    )
    p.add_argument(
        "scene",
        help="Tungsten scene JSON; the literal 'analytic' for the "
        "self-contained analytic-primitive scene (reference taichi_ref.py);"
        " or the literal 'tonemap' to run the offline tonemapper over a "
        "saved HDR (.exr/.npy) — the role of the reference's tone_map.py",
    )
    p.add_argument("--input", help="tonemap mode: HDR input (.exr or .npy)")
    p.add_argument("--spp", type=int, help="samples per pixel (scene default)")
    p.add_argument("--spp-step", type=int, help="samples per progressive pass")
    p.add_argument("--depth", type=int, help="max bounces (scene default)")
    p.add_argument("--res", type=int, nargs=2, metavar=("W", "H"), help="override resolution")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--estimator", choices=["reference", "pbrt"], default="pbrt",
        help="radiance estimator (default: physically based)",
    )
    p.add_argument(
        "--tonemap", choices=["sqrt", "reinhard", "filmic", "none"],
        help="LDR operator",
    )
    p.add_argument("--out", help="output PNG path (scene default)")
    p.add_argument("--hdr-out", help="output EXR/NPY path")
    p.add_argument(
        "--backend",
        choices=["auto", "pallas", "matmul", "brute", "bvh", "watertight"],
        default="auto",
        help="intersection backend (auto selects by platform and triangle count)",
    )
    p.add_argument(
        "--chunk", type=int, default=1 << 16,
        help="rays per dispatch chunk (default 2^16 = a 256x256 Morton "
        "screen block)",
    )
    p.add_argument(
        "--preview-interval", type=int,
        help="dump a tonemapped preview PNG every N passes (reference dumped "
        "out.png every 100 — main_taichi.py:119-125)",
    )
    p.add_argument("--preview-file", help="preview PNG path (default preview.png)")
    p.add_argument("--checkpoint", help="checkpoint .npz path (enables save)")
    p.add_argument("--checkpoint-interval", type=int, help="passes between checkpoints")
    p.add_argument("--resume", action="store_true", help="resume from --checkpoint")
    p.add_argument(
        "--resilient", type=int, nargs="?", const=3, default=0,
        metavar="RETRIES",
        help="retry failed passes (failure detection + elastic recovery; "
        "default 3 retries when given without a value)",
    )
    p.add_argument(
        "--live", type=int, nargs="?", const=1, default=0, metavar="PASSES",
        help="redraw the accumulating render in the terminal every N "
        "passes (ANSI half-blocks — the headless equivalent of the "
        "reference's progressive GUI window)",
    )
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    p.add_argument("--quiet", action="store_true")
    p.add_argument(
        "--debug-paths", metavar="OUT.html",
        help="instead of rendering, trace a coarse pixel grid recording "
        "every bounce and write a self-contained interactive HTML viewer "
        "(scene wireframe + ray/shadow polylines) — the reference's "
        "`main.py -d` open3d mode, headless (debug/logger.py; also "
        "writes OUT.ply next to it)",
    )
    p.add_argument(
        "--debug-rays", type=int, default=49,
        help="ray count for --debug-paths (a sqrt-grid of pixels)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from pyrenderer_tpu.utils.compile_cache import use_checkout_cache

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    use_checkout_cache()

    if args.scene == "analytic":
        return _main_analytic(args)
    if args.scene == "tonemap":
        return _main_tonemap(args)

    from pyrenderer_tpu.core.film import Film
    from pyrenderer_tpu.render.driver import ProgressiveRenderer
    from pyrenderer_tpu.scene import load_tungsten

    scene, camera, cfg = load_tungsten(args.scene)
    overrides = {"seed": args.seed, "estimator": args.estimator}
    if args.spp is not None:
        overrides["spp"] = args.spp
    if args.spp_step is not None:
        overrides["spp_step"] = args.spp_step
    if args.depth is not None:
        overrides["max_bounces"] = args.depth
    if args.res is not None:
        overrides["resolution"] = tuple(args.res)
    if args.tonemap is not None:
        overrides["tonemap"] = args.tonemap
    if args.out is not None:
        overrides["output_file"] = args.out
    if args.hdr_out is not None:
        overrides["hdr_output_file"] = args.hdr_out
    if args.checkpoint_interval is not None:
        overrides["checkpoint_interval"] = args.checkpoint_interval
    if args.preview_interval is not None:
        overrides["preview_interval"] = args.preview_interval
    if args.preview_file is not None:
        overrides["preview_file"] = args.preview_file
    cfg = cfg.replace(**overrides)

    if args.debug_paths:
        import numpy as np

        from pyrenderer_tpu.debug.logger import log_paths

        w, h = cfg.resolution or camera.resolution
        camera = camera._replace(resolution=(w, h))
        side = max(1, int(args.debug_rays ** 0.5))
        xs = (np.arange(side) + 0.5) * (w / side)
        ys = (np.arange(side) + 0.5) * (h / side)
        px, py = np.meshgrid(xs.astype(np.int32), ys.astype(np.int32))
        log = log_paths(scene, camera, cfg, px.reshape(-1), py.reshape(-1),
                        backend=args.backend)
        log.write_html(args.debug_paths, scene=scene)
        ply = args.debug_paths.rsplit(".", 1)[0] + ".ply"
        log.write_ply(ply)
        print(f"wrote {args.debug_paths} and {ply} "
              f"({side * side} paths)", file=sys.stderr)
        return 0

    film = None
    if args.resume:
        if not args.checkpoint:
            print("--resume requires --checkpoint", file=sys.stderr)
            return 2
        film = Film.load(args.checkpoint)
        print(f"resuming from {args.checkpoint} at {film.spp} spp", file=sys.stderr)

    on_pass = None
    if args.live:
        from pyrenderer_tpu.core.tonemap import tonemap as _tonemap
        from pyrenderer_tpu.utils.termview import LiveView

        view = LiveView()
        every = args.live
        tick = {"n": 0}

        def on_pass(r):
            # count PASSES (uniform and adaptive alike), not spp — spp
            # advances by spp_step per pass and stalls during refinement
            tick["n"] += 1
            if tick["n"] % every == 0:
                import jax.numpy as _jnp
                import numpy as _np

                ldr = _np.asarray(_tonemap(_jnp.asarray(r.film.hdr), r.cfg.tonemap))
                view.update(ldr, f"{r.film.spp}/{r.cfg.spp} spp")

    renderer = ProgressiveRenderer(scene, camera, cfg, backend=args.backend,
                                   film=film, chunk=args.chunk,
                                   on_pass=on_pass)
    # --live owns the terminal: the view's in-place redraw rewinds exactly
    # its own lines, so interleaved progress prints (samples/s, adaptive
    # reports) would corrupt it — silence them and let the status line
    # carry the spp progress instead
    quiet = args.quiet or bool(args.live)
    if args.resilient:
        renderer.run_resilient(
            checkpoint_path=args.checkpoint, max_retries=args.resilient,
            quiet=quiet,
        )
    else:
        renderer.run(checkpoint_path=args.checkpoint, quiet=quiet)
    written = renderer.write_outputs()
    for path in written:
        print(f"wrote {path}", file=sys.stderr)
    return 0


def _main_tonemap(args) -> int:
    """Offline tonemapper: saved HDR (.exr/.npy) -> LDR PNG.

    The reference's tone_map.py loads dumped hdr.npy/spp.npy and shows
    sqrt and Reinhard LDRs in cv2 windows (SURVEY §2.26); here any saved
    HDR (including our own EXR output) maps through any of the supported
    operators to a PNG: `pyrenderer_tpu tonemap --input out.exr
    --tonemap filmic --out out.png`."""
    import numpy as np

    import jax.numpy as jnp

    from pyrenderer_tpu.core.tonemap import tonemap as apply_tonemap
    from pyrenderer_tpu.utils.image_io import write_png

    if not args.input:
        print("tonemap mode requires --input (.exr or .npy)", file=sys.stderr)
        return 2
    if args.input.endswith(".exr"):
        from pyrenderer_tpu.utils.exr import read_exr

        hdr = read_exr(args.input)[:, :, :3]
    else:
        hdr = np.load(args.input)
    op = args.tonemap or "sqrt"
    ldr = np.asarray(apply_tonemap(jnp.asarray(hdr, jnp.float32), op))
    out = args.out or "tonemapped.png"
    write_png(out, ldr)
    print(f"wrote {out} ({op}, {hdr.shape[1]}x{hdr.shape[0]})", file=sys.stderr)
    return 0


def _main_analytic(args) -> int:
    """Render the hardcoded analytic-primitive scene (`scene == "analytic"`).

    The reference counterpart is `python taichi_ref.py` — a standalone
    renderer outside the Tungsten pipeline (taichi_ref.py:441-511); flags
    that only make sense for scene-driven renders are ignored.
    """
    import numpy as np

    from pyrenderer_tpu import analytic
    from pyrenderer_tpu.utils.image_io import write_png

    res = tuple(args.res) if args.res is not None else (400, 400)
    spp = args.spp if args.spp is not None else 25
    depth = args.depth if args.depth is not None else analytic.MAX_DEPTH
    hdr = analytic.render(res=res, spp=spp, seed=args.seed, max_depth=depth)
    ldr = np.clip(np.asarray(analytic.tonemap(hdr)), 0.0, 1.0)
    out = args.out or "analytic.png"
    write_png(out, ldr)
    if args.hdr_out:
        np.save(args.hdr_out, np.asarray(hdr))
        print(f"wrote {args.hdr_out}", file=sys.stderr)
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
