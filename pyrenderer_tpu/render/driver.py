"""Progressive render driver: the wavefront form of the main_taichi.py loop.

Reference behavior reproduced (main_taichi.py:102-127): one-sample passes
accumulated into the film, samples/s printed every `report_interval`
passes, periodic PNG dumps, a pass cap — plus what the reference lacked:
real checkpoint/resume (Film.save/load), variance-guided ADAPTIVE sampling
(Tungsten's adaptive_sampling flag, parsed-but-ignored by the reference —
scene.json:278), rays/s accounting, and a multi-device path through
dist/render.py.
"""

from __future__ import annotations

import os
import sys
import time
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.core.film import Film
from pyrenderer_tpu.core.camera import morton_pixel_order
from pyrenderer_tpu.core.integrator import (
    TraceTables,
    maybe_build_accel,
    render_sample,
    resolve_backend,
)
from pyrenderer_tpu.core.tonemap import tonemap
from pyrenderer_tpu.scene.types import Camera, Scene
from pyrenderer_tpu.utils.image_io import write_hdr, write_png


@partial(jax.jit, static_argnames=("cfg", "backend", "n_samples"))
def _render_pass(scene, camera, cfg: RenderConfig, first_sample, n_samples: int,
                 pixel_x, pixel_y, backend: str = "auto", accel=None):
    """(sum, sum-of-squares) of `n_samples` sample radiances per pixel."""
    tables = TraceTables(scene, cfg, backend, accel=accel)

    def one(carry, s):
        total, sq = carry
        r = render_sample(
            scene, camera, cfg, cfg.seed, first_sample + s, pixel_x, pixel_y,
            tables=tables,
        )
        return (total + r, sq + r * r), None

    zeros = jnp.zeros((pixel_x.shape[0], 3), scene.vertices.dtype)
    (total, sq), _ = jax.lax.scan(
        one, (zeros, zeros), jnp.arange(n_samples, dtype=jnp.uint32)
    )
    return total, sq


@partial(jax.jit, static_argnames=("cfg", "backend"))
def _render_pass_ids(scene, camera, cfg: RenderConfig, sample_ids,
                     pixel_x, pixel_y, backend: str = "auto", accel=None):
    """One sample per pixel with PER-PIXEL sample ids (adaptive passes)."""
    tables = TraceTables(scene, cfg, backend, accel=accel)
    r = render_sample(
        scene, camera, cfg, cfg.seed, sample_ids, pixel_x, pixel_y, tables=tables
    )
    return r, r * r


class ProgressiveRenderer:
    """Accumulates spp_step-sample passes into a Film until cfg.spp; with
    cfg.adaptive, refines only unconverged pixels past adaptive_min_spp."""

    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        cfg: RenderConfig,
        backend: str = "auto",
        film: Optional[Film] = None,
        accel=None,
        # 2^16 rays/dispatch = a 256x256 Morton screen block (not yet
        # swept on the GPU)
        chunk: int = 1 << 16,
        report_interval: int = 10,
        on_pass: Optional[Callable[["ProgressiveRenderer"], None]] = None,
    ):
        if cfg.resolution is not None:
            camera = camera._replace(resolution=tuple(cfg.resolution))
        self.scene = jax.tree.map(jnp.asarray, scene)
        self.camera = camera
        self.cfg = cfg
        # auto-build the accelerator for large scenes / an explicit bvh
        # backend (host-side; scene arrays are concrete here), then resolve
        # the backend OUTSIDE jit so the concrete choice is part of the
        # jitted passes' static cache key
        self.accel = maybe_build_accel(scene, backend, accel)
        self.backend = resolve_backend(
            backend, scene.faces.shape[0], self.accel
        )
        self.chunk = chunk
        self.report_interval = report_interval
        self.on_pass = on_pass
        w, h = camera.resolution
        self.film = film if film is not None else Film.blank(w, h, cfg.seed)
        if film is not None and film.seed != cfg.seed:
            raise ValueError(
                f"resume film was rendered with seed {film.seed}, config has {cfg.seed}"
            )
        self._validate = False
        ys, xs = np.mgrid[0:h, 0:w]
        self._px_np = xs.reshape(-1).astype(np.int32)
        self._py_np = ys.reshape(-1).astype(np.int32)
        # trace in Morton order so wavefront tiles are compact screen
        # blocks (core/camera.py morton_pixel_order); results unpermuted in
        # render_one_pass before landing on the film
        self._perm, self._inv_perm = morton_pixel_order(w, h)
        self._px = jnp.asarray(self._px_np[self._perm])
        self._py = jnp.asarray(self._py_np[self._perm])

    def render_one_pass(self) -> None:
        """One uniform spp_step pass over all pixels."""
        w, h = self.camera.resolution
        step = self.cfg.spp_step
        sums, sqs = [], []
        for start in range(0, w * h, self.chunk):
            sl = slice(start, start + self.chunk)
            s, q = _render_pass(
                self.scene, self.camera, self.cfg,
                jnp.uint32(self.film.next_sample), step,
                self._px[sl], self._py[sl], self.backend, self.accel,
            )
            sums.append(s)
            sqs.append(q)
        img = np.asarray(jnp.concatenate(sums))[self._inv_perm].reshape(h, w, 3)[::-1]
        sq = np.asarray(jnp.concatenate(sqs))[self._inv_perm].reshape(h, w, 3)[::-1]
        if self._validate and not (np.isfinite(img).all() and np.isfinite(sq).all()):
            # detected BEFORE the film absorbs it: the accumulation state
            # stays clean and the pass can be retried with the same RNG
            # counters (run_resilient's failure-detection hook)
            raise RuntimeError(
                f"non-finite radiance in pass at spp {self.film.spp} "
                f"({int((~np.isfinite(img)).sum())} bad values)"
            )
        self.film.add_pass(img, sq, step)

    def refine_adaptive(self, quiet: bool = False) -> int:
        """One adaptive sweep: render one extra sample for every pixel whose
        relative error exceeds cfg.adaptive_tolerance, up to cfg.spp.
        Returns the number of refined pixels."""
        w, h = self.camera.resolution
        err = self.film.relative_error()
        spp_ok = self.film.spp_map >= self.cfg.spp
        active = (err > self.cfg.adaptive_tolerance) & (~spp_ok)
        idx = np.nonzero(active[::-1].reshape(-1))[0]  # flip back to y-up order
        if idx.size == 0:
            return 0
        for start in range(0, idx.size, self.chunk):
            part = idx[start : start + self.chunk]
            k = part.size
            # pad to a power of two (min 4096) — bounds the number of
            # distinct compiled shapes (each compile costs seconds)
            padded = max(4096, 1 << (k - 1).bit_length())
            pad = padded - k
            part_p = np.pad(part, (0, pad), mode="edge")
            px = jnp.asarray(self._px_np[part_p])
            py = jnp.asarray(self._py_np[part_p])
            rows = h - 1 - self._py_np[part]
            cols = self._px_np[part]
            sample_ids = jnp.asarray(
                self.film.spp_map[rows, cols].astype(np.uint32)
            )
            sample_ids = jnp.pad(sample_ids, (0, pad), mode="edge")
            r, q = _render_pass_ids(
                self.scene, self.camera, self.cfg, sample_ids, px, py,
                self.backend, self.accel,
            )
            r = np.asarray(r)[:k]
            q = np.asarray(q)[:k]
            if self._validate and not (np.isfinite(r).all() and np.isfinite(q).all()):
                # same pre-absorption guard as render_one_pass: adaptive
                # chunks must not poison the film either
                raise RuntimeError(
                    f"non-finite radiance in adaptive chunk "
                    f"({int((~np.isfinite(r)).sum())} bad values)"
                )
            self.film.add_pixels(rows, cols, r, q)
        if not quiet:
            print(f"adaptive: refined {idx.size} pixels", file=sys.stderr)
        return int(idx.size)

    def write_preview(self, path: Optional[str] = None) -> str:
        """Dump the current tonemapped accumulation (the reference dumped
        out.png every 100 passes — main_taichi.py:119-125)."""
        path = path or self.cfg.preview_file
        ldr = np.asarray(tonemap(jnp.asarray(self.film.hdr), self.cfg.tonemap))
        write_png(path, ldr)
        return path

    def run(self, checkpoint_path: Optional[str] = None, quiet: bool = False):
        cfg = self.cfg
        last_t = time.time()
        passes = 0
        uniform_target = (
            min(cfg.adaptive_min_spp, cfg.spp) if cfg.adaptive else cfg.spp
        )
        while self.film.spp < uniform_target:
            self.render_one_pass()
            passes += 1
            if not quiet and passes % self.report_interval == 0:
                dt = time.time() - last_t
                sps = self.report_interval * cfg.spp_step / dt
                print(
                    f"{sps:.2f} samples/s ({self.film.spp}/{cfg.spp} spp)",
                    file=sys.stderr,
                )
                last_t = time.time()
            if self.on_pass:
                self.on_pass(self)
            if cfg.preview_interval and passes % cfg.preview_interval == 0:
                self.write_preview()
            if (
                checkpoint_path
                and cfg.checkpoint_interval
                and passes % cfg.checkpoint_interval == 0
            ):
                self.film.save(checkpoint_path)
        if cfg.adaptive:
            while self.refine_adaptive(quiet=quiet):
                passes += 1
                if self.on_pass:
                    self.on_pass(self)
                if (
                    checkpoint_path
                    and cfg.checkpoint_interval
                    and passes % cfg.checkpoint_interval == 0
                ):
                    self.film.save(checkpoint_path)
        if checkpoint_path and cfg.checkpoint_interval:
            self.film.save(checkpoint_path)
        return self.film

    def run_resilient(
        self,
        checkpoint_path: Optional[str] = None,
        max_retries: int = 3,
        backoff: float = 2.0,
        quiet: bool = False,
    ):
        """Failure detection + elastic recovery around run() (SURVEY §5.3 —
        a subsystem neither the reference nor rounds 1-3 had).

        Two failure classes are handled:
        - transient runtime/device errors (preemption, a failed dispatch): the accumulation state lives HOST-side and is
          only advanced after a pass completes, so a retry resumes at the
          exact pass that failed with the same RNG counters — the final
          image is bit-identical to an uninterrupted render
          (tests/test_render.py::test_run_resilient_*). Retries back off
          exponentially; a checkpoint_path additionally makes the film
          recoverable by a FRESH process (Film.load + the resume path)
          if this one dies outright.
        - non-finite contamination: every pass is validated before the
          film absorbs it; a NaN/inf pass raises, is retried, and —
          because the RNG is counter-based — a DETERMINISTIC NaN source
          fails loudly after max_retries instead of silently poisoning
          the accumulation.
        """
        attempts = 0
        cur_backoff = backoff
        last_progress = -1
        self._validate = True
        try:
            while True:
                try:
                    return self.run(checkpoint_path=checkpoint_path, quiet=quiet)
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001 — elastic by design
                    # progress = total samples absorbed; spp_map.sum()
                    # advances during ADAPTIVE refinement too, where
                    # film.spp (the min) stays flat
                    progress = int(self.film.spp_map.sum())
                    if progress > last_progress:
                        # progress since the last failure: this is a NEW
                        # incident, not the same one persisting — reset
                        # the retry budget and backoff (max_retries bounds
                        # CONSECUTIVE failures, not lifetime hiccups of a
                        # multi-hour render)
                        attempts = 0
                        cur_backoff = backoff
                        last_progress = progress
                    attempts += 1
                    if attempts > max_retries:
                        raise
                    if not quiet:
                        print(
                            f"pass failed ({e!r}); retry {attempts}/"
                            f"{max_retries} in {cur_backoff:.0f}s from spp "
                            f"{self.film.spp}",
                            file=sys.stderr,
                        )
                    time.sleep(cur_backoff)
                    cur_backoff *= 2.0
        finally:
            self._validate = False

    def write_outputs(self, out_dir: str = ".") -> list:
        written = []
        ldr = np.asarray(tonemap(jnp.asarray(self.film.hdr), self.cfg.tonemap))
        png = os.path.join(out_dir, self.cfg.output_file)
        write_png(png, ldr)
        written.append(png)
        if self.cfg.hdr_output_file:
            written.append(
                write_hdr(os.path.join(out_dir, self.cfg.hdr_output_file), self.film.hdr)
            )
        return written
