"""Multi-host execution: jax.distributed + host-aware global meshes.

The reference's only cross-process machinery is joblib fan-out with pickled
scenes (reference main.py:51-53) — results are gathered through function
return values, one host only. The multi-process model here instead runs ONE
SPMD program over all processes, one process per GPU: every process
executes the same jitted shard_map over a GLOBAL mesh, and XLA hands the
collectives to NCCL — over NVLink between the cards of one host, over the
network between hosts (SURVEY §5.8).

Pieces:
  initialize(...)        — jax.distributed bring-up from args or env
                           (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID;
                           no-op for single-process runs).
  make_host_mesh(...)    — (dp, sp) mesh over the GLOBAL device list, dp
                           outermost so pixel tiles shard across processes
                           (one all-gather of tiles per frame, while the spp
                           psum stays inside a process when it can).
  render_image_multihost — full-frame render: every process computes its
                           addressable pixel shards, process 0 (or all, via
                           allgather) assembles the image.

Functional validation runs as N CPU processes on one machine —
tests/test_multihost.py spawns 2 processes x 4 virtual devices and checks
the assembled image against a single-process render; perf/scaling.py
--processes N does the same for the efficiency table.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import multihost_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyrenderer_tpu.config import RenderConfig
from pyrenderer_tpu.dist.render import render_field_sharded
from pyrenderer_tpu.scene.types import Camera, Scene


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Bring up jax.distributed from args or environment. Returns True if a
    multi-process runtime was initialized.

    Env fallbacks: PYRT_COORDINATOR (host:port), PYRT_NUM_PROCESSES,
    PYRT_PROCESS_ID. Nothing discovers a cluster on its own, so a
    multi-process run passes all three. On the GPU each process is pinned
    to one card, `local_device_ids=[process_id % cards on this host]`, so
    processes never share a card (each JAX process reserves most of the
    card's memory when it starts).
    """
    coordinator = coordinator or os.environ.get("PYRT_COORDINATOR")
    if num_processes is None and "PYRT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["PYRT_NUM_PROCESSES"])
    if process_id is None and "PYRT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["PYRT_PROCESS_ID"])
    if num_processes is None or num_processes <= 1:
        return False
    kwargs = {}
    ids = card_ids(process_id, _gpu_count(),
                   on_cpu=jax.config.jax_platforms == "cpu")
    if ids is not None:
        kwargs["local_device_ids"] = ids
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    return True


def card_ids(process_id: int, n_cards: int, on_cpu: bool):
    """The card a GPU process owns, [process_id % n_cards]; None for CPU
    processes or on a host without cards (nothing to pin)."""
    if on_cpu or n_cards == 0:
        return None
    return [process_id % n_cards]


def _gpu_count() -> int:
    """Number of NVIDIA cards on this host, from the driver's device nodes
    (no JAX backend is touched, so it is safe before initialize())."""
    import glob

    return len(glob.glob("/dev/nvidia[0-9]*"))


def make_host_mesh(dp: int | None = None, sp: int | None = None) -> Mesh:
    """(dp, sp) mesh over ALL processes' devices, dp-major in process order.

    Process-contiguous dp: each process owns a contiguous band of pixel
    tiles, so the per-frame tile gather is one transfer per process pair,
    and the spp psum (when sp > 1 within a process) stays on that
    process's cards.
    """
    devices = np.asarray(jax.devices())  # global, process-major order
    n = devices.size
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp must equal global device count ({dp}*{sp} != {n})")
    return Mesh(devices.reshape(dp, sp), ("dp", "sp"))


def _global_pixel_arrays(camera: Camera, mesh: Mesh):
    """Row-major pixel coords as GLOBAL dp-sharded arrays.

    Every process computes the same full coordinate list and wraps its
    addressable shards — no data moves.
    """
    w, h = camera.resolution
    ys, xs = np.mgrid[0:h, 0:w]
    xs = xs.reshape(-1).astype(np.int32)
    ys = ys.reshape(-1).astype(np.int32)
    sharding = NamedSharding(mesh, P("dp"))
    px = jax.make_array_from_callback(xs.shape, sharding, lambda idx: xs[idx])
    py = jax.make_array_from_callback(ys.shape, sharding, lambda idx: ys[idx])
    return px, py


def render_image_multihost(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh | None = None,
):
    """Full-frame HDR render over a (possibly multi-host) global mesh.

    Returns the assembled (H, W, 3) image as a NumPy array ON EVERY process
    (an all-gather of the dp shards — multi-host "result collection" is a
    collective, not a pickle like the reference's joblib gather).
    """
    if mesh is None:
        mesh = make_host_mesh()
    w, h = camera.resolution
    if (w * h) % mesh.shape["dp"] != 0:
        raise ValueError("pixel count must divide over the dp axis")
    scene = jax.tree.map(jnp.asarray, scene)
    px, py = _global_pixel_arrays(camera, mesh)

    render = jax.jit(
        render_field_sharded,
        static_argnames=("cfg", "mesh"),
        out_shardings=NamedSharding(mesh, P("dp")),
    )
    out = render(scene, camera, cfg, mesh, px, py)
    # one collective gather of the pixel bands; every process gets the frame
    gathered = multihost_utils.process_allgather(out, tiled=True)
    img = np.asarray(gathered).reshape(h, w, 3)
    return img[::-1]  # y-up pixel convention -> row 0 at top


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _count_rays(scene, camera, cfg, mesh, px, py):
    """Mrays/s numerator on the sharded path: live closest + NEE shadow rays,
    psum'd over the mesh (matches the single-chip bench convention)."""
    from pyrenderer_tpu.core.integrator import TraceTables, trace_reference
    from pyrenderer_tpu.core.camera import generate_rays

    @partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P("dp"), P("dp")), out_specs=P(),
    )
    def count(scene, camera, px, py):
        wdt, _ = camera.resolution
        pid = (py * wdt + px).astype(jnp.uint32)
        sid = jnp.zeros_like(pid)
        ro, rd = generate_rays(camera, px, py, sid, cfg.seed)
        tables = TraceTables(scene, cfg, "auto")
        _, n_rays = trace_reference(
            scene, cfg, ro, rd, pid, sid, cfg.seed, tables=tables,
            with_stats=True,
        )
        # psum over dp only: the count is invarying over sp (every sp rank
        # traces the same sample here), and the typed-axes checker rejects
        # reducing an axis the value does not vary over
        return jax.lax.psum(n_rays, "dp")

    return count(scene, camera, px, py)
