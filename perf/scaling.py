"""Multi-device / multi-process scaling-efficiency harness (BASELINE north
star: >=85% rays/s efficiency from 1 to N hosts).

Two modes:

  single-process (default): shard over 1..N local devices with a (dp, sp)
  mesh. On a multi-GPU host run as-is; on a CPU host set
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
  to validate the sharded path functionally.

  multi-process (--processes N): spawns N OS processes joined by
  jax.distributed over localhost (pyrenderer_tpu/dist/worker.py). With
  --cpu-devices 0 each process pins itself to its own GPU (one process per
  card); with --cpu-devices K > 0 each gets K virtual CPU devices instead,
  the functional stand-in. Reports Mrays/s at 1 process and N processes
  and the derived scaling efficiency. CPU numbers say nothing about GPU
  performance; there the harness (and the collective path it exercises)
  is the deliverable.

Prints a table of configuration vs Mrays/s and parallel efficiency.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SCENE = os.path.join(ROOT, "scenes", "cornell_box.json")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_processes(n_proc: int, cpu_devices: int, res: int, spp: int,
                  depth: int, reps: int, pin_cpus: bool = False):
    """Spawn n_proc workers; return the merged RESULT dict of process 0.

    pin_cpus: give each worker its own core via taskset (worker pid p ->
    logical core p % os.cpu_count()). Without pinning, every "host"
    contends for the same cores and the efficiency number measures CPU
    oversubscription, not the scaling path (the round-4 45% figure). With
    pinning the baseline runs on 1 core and N processes on N cores —
    honest weak scaling within what one box can express. Caveats: when
    n_proc exceeds the core count, workers wrap onto shared cores and
    the contention artifact returns (warned below); os.cpu_count() counts
    LOGICAL cores, so on SMT machines two "disjoint" workers may still be
    hyperthread siblings."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    n_cores = os.cpu_count() or 1
    if pin_cpus and n_proc > n_cores:
        print(f"WARNING: --pin-cpus with {n_proc} processes > {n_cores} "
              "cores: workers will share cores and the efficiency number "
              "will again measure contention, not the scaling path.",
              file=sys.stderr)
    # worker stdout/stderr go to temp FILES, not pipes: a later worker
    # filling its ~64 KB pipe buffer while process 0 blocks in a collective
    # would deadlock a sequential communicate() drain
    procs = []
    logs = []
    try:
        for pid in range(n_proc):
            cmd = (
                ["taskset", "-c", str(pid % n_cores)] if pin_cpus else []
            ) + [
                sys.executable, "-m", "pyrenderer_tpu.dist.worker", SCENE,
                "--coordinator", f"localhost:{port}",
                "--num-processes", str(n_proc), "--process-id", str(pid),
                "--cpu-devices", str(cpu_devices),  # 0: one GPU per process
                "--res", str(res), "--spp", str(spp), "--depth", str(depth),
                "--reps", str(reps),
            ]
            fo = tempfile.TemporaryFile(mode="w+")
            fe = tempfile.TemporaryFile(mode="w+")
            logs.append((fo, fe))
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                          stdout=fo, stderr=fe))
        result = None
        for p, (fo, fe) in zip(procs, logs):
            p.wait(timeout=1200)
            fo.seek(0)
            fe.seek(0)
            out, err = fo.read(), fe.read()
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{out}\n{err[-3000:]}")
            for line in out.splitlines():
                if line.startswith("RESULT "):
                    r = json.loads(line[len("RESULT "):])
                    if r["process_id"] == 0:
                        result = r
        return result
    finally:
        for p in procs:          # kill survivors on timeout/failure
            if p.poll() is None:
                p.kill()
        for fo, fe in logs:
            fo.close()
            fe.close()


def multi_process_table(args):
    rows = []
    for n in [1, args.processes]:
        r = run_processes(n, args.cpu_devices, args.res, args.spp,
                          args.depth, args.reps, pin_cpus=args.pin_cpus)
        rows.append((n, r["global_devices"], r["mrays_per_s"], r["time_s"]))
    base = rows[0][2]
    print(f"{'procs':>6s} {'devices':>8s} {'Mrays/s':>10s} {'time(s)':>8s} {'efficiency':>10s}")
    for n, dev, mrays, dt in rows:
        eff = mrays / (base * n)
        print(f"{n:6d} {dev:8d} {mrays:10.2f} {dt:8.3f} {eff:9.1%}")
    return rows


def single_process_table(args):
    import jax
    import jax.numpy as jnp

    from pyrenderer_tpu.config import RenderConfig
    from pyrenderer_tpu.dist.render import make_mesh, render_field_sharded
    from pyrenderer_tpu.scene import load_tungsten

    scene, camera, _ = load_tungsten(SCENE)
    scene = jax.tree.map(jnp.asarray, scene)
    camera = camera._replace(resolution=(args.res, args.res))
    cfg = RenderConfig(max_bounces=args.depth, spp=args.spp, seed=0)

    w, h = camera.resolution
    ys, xs = np.mgrid[0:h, 0:w]
    px = jnp.asarray(xs.reshape(-1), jnp.int32)
    py = jnp.asarray(ys.reshape(-1), jnp.int32)

    n_devices = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_devices]
    # rays estimate: reuse the single-device integrator count convention
    # (closest+shadow, live lanes); for the table relative numbers matter.
    approx_rays = w * h * cfg.spp * (2 * cfg.max_bounces) * 0.8

    rows = []
    for n in counts:
        mesh = make_mesh(n, dp=n, sp=1)
        f = jax.jit(render_field_sharded, static_argnames=("cfg", "mesh"))
        jax.block_until_ready(f(scene, camera, cfg, mesh, px, py))  # compile
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = f(scene, camera, cfg, mesh, px, py)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.reps
        rows.append((n, approx_rays / dt / 1e6, dt))

    base = rows[0][1]
    print(f"{'devices':>8s} {'Mrays/s':>10s} {'time(s)':>8s} {'efficiency':>10s}")
    for n, mrays, dt in rows:
        eff = mrays / (base * n)
        print(f"{n:8d} {mrays:10.1f} {dt:8.3f} {eff:9.1%}")
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--processes", type=int, default=0,
                   help="multi-process mode: number of worker processes")
    p.add_argument("--cpu-devices", type=int, default=4,
                   help="virtual CPU devices per process (multi-process "
                        "mode); 0 pins each process to its own GPU")
    p.add_argument("--res", type=int,
                   default=int(os.environ.get("SCALE_RES", "256")))
    p.add_argument("--spp", type=int,
                   default=int(os.environ.get("SCALE_SPP", "8")))
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--pin-cpus", action="store_true",
                   help="pin each worker to a disjoint core (taskset) so "
                        "efficiency measures the scaling path, not core "
                        "oversubscription")
    args = p.parse_args()
    if args.processes > 1:
        multi_process_table(args)
    else:
        single_process_table(args)


if __name__ == "__main__":
    main()
