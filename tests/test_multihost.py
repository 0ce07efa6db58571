"""Multi-process (multi-"host") execution tests.

Spawns REAL separate OS processes, each with 4 virtual CPU devices, joined
by jax.distributed over localhost — the functional stand-in for one
process per GPU (gloo standing in for NCCL between processes). Checks:

  1. the 2-process x 4-device assembled image matches a plain
     single-process render of the same config (the parity check an earlier
     review asked for);
  2. both processes agree on the image statistic (the allgather really is
     global).

The reference's only cross-process machinery was joblib with pickled
scenes (reference main.py:51-55); there was nothing to test against more
than one host. These tests are the framework's own.
"""

import json
import os
import socket
import subprocess
import tempfile
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(REPO, "tests", "data", "cornell_box.json")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers(n_proc, cpu_devices, out_path, res=32, spp=2, depth=2, sp=1,
                   train_steps=0):
    port = _free_port()
    procs = []
    logs = []  # (stdout, stderr) temp files: pipes would deadlock if a
    # later worker fills its buffer while process 0 blocks in a collective
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # worker sets platform itself
    for pid in range(n_proc):
        cmd = [
            sys.executable, "-m", "pyrenderer_tpu.dist.worker", CORNELL,
            "--coordinator", f"localhost:{port}",
            "--num-processes", str(n_proc),
            "--process-id", str(pid),
            "--cpu-devices", str(cpu_devices),
            "--res", str(res), "--spp", str(spp), "--depth", str(depth),
            "--sp", str(sp),
        ]
        if train_steps:
            cmd += ["--train-steps", str(train_steps)]
        if pid == 0 and out_path:
            cmd += ["--out", out_path]
        fo = tempfile.TemporaryFile(mode="w+")
        fe = tempfile.TemporaryFile(mode="w+")
        logs.append((fo, fe))
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=fo, stderr=fe))
    results = []
    try:
        for p, (fo, fe) in zip(procs, logs):
            p.wait(timeout=600)
            fo.seek(0)
            fe.seek(0)
            out, err = fo.read(), fe.read()
            assert p.returncode == 0, f"worker failed:\nSTDOUT:{out}\nSTDERR:{err[-3000:]}"
            line = [l for l in out.splitlines() if l.startswith("RESULT ")]
            assert line, f"no RESULT line:\n{out}\n{err[-2000:]}"
            results.append(json.loads(line[-1][len("RESULT "):]))
        return results
    finally:
        for p in procs:          # kill survivors on timeout/assert
            if p.poll() is None:
                p.kill()
        for fo, fe in logs:
            fo.close()
            fe.close()


@pytest.mark.slow
def test_two_process_render_matches_single_process(tmp_path):
    out2 = str(tmp_path / "mh2.npy")
    res2 = _spawn_workers(2, 4, out2)
    assert all(r["multi"] for r in res2)
    assert all(r["num_processes"] == 2 for r in res2)
    assert all(r["global_devices"] == 8 for r in res2)
    # every process saw the same assembled frame
    assert abs(res2[0]["image_mean"] - res2[1]["image_mean"]) < 1e-6

    # single-process reference of the same config (1 proc, 4 devices)
    out1 = str(tmp_path / "mh1.npy")
    res1 = _spawn_workers(1, 4, out1)
    assert res1[0]["num_processes"] == 1

    img2 = np.load(out2)
    img1 = np.load(out1)
    assert img2.shape == img1.shape == (32, 32, 3)
    np.testing.assert_allclose(img2, img1, rtol=2e-5, atol=2e-6)


@pytest.mark.slow
def test_two_process_train_step(tmp_path):
    """Inverse-rendering train steps over a cross-process mesh: the
    scene-parameter gradient allreduce (the shard_map psum transpose)
    rides gloo between the two processes — the BASELINE config-5
    cross-process gradient path. Loss AND per-family gradient statistics must
    match the single-process values (this path previously had no
    cross-process test)."""
    res2 = _spawn_workers(2, 4, None, train_steps=2)
    # both processes compute identical (replicated) losses and grads
    assert res2[0]["train_losses"] == pytest.approx(res2[1]["train_losses"],
                                                    rel=1e-6)
    assert res2[0]["grad_mean_abs"] == pytest.approx(res2[1]["grad_mean_abs"],
                                                     rel=1e-6)

    res1 = _spawn_workers(1, 4, None, train_steps=2)
    # and they match the 1-process x 4-device run of the same program
    assert res2[0]["train_losses"] == pytest.approx(res1[0]["train_losses"],
                                                    rel=2e-5)
    assert res2[0]["grad_mean_abs"] == pytest.approx(res1[0]["grad_mean_abs"],
                                                     rel=2e-4)
    assert res2[0]["param_mean_abs"] == pytest.approx(res1[0]["param_mean_abs"],
                                                      rel=2e-5)
    # sane values (monotone decrease is NOT asserted: a 2-spp MC loss
    # estimate is noisy at this step size)
    assert all(np.isfinite(l) and l > 0 for l in res2[0]["train_losses"])
    g_verts, g_albedo, g_emission = res2[0]["grad_mean_abs"]
    assert g_verts > 0 and g_albedo > 0
    # the "reference" estimator ignores scene emission (the reference's
    # hardcoded light color, tracing.py:120), so its gradient is exactly 0
    assert g_emission == 0.0


@pytest.mark.slow
def test_two_process_spp_sharding(tmp_path):
    """dp x sp global mesh across processes: spp shards over sp (the psum
    crosses the process boundary), image still matches single-process."""
    out = str(tmp_path / "mh_sp.npy")
    res = _spawn_workers(2, 4, out, sp=2, spp=4)
    assert all(r["global_devices"] == 8 for r in res)
    out1 = str(tmp_path / "mh_sp1.npy")
    _spawn_workers(1, 4, out1, sp=2, spp=4)
    np.testing.assert_allclose(np.load(out), np.load(out1), rtol=2e-5, atol=2e-6)
