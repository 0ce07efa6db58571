"""Entry-point plumbing that runs on the CPU: the GPU-only scripts refuse
to run here, the compile-cache rule, PNG output without an image library,
and the profiling helpers."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """No accelerator: exit non-zero and print no result line."""
    r = _run(["chip_smoke.py"], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """The script without the rest of the repo next to it fails too."""
    script = tmp_path / "chip_smoke.py"
    script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu():
    r = _run(["bench.py"], ROOT)
    assert r.returncode != 0
    assert "measures the GPU" in r.stderr
    assert "Mrays/s" not in r.stdout


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_rule(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and is left to JAX; otherwise the
    cache goes to <checkout>/.jax_cache, a fixed path."""
    from pyrenderer_tpu.utils import compile_cache

    old = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", old)
            assert compile_cache.use_checkout_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == old
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.use_checkout_cache()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_png_round_trip(tmp_path):
    """write_png needs only NumPy + zlib; an independent decoder reads back
    exactly the quantized pixels."""
    import imageio.v3 as iio

    from pyrenderer_tpu.utils.image_io import write_png

    rs = np.random.RandomState(0)
    ldr = rs.uniform(-0.2, 1.2, (17, 23, 3))
    path = str(tmp_path / "x.png")
    write_png(path, ldr)
    back = iio.imread(path)
    want = (np.clip(ldr, 0, 1) * 255 + 0.5).astype(np.uint8)
    assert back.shape == (17, 23, 3) and back.dtype == np.uint8
    assert np.array_equal(back, want)
    gray = rs.uniform(0, 1, (5, 4))
    write_png(path, gray)
    assert iio.imread(path).shape == (5, 4, 3)


def test_device_timer_waits_for_payload():
    from pyrenderer_tpu.utils.profiling import DeviceTimer

    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((256, 256))
    with DeviceTimer() as t:
        t.payload = f(x)
    assert t.seconds > 0
    assert float(t.payload) == 256.0 ** 3


def test_trace_profile_propagates_errors(monkeypatch, tmp_path):
    """A run asked to trace does not silently go on without its trace."""
    import contextlib

    from pyrenderer_tpu.utils import profiling

    @contextlib.contextmanager
    def broken(_):
        raise RuntimeError("profiler unavailable")
        yield

    monkeypatch.setattr(profiling.jax.profiler, "trace", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with profiling.trace_profile(str(tmp_path)):
            pass
    with profiling.trace_profile(None):   # no directory: no profiler
        pass


@pytest.mark.parametrize("pid,n_cards,on_cpu,want", [
    (0, 4, False, [0]),
    (3, 4, False, [3]),
    (5, 4, False, [1]),
    (1, 4, True, None),
    (1, 0, False, None),
])
def test_one_process_per_card(pid, n_cards, on_cpu, want):
    """multihost.initialize pins each GPU process to its own card."""
    from pyrenderer_tpu.dist import multihost

    assert multihost.card_ids(pid, n_cards, on_cpu) == want


def test_initialize_passes_card_to_jax(monkeypatch):
    from pyrenderer_tpu.dist import multihost

    seen = {}
    monkeypatch.setattr(multihost.jax.distributed, "initialize",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(multihost, "_gpu_count", lambda: 4)
    assert multihost.initialize("localhost:1234", 2, 1) is True
    # this process runs on the CPU: no card to pin
    assert seen == {"coordinator_address": "localhost:1234",
                    "num_processes": 2, "process_id": 1}
    assert multihost.initialize(None, 1, 0) is False
