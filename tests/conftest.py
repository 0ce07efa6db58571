"""Test environment: the CPU backend with 8 virtual devices for mesh tests.

The one exception is `-m gpu` (tests/test_gpu.py, run on a GPU machine):
then JAX keeps its default platform. The choice depends only on the
command line, so every xdist worker makes the same one, and it is made
in pytest_configure, before any test module imports jax.
"""

import os

import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    # pin in-process too, in case jax was imported (and its platform
    # latched) before this hook ran
    import jax

    jax.config.update("jax_platforms", "cpu")


CORNELL_JSON = os.path.join(os.path.dirname(__file__), "data", "cornell_box.json")


@pytest.fixture(scope="session")
def cornell_path():
    return CORNELL_JSON
