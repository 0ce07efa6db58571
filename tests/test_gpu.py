"""Checks that need an NVIDIA GPU: the compiled whole-table kernel at real
widths and gradient parity against the CPU. Marked `gpu`; without a GPU
they skip (decided inside each test, never at import). Run them on the
card with `python -m pytest tests/test_gpu.py -m gpu`; chip_smoke.py runs
the same checks as its kernel and gradient phases."""

import jax
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; this process runs on "
                    f"{jax.default_backend()}")
    import chip_smoke

    chip_smoke.CARD = "pytest"
    return chip_smoke


def test_compiled_kernel_matches_brute(gpu):
    """2^16 rays x 36 and x 3,852 tris, closest and any hit."""
    gpu.phase_kernel()


def test_gradients_match_cpu(gpu):
    gpu.grad_parity()
