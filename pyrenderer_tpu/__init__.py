"""pyrenderer_tpu — a differentiable Monte-Carlo path tracer in JAX.

A ground-up re-design of the capabilities of sontung/pyrenderer
(a CPU/Numba + GPU/Taichi path tracer) as data-parallel JAX programs that
run on the GPU (and, for tests, on the CPU):

- **Wavefront integrator** (`core/integrator.py`): `lax.scan` over bounces on
  SoA ray buffers with alive-masks — no divergent megakernel
  (reference: core/tracing.py:117 per-pixel bounce loop).
- **Whole-table intersection kernel** (`kernels/pallas_intersect.py`): a
  fused Pallas (Triton) closest-hit / any-hit loop, one ray per thread
  (reference: mathematics/intersection.py:42, intersection_taichi.py:69);
  BVH traversal (`accel/bvh.py`) for large scenes.
- **Counter-based RNG** (`rng.py` / `ref/rng_np.py`): threefry2x32 keyed by
  (pixel, sample, bounce, use) — bit-identical between the NumPy CPU oracle
  and the JAX path (reference RNG was unseeded taichi_glsl/np.random).
- **Differentiable end-to-end**: radiance as a function of
  (vertices, albedo, emission) with detached discrete decisions.
- **Multi-device** (`dist/`): pixel-tile × spp sharding over a
  `jax.sharding.Mesh` with `psum` accumulation.
"""

__version__ = "0.1.0"

from pyrenderer_tpu.scene.types import Scene, Camera  # noqa: F401
from pyrenderer_tpu.config import RenderConfig  # noqa: F401
from pyrenderer_tpu import analytic  # noqa: F401  (standalone analytic tracer;
# CLI: `python -m pyrenderer_tpu.render.cli analytic`)
