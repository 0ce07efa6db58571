"""shard_map varying-type (vma) plumbing for Pallas kernels.

jax >= 0.9 `shard_map(check_vma=True)` tracks which mesh axes every value
varies over. `pallas_call` does not infer this: its `out_shape`
ShapeDtypeStructs must carry an explicit `vma`, or tracing fails with "vma on jax.ShapeDtypeStruct must not be
None". These helpers make the kernel in this package callable both
standalone (vma-free) and inside a check_vma shard_map (e.g. the dp/sp
render of dist/render.py, where ray wavefronts vary over the mesh while
the scene tables are replicated):

  - `args_vma(*xs)`: union of the operands' varying axes (empty outside
    shard_map).
  - `struct(shape, dtype, vma)`: ShapeDtypeStruct carrying that vma.

Replicated operands (the scene tables) need no cast: pallas_call accepts
operands of mixed vma.
"""

from __future__ import annotations

import jax


def args_vma(*xs):
    """Union of the arguments' varying mesh axes (frozenset of axis names)."""
    vma = frozenset()
    for x in xs:
        vma = vma | jax.typeof(x).vma
    return vma


def struct(shape, dtype, vma):
    """jax.ShapeDtypeStruct with the given vma."""
    return jax.ShapeDtypeStruct(shape, dtype, vma=vma)
