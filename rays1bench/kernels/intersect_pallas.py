"""Closest-hit *index* sweep as a Pallas kernel (Triton route), for the
differentiable pipeline.

The gradient path needs gradients through the hit record but not through
the argmin that picks the hit sphere (its index is stop_gradient'ed by
design, SURVEY.md §7.3). Stage 1 — rays -> best sphere index — is this
kernel; stage 2, the O(N) differentiable hit record, stays in XLA
(render/intersect.hit_record_from_index). custom_vjp declares the outputs
tangent-free, so reverse-mode AD never transposes the pallas_call.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from rays1bench.kernels.respawn import closest_index, pack_spheres
from rays1bench.scene.spheres import PreparedSpheres

_UNROLL = 4


def _index_kernel(table_ref, ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                  idx_ref, hit_ref, *, count: int, t_min: float):
    bt, bi = closest_index(table_ref, ox_ref[...], oy_ref[...], oz_ref[...],
                           dx_ref[...], dy_ref[...], dz_ref[...],
                           count=count, unroll=_UNROLL, t_min=t_min)
    idx_ref[...] = bi
    hit_ref[...] = (bt < np.float32(3e38)).astype(jnp.int32)


@functools.partial(jax.custom_vjp, nondiff_argnums=(7, 8, 9, 10))
def closest_hit_index(spheres: PreparedSpheres, ox, oy, oz, dx, dy, dz,
                      t_min: float, block: int = 128, num_warps: int = 4,
                      interpret: bool = False
                      ) -> Tuple[jax.Array, jax.Array]:
    """(best_idx int32[N], hit bool[N]) for N rays, N padded to `block`
    internally. Treated as a constant under differentiation. The caller
    picks the route (render/pipeline._index_sweep, core/route.py)."""
    n = ox.shape[0]
    pad = (-n) % block
    # Padding directions are zero: disc = -|c - o|^2 < 0 for every sphere.
    rays = [jnp.pad(a, (0, pad)) for a in (ox, oy, oz, dx, dy, dz)]
    table = pack_spheres(spheres, rows=-(-spheres.count // _UNROLL) * _UNROLL)
    lanes = pl.BlockSpec((block,), lambda i: (i,))
    out = jax.ShapeDtypeStruct((n + pad,), jnp.int32)
    idx, hit = pl.pallas_call(
        functools.partial(_index_kernel, count=spheres.count, t_min=t_min),
        grid=((n + pad) // block,),
        in_specs=[pl.BlockSpec(table.shape, lambda i: (0, 0))] + [lanes] * 6,
        out_specs=(lanes, lanes),
        out_shape=(out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="closest_hit_index",
    )(table, *rays)
    return idx[:n], hit[:n] > 0


def _fwd(spheres, ox, oy, oz, dx, dy, dz, t_min, block, num_warps,
         interpret):
    out = closest_hit_index(spheres, ox, oy, oz, dx, dy, dz, t_min, block,
                            num_warps, interpret)
    return out, (spheres, ox, oy, oz, dx, dy, dz)


def _bwd(t_min, block, num_warps, interpret, residuals, cotangents):
    # Hit topology is constant under differentiation: zero tangents for
    # every primal input (the sphere pytree and the six ray arrays).
    del cotangents
    return jax.tree_util.tree_map(jnp.zeros_like, residuals)


closest_hit_index.defvjp(_fwd, _bwd)
