"""Kernel-backed render pipeline.

Same contract as render.pipeline.render_image (same RNG lattice per ray id,
same image up to float summation order), with the whole wavefront loop fused
into the respawn kernel (kernels/respawn.py). Pixels are fed in tiles of
BLOCK pixels, one tw x th rectangle per kernel program, so the lanes of a
program look at neighbouring pixels and tend to take the same branches; the
stateless RNG keys off the true ray id, so the tiling cannot change the
image.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from rays1bench.core import route
from rays1bench.core.config import RenderConfig
from rays1bench.kernels.respawn import tile_grid, trace_respawn, untile
from rays1bench.render.camera import Camera
from rays1bench.scene.soa_spheres import SphereSOA
from rays1bench.scene.spheres import prepare

# Launch parameters measured on an H100 at 1280x720 on the large scene
# (PERF.md, "Kernel decisions"): one warp per 32-pixel program.
BLOCK = 32
NUM_WARPS = 1
UNROLL = 4


def prepare_trimmed(spheres_soa: SphereSOA, n_real: Optional[int]):
    """Scene prep shared by the single-device and sharded kernel paths:
    with `n_real` (the static count of real spheres, builders.Scene.n_real)
    the placeholder rows are dropped, so the sweep visits only real
    spheres. Real rows keep their order, so the closest hit (first minimum
    on ties) cannot change."""
    if n_real is not None:
        keep = jnp.argsort(spheres_soa.radius == 0.0, stable=True)[:n_real]
        spheres_soa = dataclasses.replace(spheres_soa, **{
            f.name: jnp.take(getattr(spheres_soa, f.name), keep)
            for f in dataclasses.fields(spheres_soa)})
    return prepare(spheres_soa)


def render_image_pallas(spheres_soa: SphereSOA, camera: Camera,
                        cfg: RenderConfig, n_real: Optional[int] = None,
                        interpret: bool = False
                        ) -> Tuple[jax.Array, jax.Array]:
    """Render a linear-radiance float image with the respawn kernel.

    Returns (image f32[H, W, 3] with row 0 at the bottom, uint32 ray count),
    like render.pipeline.render_image. The kernel runs compiled for the GPU,
    or in the Pallas interpreter with interpret=True (core/route.py); there
    is no other route."""
    route.kernel_route(interpret)
    return _render_jit(spheres_soa, camera, cfg, n_real, interpret)


@functools.partial(jax.jit, static_argnames=("cfg", "n_real", "interpret"))
def _render_jit(spheres_soa, camera, cfg, n_real, interpret):
    spheres = prepare_trimmed(spheres_soa, n_real)
    gy, gx, _, _ = tile_grid(cfg, BLOCK)
    span = jnp.asarray([0, 0, cfg.spp, 0], jnp.int32)
    sums, num_rays = trace_respawn(spheres, camera, span, cfg, gy * gx,
                                   BLOCK, NUM_WARPS, UNROLL,
                                   interpret=interpret)
    image = jnp.stack([untile(a, cfg, BLOCK) for a in sums], axis=-1)
    return image * jnp.float32(1.0 / cfg.spp), num_rays
