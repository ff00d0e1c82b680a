"""SPMD sharded rendering over a device mesh.

Replaces the reference's tile scheduler (rayweek1.cpp:785-842): primary rays
are statically split across the mesh's "rays" axis via `shard_map`; the sphere
SoA and camera are replicated (in_specs P()); the ray counter is psum-reduced
— the collective analog of the reference's thread-join reduction
(rayweek1.cpp:809-813). Because the RNG is stateless in the global ray id, the
sharded image is bit-identical to the single-device one.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from rays1bench.core.config import RenderConfig
from rays1bench.render.camera import Camera
from rays1bench.render.pipeline import _trace_chunk, _round_up
from rays1bench.scene.soa_spheres import SphereSOA
from rays1bench.scene.spheres import prepare


@partial(jax.jit, static_argnames=("cfg", "mesh", "axis_name"))
def render_image_sharded(spheres_soa: SphereSOA, camera: Camera,
                         cfg: RenderConfig, mesh: Mesh,
                         axis_name: str = "rays"
                         ) -> Tuple[jax.Array, jax.Array]:
    """Render with primary rays sharded over `mesh`'s `axis_name` axis.

    Returns (image float32[H, W, 3], num_rays uint32) — numerically identical
    to render_image() regardless of device count.
    """
    n_dev = mesh.shape[axis_name]
    n = cfg.num_primary_rays
    # Each device gets whole chunks; pad the ray stream to n_dev * chunk.
    chunk = min(cfg.ray_chunk, _round_up(-(-n // n_dev), 1024))
    per_dev = _round_up(-(-n // n_dev), chunk)
    padded = per_dev * n_dev
    num_chunks = per_dev // chunk

    ids = jnp.arange(padded, dtype=jnp.int32).reshape(n_dev, num_chunks, chunk)
    seed = jnp.uint32(cfg.seed)
    spheres = prepare(spheres_soa)

    def local(ids_local, spheres, camera):
        # ids_local: (1, num_chunks, chunk) block of this device's rays.
        def body(ray_id):
            return _trace_chunk(spheres, camera, ray_id, ray_id < n, seed,
                                cfg, remat=num_chunks > 1)
        rr, rg, rb, counts = jax.lax.map(body, ids_local[0])
        count = jax.lax.psum(jnp.sum(counts), axis_name)
        return rr[None], rg[None], rb[None], count

    # check_vma=False: the gradient path's index kernel
    # (cfg.pallas_intersect) has out_shapes without varying-mesh-axes
    # metadata, which the vma checker rejects inside shard_map.
    rr, rg, rb, count = shard_map(
        local, mesh=mesh,
        in_specs=(P(axis_name), P(), P()),
        out_specs=(P(axis_name), P(axis_name), P(axis_name), P()),
        check_vma=False,
    )(ids, spheres, camera)

    rad = jnp.stack([rr.reshape(-1)[:n], rg.reshape(-1)[:n],
                     rb.reshape(-1)[:n]], axis=-1)
    image = rad.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(axis=2)
    return image, count


@partial(jax.jit, static_argnames=("cfg", "mesh", "axis_name", "n_real",
                                   "sample_axis", "interpret", "telemetry"))
def _render_pallas_sharded(spheres_soa, camera, cfg, mesh, axis_name,
                           n_real, sample_axis, interpret, telemetry):
    from rays1bench.kernels.pipeline import (BLOCK, NUM_WARPS, UNROLL,
                                             prepare_trimmed)
    from rays1bench.kernels.respawn import (tile_grid, trace_respawn,
                                            untile)

    spheres = prepare_trimmed(spheres_soa, n_real)
    n_dev = mesh.shape[axis_name]
    n_samp = mesh.shape[sample_axis] if sample_axis else 1
    assert cfg.spp % n_samp == 0, (cfg.spp, n_samp)
    spp_loc = cfg.spp // n_samp
    gy, gx, _, _ = tile_grid(cfg, BLOCK)
    tiles_per_dev = -(-(gy * gx) // n_dev)

    def local(spheres, camera):
        i = jax.lax.axis_index(axis_name).astype(jnp.int32)
        j = (jax.lax.axis_index(sample_axis).astype(jnp.int32)
             if sample_axis else jnp.int32(0))
        span = jnp.stack([i * tiles_per_dev, j * spp_loc,
                          (j + 1) * spp_loc, jnp.int32(0)])
        out = trace_respawn(spheres, camera, span, cfg, tiles_per_dev, BLOCK,
                            NUM_WARPS, UNROLL, interpret=interpret,
                            debug_iters=telemetry)
        (rr, rg, rb), nr = out[:2]
        axes = (axis_name, sample_axis) if sample_axis else axis_name
        shape = (1, 1, -1) if sample_axis else (1, -1)
        telem = ()
        if telemetry:
            telem = (nr.reshape(shape[:-1]),
                     jnp.sum(out[2]).astype(jnp.int32).reshape(shape[:-1]))
        return (rr.reshape(shape), rg.reshape(shape), rb.reshape(shape),
                jax.lax.psum(nr, axes)) + telem

    # check_vma=False: pallas_call's out_shapes carry no varying-mesh-axes
    # metadata, which the vma checker (on by default) rejects inside
    # shard_map.
    spec = P(axis_name, sample_axis) if sample_axis else P(axis_name)
    out_specs = (spec, spec, spec, P()) + ((spec, spec) if telemetry else ())
    outs = shard_map(local, mesh=mesh, in_specs=(P(), P()),
                     out_specs=out_specs, check_vma=False)(spheres, camera)

    def image_plane(a):
        # Partial sums over sample slices add here (sums are order-free up
        # to float rounding).
        a = a.reshape(n_dev, n_samp, -1).sum(axis=1).reshape(-1)
        return untile(a, cfg, BLOCK)

    image = jnp.stack([image_plane(a) for a in outs[:3]], axis=-1)
    image = image * jnp.float32(1.0 / cfg.spp)
    if telemetry:
        return image, outs[3], {"device_rays": outs[4],
                                "device_iters": outs[5]}
    return image, outs[3]


def render_image_pallas_sharded(spheres_soa: SphereSOA, camera: Camera,
                                cfg: RenderConfig, mesh: Mesh,
                                axis_name: str = "rays", n_real=None,
                                sample_axis=None, interpret: bool = False,
                                telemetry: bool = False):
    """The multi-device path: the respawn kernel under shard_map.

    Pixel tiles are split statically across the mesh's `axis_name` axis in
    contiguous ranges (the SPMD replacement for the reference's atomic tile
    queue, rayweek1.cpp:830-842); the trimmed sphere SoA and the camera are
    replicated; each device runs the kernel on its tiles; the ray counter is
    psum-reduced. Stateless RNG on global ray ids makes every ray identical
    to the single-device render, so counts match exactly and pixel values
    match bitwise on a tiles-only mesh.

    sample_axis: optional second mesh axis splitting each pixel's samples
    (SURVEY.md §7.2-6's (tiles, samples) mesh); mesh.shape[sample_axis] must
    divide cfg.spp. Partial pixel sums are added after the shard_map, so
    pixels match the single-device render up to summation order.

    telemetry: additionally return a dict of per-DEVICE load metrics (the
    SPMD analog of the reference's per-thread ray counters,
    rayweek1.cpp:79-95, 809-813): "device_rays" — rays traced by each
    device — and "device_iters" — kernel loop steps summed over the
    device's programs. Programs run in parallel on a GPU, so device_iters
    is each device's total work, not its time; its spread across devices is
    the load-imbalance signal that equal tile counts cannot show."""
    from rays1bench.core import route
    route.kernel_route(interpret)
    return _render_pallas_sharded(spheres_soa, camera, cfg, mesh, axis_name,
                                  n_real, sample_axis, interpret, telemetry)
