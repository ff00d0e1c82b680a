"""Image rendering pipeline: ray generation, chunked wavefront, assembly.

Replaces the reference's tile renderer + per-pixel sample loop (reference:
src/latest/rayweek1.cpp:722-782). There, parallelism is tiles-over-threads with
mutable RNG streams; here every primary ray has a global integer id
    ray_id = (y * W + x) * spp + s
from which everything — pixel coords, film jitter, lens sample, every bounce's
scatter draws — is derived statelessly (core/rng.py). Ray order is therefore
irrelevant: any chunking, sharding, or reordering renders the identical image.

The flattened ray stream is processed in fixed-size chunks via lax.map (the
scheduler analog of the reference's tile queue, but static: SPMD code wants a
static schedule, not an atomic work counter, SURVEY.md §2.3). Each chunk runs
the full wavefront loop; radiance lands back in a (pixels, spp) matrix and is
averaged, gamma-corrected (gamma = sqrt, rayweek1.cpp:767) and quantized
(*255.99, rayweek1.cpp:769-775) exactly like the reference.

Row convention: y = 0 is the *bottom* image row (v = y / H), matching the
reference's film parametrization and its bottom-up TGA layout.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from jax.ad_checkpoint import checkpoint_name

from rays1bench.core import rng as rng_mod
from rays1bench.core.config import RenderConfig
from rays1bench.render.camera import Camera
from rays1bench.render.integrator import trace
from rays1bench.render.intersect import closest_index, \
    hit_record_from_index
from rays1bench.scene.soa_spheres import SphereSOA
from rays1bench.scene.spheres import prepare


def _index_sweep(cfg: RenderConfig):
    """The closest-hit index sweep: the Triton kernel when
    cfg.pallas_intersect is true (compiled for the GPU; core/route.py), else
    XLA's fused reduction (render/intersect.closest_index)."""
    if not cfg.pallas_intersect:
        return closest_index
    from rays1bench.core import route
    from rays1bench.kernels.intersect_pallas import closest_hit_index
    route.kernel_route()

    def sweep(ox, oy, oz, dx, dy, dz, spheres, t_min, t_max):
        del t_max  # always FLT_MAX on this path
        return closest_hit_index(spheres, ox, oy, oz, dx, dy, dz, t_min)
    return sweep


def _trace_chunk(spheres, camera: Camera, ray_id, active, seed,
                 cfg: RenderConfig, remat: bool = False):
    """Generate and trace one chunk of primary rays by global ray id.

    remat: rematerialize bounce bodies in the backward (integrator.trace) —
    the caller sets it when multiple chunks would stack their per-bounce
    residuals under lax.map."""
    spp = jnp.int32(cfg.spp)
    pixel = ray_id // spp
    x = (pixel % jnp.int32(cfg.width)).astype(jnp.float32)
    y = (pixel // jnp.int32(cfg.width)).astype(jnp.float32)

    # Film jitter: uv = (rand + xy) / (W, H)  (rayweek1.cpp:757-759).
    ju, jv = rng_mod.pixel_jitter(seed, ray_id)
    s = (x + ju) * jnp.float32(1.0 / cfg.width)
    t = (y + jv) * jnp.float32(1.0 / cfg.height)

    ox, oy, oz, dx, dy, dz = camera.generate_rays(s, t, seed, ray_id)
    sweep = _index_sweep(cfg)
    t_min, t_max = float(cfg.t_min), float(cfg.t_max)
    soft_eps = float(cfg.soft_silhouette)

    def intersector(ox_, oy_, oz_, dx_, dy_, dz_, sph, tmin, tmax, bounce):
        del tmin, tmax, bounce  # traced copies / unused here
        idx, hit = sweep(ox_, oy_, oz_, dx_, dy_, dz_, sph, t_min, t_max)
        # Named for the gradient path's remat policy (render/integrator.py):
        # the per-bounce hit topology is the ONLY saved residual; the O(N)
        # differentiable chain is rematerialized from it in the backward.
        idx = checkpoint_name(idx, "hit_idx")
        hit = checkpoint_name(hit, "hit_mask")
        return hit_record_from_index(ox_, oy_, oz_, dx_, dy_, dz_, sph,
                                     idx, hit, t_min, soft_eps=soft_eps)

    (rr, rg, rb), num_rays = trace(
        spheres, ox, oy, oz, dx, dy, dz, seed, ray_id,
        max_bounces=cfg.max_bounces, t_min=cfg.t_min, t_max=cfg.t_max,
        early_exit=cfg.early_exit, active=active, intersector=intersector,
        remat=remat, soft_eps=soft_eps)
    return rr, rg, rb, num_rays


@partial(jax.jit, static_argnames=("cfg",))
def render_image(spheres_soa: SphereSOA, camera: Camera, cfg: RenderConfig
                 ) -> Tuple[jax.Array, jax.Array]:
    """Render a linear-radiance float image.

    Returns:
      image: float32[H, W, 3], per-pixel mean radiance (pre-gamma), row 0 at
             the image bottom.
      num_rays: uint32 total rays traced (reference metric, counts bounces).

    Differentiable w.r.t. the SphereSOA leaves when cfg.early_exit is
    False."""
    spheres = prepare(spheres_soa)
    n = cfg.num_primary_rays
    chunk = min(cfg.ray_chunk, _round_up(n, 1024))
    padded = _round_up(n, chunk)
    num_chunks = padded // chunk

    ids = jnp.arange(padded, dtype=jnp.int32).reshape(num_chunks, chunk)
    seed = jnp.uint32(cfg.seed)
    # Remat bounce bodies only when lax.map would stack per-chunk residuals
    # (single-chunk renders keep everything live).
    remat = num_chunks > 1

    def body(ray_id):
        return _trace_chunk(spheres, camera, ray_id, ray_id < n, seed, cfg,
                            remat=remat)

    rr, rg, rb, counts = jax.lax.map(body, ids)
    rad = jnp.stack([rr.reshape(-1)[:n], rg.reshape(-1)[:n],
                     rb.reshape(-1)[:n]], axis=-1)
    image = rad.reshape(cfg.height, cfg.width, cfg.spp, 3).mean(axis=2)
    return image, jnp.sum(counts)


def to_srgb_u8(image: jax.Array) -> jax.Array:
    """Gamma (sqrt) + 255.99 quantization to uint8 (rayweek1.cpp:765-775)."""
    g = jnp.sqrt(jnp.clip(image, 0.0, 1.0))
    return (g * 255.99).astype(jnp.uint8)


def render_scene(scene, cfg: RenderConfig):
    """Convenience wrapper: build the camera, render, quantize.

    Returns (u8_image[H, W, 3] with row 0 = bottom, num_rays: int).
    """
    camera = scene.camera.build()
    image, num_rays = render_image(scene.spheres, camera, cfg)
    return to_srgb_u8(image), int(num_rays)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m
