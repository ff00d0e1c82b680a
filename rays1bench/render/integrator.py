"""Wavefront radiance integrator.

The reference computes radiance recursively — color() calls itself per bounce
up to MAX_BOUNCES (reference: src/latest/rayweek1.cpp:515-536). Recursion with
data-dependent depth cannot be traced; the traceable form is an *iterative
masked wavefront*: the whole ray batch advances one bounce per loop iteration,
carrying (origin, direction, attenuation, radiance, alive) lanes, with dead
lanes masked. `lax.while_loop` exits as soon as every lane is dead (the analog
of the recursion's early return); a fixed-trip variant exists for reverse-mode
AD, which cannot differentiate a while loop.

Radiance identity used: a path's contribution is
    prod(attenuations along path) * sky(last direction)   on a miss,
    0                                                     if absorbed/depth-out,
which is exactly the closed form of the reference recursion.

Ray counting matches the reference metric: one ray per radiance evaluation,
including bounces (++td->out_num_rays, rayweek1.cpp:517) — here, the number of
alive lanes at the top of each iteration.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from rays1bench.core import rng as rng_mod
from rays1bench.render.intersect import closest_hit
from rays1bench.render.materials import scatter
from rays1bench.scene.spheres import PreparedSpheres


def sky_color(dx, dy, dz):
    """Vertical sky gradient lerp(white, (0.5,0.7,1.0), 0.5*(dir.y+1))
    (rayweek1.cpp:530-534)."""
    t = 0.5 * (dy + 1.0)
    s = 1.0 - t
    return s + t * 0.5, s + t * 0.7, s + t * 1.0


def _bounce_step(state, spheres: PreparedSpheres, seed, ray_id,
                 t_min, t_max, max_bounces, intersector=None,
                 soft_eps: float = 0.0):
    (bounce, ox, oy, oz, dx, dy, dz, ar, ag, ab, rr, rg, rb, alive,
     num_rays) = state

    num_rays = num_rays + jnp.sum(alive.astype(jnp.uint32))

    if intersector is None:
        rec = closest_hit(ox, oy, oz, dx, dy, dz, spheres, t_min, t_max,
                          soft_eps=soft_eps)
    else:
        rec = intersector(ox, oy, oz, dx, dy, dz, spheres, t_min, t_max,
                          bounce)

    # Miss -> accumulate attenuated sky, lane dies.
    skr, skg, skb = sky_color(dx, dy, dz)
    miss = alive & ~rec.hit
    rr = rr + jnp.where(miss, ar * skr, 0.0)
    rg = rg + jnp.where(miss, ag * skg, 0.0)
    rb = rb + jnp.where(miss, ab * skb, 0.0)

    # Hit -> scatter if depth allows (depth < MAX_BOUNCES, rayweek1.cpp:523).
    (sx, sy, sz), (mr, mg, mb), ok = scatter(dx, dy, dz, rec, seed, ray_id,
                                             bounce)
    hx, hy, hz = rec.px, rec.py, rec.pz
    if soft_eps:
        # Soft silhouette (cfg.soft_silhouette): detached two-branch
        # estimator. A soft-hit lane either BOUNCES off the winning sphere
        # (probability sg(cover)) or PASSES THROUGH it, resuming straight
        # from the far-exit point (px2..) — so what the silhouette
        # alpha-blends against is the scene actually behind the sphere, not
        # a sky proxy. Branch weights cover/sg(cover) and
        # (1-cover)/sg(1-cover) are exactly 1 at evaluation (the render is
        # the hard image in expectation, converging to it as eps -> 0), but
        # their derivative carries the score term: E[grad] = cover' *
        # (f_bounce - f_through) + interior grads — the unbiased gradient of
        # the alpha-composited relaxation, two-sided at every silhouette.
        # Interior lanes have cover saturated at 1: always bounce, weight 1,
        # zero silhouette term — the exact render.
        sg = jax.lax.stop_gradient
        u = rng_mod.uniform01(seed, ray_id, bounce,
                              rng_mod.Slots.SILHOUETTE_P)
        cov_sg = sg(rec.cover)
        take = u < cov_sg
        w_b = rec.cover / jnp.maximum(cov_sg, 1e-20)
        w_t = (1.0 - rec.cover) / jnp.maximum(1.0 - cov_sg, 1e-20)
        sx = jnp.where(take, sx, dx)   # pass-through keeps the direction
        sy = jnp.where(take, sy, dy)
        sz = jnp.where(take, sz, dz)
        mr = jnp.where(take, mr * w_b, w_t)
        mg = jnp.where(take, mg * w_b, w_t)
        mb = jnp.where(take, mb * w_b, w_t)
        ok = (take & ok) | ~take       # pass-through never absorbs
        hx = jnp.where(take, hx, rec.px2)
        hy = jnp.where(take, hy, rec.py2)
        hz = jnp.where(take, hz, rec.pz2)
    cont = alive & rec.hit & ok & (bounce < max_bounces)

    ox = jnp.where(cont, hx, ox)
    oy = jnp.where(cont, hy, oy)
    oz = jnp.where(cont, hz, oz)
    dx = jnp.where(cont, sx, dx)
    dy = jnp.where(cont, sy, dy)
    dz = jnp.where(cont, sz, dz)
    ar = jnp.where(cont, ar * mr, ar)
    ag = jnp.where(cont, ag * mg, ag)
    ab = jnp.where(cont, ab * mb, ab)

    return (bounce + 1, ox, oy, oz, dx, dy, dz, ar, ag, ab, rr, rg, rb, cont,
            num_rays)


@partial(jax.jit, static_argnames=("max_bounces", "t_min", "t_max",
                                   "early_exit", "intersector", "remat",
                                   "soft_eps"))
def trace(spheres: PreparedSpheres, ox, oy, oz, dx, dy, dz, seed, ray_id,
          max_bounces: int = 50, t_min: float = 1e-3, t_max: float = 3.4e38,
          early_exit: bool = True, active=None, intersector=None,
          remat: bool = False, soft_eps: float = 0.0):
    """Trace a wavefront of N primary rays to completion.

    `active` optionally masks out padding lanes (bool[N]); inactive lanes are
    dead from the start and are never counted.

    `remat` (fixed-trip path with an `intersector` that names its hit
    topology, render/pipeline.py): rematerialize bounce bodies in the
    backward, saving only the per-bounce hit topology instead of the ~30
    N-sized per-bounce residuals — the caller turns it on when chunked
    lax.map would STACK those residuals across chunks.

    Returns ((rr, rg, rb), num_rays): per-ray linear radiance and the number
    of rays traced (uint32; counts bounces, reference metric).
    """
    # Initial carries derive from ox (not fresh constants) so that under
    # shard_map they inherit the rays axis's "varying" type and the loop
    # carry types stay consistent.
    zeros = ox * 0.0
    ones = zeros + 1.0
    alive0 = (zeros < 1.0) if active is None else active
    num0 = zeros.astype(jnp.uint32).sum()
    state = (jnp.int32(0), ox, oy, oz, dx, dy, dz,
             ones, ones, ones, zeros, zeros, zeros,
             alive0, num0)

    body = lambda s: _bounce_step(s, spheres, seed, ray_id,
                                  jnp.float32(t_min), jnp.float32(t_max),
                                  jnp.int32(max_bounces),
                                  intersector=intersector,
                                  soft_eps=soft_eps)

    if early_exit:
        # Recursion-style early exit: stop when every lane is dead. The trip
        # count is dynamic but the shapes are static, so this jits cleanly.
        def cond(s):
            return (s[0] <= max_bounces) & jnp.any(s[13])
        state = jax.lax.while_loop(cond, body, state)
    else:
        # Fixed-trip path for reverse-mode AD (scan-lowered fori_loop).
        if intersector is not None and remat:
            # Gradient path: rematerialize each bounce in the backward,
            # saving ONLY the per-bounce hit topology ("hit_idx" /
            # "hit_mask", named in render/pipeline.py). The backward then
            # replays the O(N) differentiable chain (hit record from index,
            # scatter, attenuation) from the saved indices — the O(N*S)
            # intersection sweep never runs nor stores anything in reverse.
            # This is the replay design from the reference's single shared
            # hot loop (rayweek1.cpp:152-339): one fast forward, gradients
            # at fixed per-bounce hit topology. prevent_cse=False is the
            # documented setting for remat under scan/fori.
            body = jax.checkpoint(
                body,
                policy=jax.checkpoint_policies.save_only_these_names(
                    "hit_idx", "hit_mask"),
                prevent_cse=False)
        # NOTE: unrolling this loop (straight-line graph) was measured to
        # explode compile time ~10x on both backends for no recorded win;
        # keep the scan-lowered fori_loop.
        state = jax.lax.fori_loop(0, max_bounces + 1,
                                  lambda _, s: body(s), state)

    (_, _, _, _, _, _, _, _, _, _, rr, rg, rb, _, num_rays) = state
    return (rr, rg, rb), num_rays
