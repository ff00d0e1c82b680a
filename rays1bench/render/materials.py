"""Branchless material scatter.

The reference dispatches through the one virtual call it kept,
Material::scatter (reference: src/latest/rayweek1.cpp:131-136, implementations
at :396-512). Virtual dispatch per ray is the opposite of SPMD; here all three
material responses are computed dense over the wavefront and selected by the
integer mat_type column — the SPMD analog of sorting by material, which for
three trivially cheap BRDFs is not worth the shuffle.

Semantics preserved per material:
  Lambertian (rayweek1.cpp:396-412): target = p + n + ball; always scatters.
  Metal     (rayweek1.cpp:419-437): mirror + fuzz*ball; absorbed when the
            scattered direction leaves through the surface.
  Dielectric (rayweek1.cpp:461-512): reflect/refract with Schlick probability.
"""

from __future__ import annotations

import jax.numpy as jnp

from rays1bench.core import rng as rng_mod
from rays1bench.core.vecmath import dot3, normalize3, reflect3, safe_sqrt
from rays1bench.render.intersect import HitRecord
from rays1bench.scene.spheres import METAL, DIELECTRIC


def scatter(dx, dy, dz, rec: HitRecord, seed, ray_id, bounce):
    """Scatter the wavefront at its hit points.

    Args:
      dx, dy, dz: incoming (normalized) directions, float32[N].
      rec: hit record with material columns.
      seed, ray_id, bounce: RNG lattice coordinates.

    Returns:
      (sx, sy, sz): scattered directions (normalized),
      (ar, ag, ab): attenuation multipliers,
      ok:           bool[N], False where the ray is absorbed.
    """
    nx, ny, nz = rec.nx, rec.ny, rec.nz

    bx, by, bz = rng_mod.in_unit_ball(seed, ray_id, bounce,
                                      rng_mod.Slots.SCATTER_BALL)

    # --- Lambertian: new direction ~ normalize(n + ball) ------------------ #
    lx, ly, lz = normalize3(nx + bx, ny + by, nz + bz)

    # --- Metal: reflect + fuzz * ball ------------------------------------- #
    rx, ry, rz = reflect3(dx, dy, dz, nx, ny, nz)
    mx, my, mz = normalize3(rx + rec.fuzz * bx,
                            ry + rec.fuzz * by,
                            rz + rec.fuzz * bz)
    metal_ok = dot3(mx, my, mz, nx, ny, nz) > 0.0

    # --- Dielectric: Schlick reflect / refract ---------------------------- #
    d_dot_n = dot3(dx, dy, dz, nx, ny, nz)
    exiting = d_dot_n > 0.0
    # outward normal, eta ratio, cosine (rayweek1.cpp:479-490)
    onx = jnp.where(exiting, -nx, nx)
    ony = jnp.where(exiting, -ny, ny)
    onz = jnp.where(exiting, -nz, nz)
    ri = rec.ref_idx
    ni_over_nt = jnp.where(exiting, ri, 1.0 / ri)
    cosine = jnp.where(exiting, ri * d_dot_n, -d_dot_n)
    # refract (rayweek1.cpp:439-452). The trailing normalize looks
    # redundant (for unit d and EXACTLY unit n the refracted vector is
    # analytically unit, and the reference skips it) but is load-bearing:
    # n = (p - c) * inv_radius inherits the t-solve's cancellation error
    # (~1e-4 on the r=100 ground sphere), and without renormalization that
    # error compounds through deep glass chains — measured on the large
    # scene at 250 spp / 50 bounces: ray count drifts +0.48% and
    # throughput LOSES 4.8% (longer paths), vs +0.5%/+0.2% saved on
    # small/medium (2026-08-21). Keep it.
    dt = dot3(dx, dy, dz, onx, ony, onz)
    refr_disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    can_refract = refr_disc > 0.0
    rd = safe_sqrt(refr_disc)
    fx = ni_over_nt * (dx - onx * dt) - onx * rd
    fy = ni_over_nt * (dy - ony * dt) - ony * rd
    fz = ni_over_nt * (dz - onz * dt) - onz * rd
    fx, fy, fz = normalize3(fx, fy, fz)
    # schlick (rayweek1.cpp:454-459)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    one_c = 1.0 - cosine
    one_c2 = one_c * one_c
    schlick_p = r0 + (1.0 - r0) * one_c2 * one_c2 * one_c
    reflect_prob = jnp.where(can_refract, schlick_p, 1.0)
    u = rng_mod.uniform01(seed, ray_id, bounce, rng_mod.Slots.DIELECTRIC_P)
    take_reflect = u < reflect_prob
    # reflected direction is already unit length for unit d (mirror of a unit
    # vector); reuse the metal reflection components rx, ry, rz.
    gx = jnp.where(take_reflect, rx, fx)
    gy = jnp.where(take_reflect, ry, fy)
    gz = jnp.where(take_reflect, rz, fz)

    # --- select by material code ------------------------------------------ #
    is_metal = rec.mat_type == METAL
    is_diel = rec.mat_type == DIELECTRIC

    sx = jnp.where(is_diel, gx, jnp.where(is_metal, mx, lx))
    sy = jnp.where(is_diel, gy, jnp.where(is_metal, my, ly))
    sz = jnp.where(is_diel, gz, jnp.where(is_metal, mz, lz))

    # Dielectric attenuation is (1,1,1) (rayweek1.cpp:470); its albedo columns
    # are stored as 1, so the albedo select is uniform.
    ar, ag, ab = rec.albedo_x, rec.albedo_y, rec.albedo_z
    # Pure boolean form: only metals can absorb (rayweek1.cpp:433).
    ok = metal_ok | ~is_metal
    return (sx, sy, sz), (ar, ag, ab), ok
