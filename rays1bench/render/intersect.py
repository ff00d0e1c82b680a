"""Closest-hit ray/sphere intersection (pure-XLA version).

The reference's hot loop (reference: src/latest/rayweek1.cpp:152-339) is a
two-pass AVX2 kernel per ray: an 8-wide discriminant sweep with movemask
compaction of positive lanes, then a scalar closest-t pass over the survivors.
Compaction is branchy and scalar-tail-heavy. Here the same math runs *dense
and masked* over a whole (rays x spheres) tile:

  nb     = dot(center - origin, dir)        (rayweek1.cpp:196)
  c      = dot(co, co) - radius_sq          (rayweek1.cpp:199)
  discr  = nb^2 - c                         (rayweek1.cpp:201)
  t      = nb -/+ sqrt(discr), first root in (t_min, t_max) wins
           (pass 2, rayweek1.cpp:284-314)

and the "collect positives then scan" step becomes a masked argmin over the
sphere axis. Placeholder spheres are masked exactly like the reference's
inv_radius == 0 skip (rayweek1.cpp:291-292).

The ray count per call (N) is the wavefront width; S is the sphere count. The
(N, S) intermediates are element-wise chains XLA fuses into the reduction, so
nothing quadratic is materialized in device memory.

Normalized ray directions are assumed (a = dot(d,d) = 1 — step9 semantics,
src/step9/rayweek1.cpp and SURVEY.md §7.1).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from rays1bench.core.vecmath import safe_sqrt
from rays1bench.scene.spheres import PreparedSpheres

_BIG = jnp.float32(3.0e38)


def _lookup_cols(cols, j):
    """cols[:, j], with j clamped to [0, S): dead lanes may carry any index,
    and every consumer masks them with hit=False."""
    return cols[:, jnp.clip(j, 0, cols.shape[1] - 1)]


@jax.custom_vjp
def take_cols(cols, j):
    """Gather sphere columns by per-ray winning index: (C, S), int[N] -> (C, N).

    The custom VJP replaces the gather's transpose — a scatter-add of N
    per-ray cotangents into S sphere slots, whose atomics add in a different
    order on every run — with a dense one-hot contraction
    sum_n ct[c, n] * (j[n] == s): one (C, N) x (N, S) product for all
    columns, deterministic. It runs at HIGHEST precision: a float32 product
    may otherwise run in TF32 on the GPU, which keeps about three decimal
    digits of each sphere's cotangent sum."""
    return _lookup_cols(cols, j)


def _take_cols_fwd(cols, j):
    return _lookup_cols(cols, j), (j, cols.shape[1])


def _take_cols_bwd(res, ct):
    j, s = res
    onehot = (j[:, None] == jax.lax.iota(jnp.int32, s)[None, :])
    cols_ct = jnp.einsum("cn,ns->cs", ct, onehot.astype(ct.dtype),
                         precision=jax.lax.Precision.HIGHEST)
    return cols_ct, np.zeros(j.shape, dtype=jax.dtypes.float0)


take_cols.defvjp(_take_cols_fwd, _take_cols_bwd)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HitRecord:
    """Planar hit payload (reference HitRecord, rayweek1.cpp:122-128, plus the
    flattened material columns that replace the Material* pointer)."""
    hit: jax.Array        # bool[N]
    t: jax.Array          # float32[N]
    px: jax.Array
    py: jax.Array
    pz: jax.Array
    nx: jax.Array
    ny: jax.Array
    nz: jax.Array
    mat_type: jax.Array   # int32[N]
    albedo_x: jax.Array
    albedo_y: jax.Array
    albedo_z: jax.Array
    fuzz: jax.Array
    ref_idx: jax.Array
    # Soft-silhouette fields (cfg.soft_silhouette > 0 only; None = hard
    # renderer). cover in (0, 1) carries the silhouette-motion gradient;
    # (px2, py2, pz2) is the far-exit point of the winning sphere — where the
    # detached estimator's pass-through branch resumes the ray (integrator).
    cover: object = None
    px2: object = None
    py2: object = None
    pz2: object = None


def closest_index(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                  t_min: float, t_max: float):
    """Stage 1 of the closest hit: dense masked sweep over the (N, S)
    candidate matrix -> (best int32[N], hit bool[N]). The index is integer,
    inherently non-differentiable: hit *topology* is fixed under
    differentiation, SURVEY.md §7.3. XLA fuses the broadcast producers into
    the reduction over S, so nothing (N, S)-sized reaches device memory."""
    # (N,1) against (S,) broadcasts to (N,S).
    rox, roy, roz = ox[:, None], oy[:, None], oz[:, None]
    rdx, rdy, rdz = dx[:, None], dy[:, None], dz[:, None]

    cox = spheres.center_x - rox
    coy = spheres.center_y - roy
    coz = spheres.center_z - roz
    nb = cox * rdx + coy * rdy + coz * rdz
    c = cox * cox + coy * coy + coz * coz - spheres.radius_sq
    discr = nb * nb - c

    can_hit = (discr > 0.0) & (spheres.valid > 0.0)
    sq = jnp.sqrt(jnp.where(can_hit, discr, 0.0))
    t1 = nb - sq
    t2 = nb + sq
    # Reference pass 2 tries the near root first, then the far one
    # (rayweek1.cpp:297-313); since t1 < t2 always, that's equivalent to:
    t_cand = jnp.where(t1 > t_min, t1, t2)
    ok = can_hit & (t_cand > t_min) & (t_cand < t_max)
    t_masked = jnp.where(ok, t_cand, _BIG)

    best = jnp.argmin(t_masked, axis=1)           # first minimum wins
    hit = jnp.min(t_masked, axis=1) < _BIG
    return best, hit


def closest_hit(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                t_min: float, t_max: float,
                soft_eps: float = 0.0) -> HitRecord:
    """Closest intersection of N rays against all S spheres: the index sweep
    (closest_index), then the O(N) recompute of t/p/normal from the chosen
    sphere's parameters (hit_record_from_index), so gradients flow through a
    short, well-conditioned chain instead of through the full matrix."""
    best, hit = closest_index(ox, oy, oz, dx, dy, dz, spheres, t_min, t_max)
    return hit_record_from_index(ox, oy, oz, dx, dy, dz, spheres, best, hit,
                                 t_min, soft_eps=soft_eps)


# Near-miss band half-width in units of soft_eps: lanes with edge
# coordinate in (-_NEAR_CUT * soft_eps, 0] get a coverage term. At the
# cut, cover = sigmoid(-_NEAR_CUT) ~ 1e-4 — the truncation discontinuity is
# four orders below the signal.
_NEAR_CUT = 9.2


def _near_miss_index(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                     hit, best, t_min: float, soft_eps: float):
    """Best near-miss sphere per ray: the index whose silhouette coordinate
    edge = |r| - b is largest (least negative) among spheres the ray MISSES
    (edge <= 0) whose closest approach lies in front of the ray and NEARER
    than the ray's current hit. Pure hit *topology* (like the argmin index),
    so it is computed under stop_gradient; the differentiable coverage chain
    is rebuilt from the index in hit_record_from_index.

    Returns (j_near int32[N], near bool[N]): near marks lanes grazing a
    sphere inside the (-_NEAR_CUT * soft_eps, 0] silhouette band in front of
    whatever they currently hit (or grazing anything, for miss lanes) — the
    lanes the one-sided relaxation dropped. They contributed to FD but
    carried no cover term, which measured analytic/FD at only 0.37-0.69
    (round-2 verdict item 4); with the promotion + the integrator's detached
    two-branch estimator, every silhouette gets its full two-sided gradient
    against the TRUE background (the pass-through branch keeps tracing)."""
    sg = jax.lax.stop_gradient
    rox, roy, roz = sg(ox)[:, None], sg(oy)[:, None], sg(oz)[:, None]
    rdx, rdy, rdz = sg(dx)[:, None], sg(dy)[:, None], sg(dz)[:, None]
    cx, cy, cz = (sg(spheres.center_x), sg(spheres.center_y),
                  sg(spheres.center_z))
    rsq = sg(spheres.radius_sq)

    cox = cx - rox
    coy = cy - roy
    coz = cz - roz
    nb = cox * rdx + coy * rdy + coz * rdz
    co2 = cox * cox + coy * coy + coz * coz
    # Same edge coordinate as hit_record_from_index's cover: |r| - b in
    # world units, linear in the impact parameter (see the comment there).
    edge = jnp.sqrt(jnp.maximum(rsq, 0.0)) - \
        jnp.sqrt(jnp.maximum(co2 - nb * nb, 1e-20))

    # t of the CURRENT hit (+inf on miss lanes), recomputed from the winning
    # index — cheap O(N) lookups, stop_gradient (topology only).
    j0 = sg(best)
    c0x, c0y, c0z, rsq0 = _lookup_cols(jnp.stack([cx, cy, cz, rsq]), j0)
    g0x = c0x - sg(ox)
    g0y = c0y - sg(oy)
    g0z = c0z - sg(oz)
    nb0 = g0x * sg(dx) + g0y * sg(dy) + g0z * sg(dz)
    c0 = g0x * g0x + g0y * g0y + g0z * g0z - rsq0
    sq0 = safe_sqrt(nb0 * nb0 - c0)
    t10 = nb0 - sq0
    t_hit = jnp.where(hit, jnp.where(t10 > t_min, t10, nb0 + sq0), _BIG)

    graze = ((spheres.valid > 0.0) & (nb > t_min) & (edge <= 0.0)
             & (nb < t_hit[:, None]))
    score = jnp.where(graze, edge, -_BIG)
    j_near = jnp.argmax(score, axis=1)
    near = jnp.max(score, axis=1) > jnp.float32(-_NEAR_CUT * soft_eps)
    return j_near, near


def hit_record_from_index(ox, oy, oz, dx, dy, dz, spheres: PreparedSpheres,
                          best, hit, t_min: float,
                          soft_eps: float = 0.0) -> HitRecord:
    """Stage 2: differentiable hit record given the winning sphere index.

    O(N) recompute of t/p/normal from the chosen sphere's parameters, so
    gradients flow through a short, well-conditioned chain instead of through
    the full (N, S) matrix. `best`/`hit` come from an index sweep
    (closest_index above, or the kernel in kernels/intersect_pallas.py).

    With soft_eps > 0 the relaxation is TWO-SIDED: lanes grazing a sphere
    (edge coordinate |r| - b in (-9.2 * soft_eps, 0] world units, closest approach in
    front of the current hit) are promoted to soft hits of that sphere at its
    closest-approach point t = nb (where the two roots meet as disc -> 0),
    with cover = sigmoid(edge / soft_eps) < 1/2 — continuous across the
    silhouette with the interior branch. The integrator's detached two-branch
    estimator (render/integrator._bounce_step) then either bounces off the
    winning sphere or passes through it from (px2, py2, pz2), which makes the
    analytic silhouette gradient an unbiased estimate of the relaxation's
    true derivative — against the real background, not a sky proxy — instead
    of the one-sided estimator's ~half magnitude."""
    j = jax.lax.stop_gradient(best)
    if soft_eps:
        j_near, near = _near_miss_index(ox, oy, oz, dx, dy, dz, spheres,
                                        hit, best, t_min, soft_eps)
        j = jnp.where(near, j_near, j)
        hit = hit | near
    # mat_type rides the f32 stack (codes 0..2, exact) — one lookup for all
    # columns instead of a separate integer gather.
    (cx, cy, cz, rsq, inv_r, alb_x, alb_y, alb_z, fuzz, ref_idx,
     mt_f) = take_cols(
        jnp.stack([spheres.center_x, spheres.center_y, spheres.center_z,
                   spheres.radius_sq, spheres.inv_radius, spheres.albedo_x,
                   spheres.albedo_y, spheres.albedo_z, spheres.fuzz,
                   spheres.ref_idx,
                   spheres.mat_type.astype(jnp.float32)]), j)
    mat_type = jax.lax.stop_gradient(mt_f).astype(jnp.int32)

    gx, gy, gz = cx - ox, cy - oy, cz - oz
    nb_j = gx * dx + gy * dy + gz * dz
    c_j = gx * gx + gy * gy + gz * gz - rsq
    sq_j = safe_sqrt(nb_j * nb_j - c_j)
    t1_j = nb_j - sq_j
    t = jnp.where(t1_j > t_min, t1_j, nb_j + sq_j)

    cover = None
    px2 = py2 = pz2 = None
    if soft_eps:
        # Silhouette coordinate in WORLD units: edge = |r| - b, where b is
        # the ray-line-to-center distance (b^2 = |co|^2 - nb^2 =
        # c + rsq - nb^2). Positive inside, 0 at the silhouette, LINEAR in
        # the impact parameter with unit slope — the sigmoid band then has a
        # constant Jacobian, so the relaxation's gradient matches the hard
        # render's silhouette derivative up to O(soft_eps) curvature terms.
        # Two rejected alternatives, both measured: disc/|r^2| is quadratic
        # in b (Jacobian varies ~3x across the band -> relaxed gradient
        # ~0.5x the true one), and the scale-free 1 - b/|r| gives an r=100
        # ground sphere a band HUNDREDS of world units wide — most visible
        # ground pixels branched stochastically, drowning every fit in
        # silhouette noise. World units make soft_eps scene-scaled (RTiOW
        # scene unit ~ the small spheres' r=0.5): the band is the same
        # physical sliver on every sphere. Interior hits saturate the
        # sigmoid to 1 (exact render); the gradient d cover / d (center,
        # radius) at the edge is the silhouette-motion term.
        b = jnp.sqrt(jnp.maximum(c_j + rsq - nb_j * nb_j, 1e-20))
        edge = jnp.sqrt(jnp.maximum(rsq, 0.0)) - b
        cover = jax.nn.sigmoid(edge * jnp.float32(1.0 / soft_eps))
        # Far-exit point: where the pass-through branch resumes. t2 = nb + sq
        # is the chord's far root for interior lanes and the closest-approach
        # point (= t) for grazing lanes; from it, moving forward, this sphere
        # is behind the ray, so the next intersection finds what is really
        # occluded — no leak-to-sky proxy.
        t2 = nb_j + sq_j
        px2 = ox + t2 * dx
        py2 = oy + t2 * dy
        pz2 = oz + t2 * dz

    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    # normal = (p - center) * inv_radius (rayweek1.cpp:321); signed inv_radius
    # flips the normal for hollow-glass (negative-radius) spheres.
    nx = (px - cx) * inv_r
    ny = (py - cy) * inv_r
    nz = (pz - cz) * inv_r
    if soft_eps:
        # Near-miss lanes sit at the closest-approach point, |p - c| =
        # r * (b/|r|) slightly OUTSIDE the sphere, so (p - c) / r is
        # up to ~sqrt(1 + 9.2 * soft_eps) long; renormalize so the scatter
        # math sees unit normals on both sides of the silhouette. Exact hits
        # already have |n| = 1 — for them this is an (unfused-cost-only)
        # identity, which keeps the soft path's interior shading equal to the
        # hard renderer's.
        inv_len = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz,
                                            1e-20))
        nx, ny, nz = nx * inv_len, ny * inv_len, nz * inv_len

    return HitRecord(
        hit=hit, t=t, px=px, py=py, pz=pz, nx=nx, ny=ny, nz=nz,
        mat_type=mat_type,
        albedo_x=alb_x, albedo_y=alb_y, albedo_z=alb_z,
        fuzz=fuzz, ref_idx=ref_idx, cover=cover, px2=px2, py2=py2, pz2=pz2,
    )
