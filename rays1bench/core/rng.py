"""Stateless counter-based RNG.

The reference threads mutable xorshift32 state through every call
(reference: src/latest/mymath.h:17-73 — XorShift32 / myrand01 / myrand02 and
their 4-lane SSE variants; per-thread streams seeded at rayweek1.cpp:800-802).
Mutable RNG streams are the wrong shape for SPMD code: they serialize, they
make results depend on scheduling, and they can't be vmapped.

Here every draw is a pure function of integer coordinates
(seed, ray_id, bounce, draw_slot) hashed to uniform bits. The same coordinates
give the same number on any backend, any sharding, any chunking — which is what
makes images deterministic under `shard_map` without any cross-device RNG state.

The hash is the PCG-family integer hash ("pcg_hash" from Jarzynski & Olano,
"Hash Functions for GPU Rendering", JCGT 2020) — a few vector-friendly integer ops,
usable identically inside Pallas kernels and plain jnp code. The ray coordinate
is hashed FIRST, then the (bounce, slot) Weyl offsets are folded in with a
second round: a single round over one linear combination has exact lattice
collisions (dray*K1 + dbounce*K2 + dslot*K3 = 0 mod 2^32 has solutions with
dray ~ 6.1M — inside the id range of a 1280x720 render at >= 7 spp), which
would replay entire draw sequences between ray pairs. Hashing the ray id
before the linear (bounce, slot) fold leaves no in-range linear structure,
and the hash chain is short next to the sphere sweep.

Uniform floats keep the reference's 24-bit-mantissa convention:
myrand01 = (bits & 0xFFFFFF) / 2^24  (mymath.h:27-30).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Large odd constants for decorrelating the counter axes (Weyl-style).
_STREAM_RAY = np.uint32(0x9E3779B9)     # golden-ratio increment
_STREAM_BOUNCE = np.uint32(0x85EBCA77)
_STREAM_SLOT = np.uint32(0xC2B2AE3D)

_INV_2_24 = np.float32(1.0 / 16777216.0)
_TWO_PI = np.float32(6.2831853071795864769)


def pcg_hash(x):
    """One round of the PCG-RXS-M-XS output permutation on a uint32 state."""
    x = x.astype(jnp.uint32)
    state = x * np.uint32(747796405) + np.uint32(2891336453)
    word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


def hash_bits(seed, ray_id, bounce, slot):
    """uint32 random bits for lattice coordinates (seed, ray_id, bounce, slot).

    All arguments broadcast; ray_id is typically an (N,) int32 lane array while
    seed/bounce/slot are scalars. The ray coordinate is hashed before the
    (bounce, slot) Weyl fold — see the module docstring for why one linear
    round is not enough.
    """
    seed = jnp.asarray(seed).astype(jnp.uint32)
    h = pcg_hash(seed + jnp.asarray(ray_id).astype(jnp.uint32) * _STREAM_RAY)
    x = (h
         + jnp.asarray(bounce).astype(jnp.uint32) * _STREAM_BOUNCE
         + jnp.asarray(slot).astype(jnp.uint32) * _STREAM_SLOT)
    return pcg_hash(x)


def bits_to_uniform01(bits):
    """bits -> float32 in [0, 1) using the top-independent 24-bit convention
    of the reference's myrand01 (mymath.h:27-30)."""
    # Mask to 24 bits, then cast via int32 (the masked value always fits in
    # int32, and int32->f32 is the cast every backend lowers).
    return (bits & np.uint32(0xFFFFFF)).astype(jnp.int32).astype(jnp.float32) * _INV_2_24


def uniform01(seed, ray_id, bounce, slot):
    """Uniform float32 in [0, 1)."""
    return bits_to_uniform01(hash_bits(seed, ray_id, bounce, slot))


def uniform02(seed, ray_id, bounce, slot):
    """Uniform float32 in [0, 2) — the reference's myrand02 (mymath.h:32-35)."""
    return uniform01(seed, ray_id, bounce, slot) * np.float32(2.0)


_INV_2_16 = np.float32(1.0 / 65536.0)


def uniform_pair16(seed, ray_id, bounce, slot):
    """TWO uniforms in [0,1) at 16-bit resolution from ONE hash.

    The hash chain (2 PCG rounds plus the Weyl folds, ~25 integer ops)
    dominates RNG cost; splitting the 32 output bits halves it. 16-bit resolution is ample
    for jitter/angle draws (the reference itself only keeps 24 bits,
    mymath.h:27-30)."""
    bits = hash_bits(seed, ray_id, bounce, slot)
    u = (bits & np.uint32(0xFFFF)).astype(jnp.int32).astype(jnp.float32) * _INV_2_16
    v = (bits >> np.uint32(16)).astype(jnp.int32).astype(jnp.float32) * _INV_2_16
    return u, v


_INV_2_10 = np.float32(1.0 / 1024.0)

# Quadrant polynomials for sincos2pi: cos(f*pi/2) as an even and
# sin(f*pi/2) as an odd minimax-fit polynomial on f in [0, 1), max error
# 5.3e-8 / 3.7e-9 (< 1 f32 ulp of 1.0) vs the exact functions.
_C2 = tuple(np.float32(v) for v in
            (0.99999998, -1.23369868, 0.25365265, -0.020813363,
             8.5946592e-04))
_S2 = tuple(np.float32(v) for v in
            (1.5707963, -0.64596344, 0.079688738, -4.6725480e-03,
             1.5095606e-04))


def sincos2pi(t):
    """(sin(2 pi t), cos(2 pi t)) for t in [0, 1).

    ONE quadrant reduction shared by both functions plus two short
    even/odd polynomials, instead of jnp.sin + jnp.cos each paying its own
    full-range argument reduction: the angle draws sit on the respawn
    kernel's serial per-step chain, where chain length is what matters.
    Distribution is unchanged (angles uniform up to < 1 ulp);
    draw VALUES shift by the approximation, which moves ray counts at the
    1e-5 level — far inside the 0.3% reference-parity pins and invisible
    to the statistical golden comparisons (engine-equality tests share
    this code and stay exact).
    """
    x = t * np.float32(4.0)
    q = jnp.floor(x)
    f = x - q
    f2 = f * f
    c = _C2[0] + f2 * (_C2[1] + f2 * (_C2[2] + f2 * (_C2[3] + f2 * _C2[4])))
    s = f * (_S2[0] + f2 * (_S2[1] + f2 * (_S2[2]
                                           + f2 * (_S2[3] + f2 * _S2[4]))))
    q1 = q == 1.0
    q2 = q == 2.0
    q3 = q == 3.0
    sin = jnp.where(q1, c, jnp.where(q2, -s, jnp.where(q3, -c, s)))
    cos = jnp.where(q1, -s, jnp.where(q2, -c, jnp.where(q3, s, c)))
    return sin, cos


def in_unit_ball(seed, ray_id, bounce, slot0=0):
    """Uniform point inside the unit ball, returned as three component arrays.

    The reference rejects uniform cube samples (mymath.h:224-235,
    random_in_unit_sphere) — an unbounded data-dependent loop that can't live
    under jit. Same distribution analytically: an isotropic direction from
    (z, phi) area sampling, scaled by a radius with CDF r^3 so volume is
    uniform. The radial draw uses max(w1, w2, w3) of three uniforms — the
    r^3 CDF up to 10-bit quantization (r is discrete over 1024 levels,
    E[r]~0.7495 vs 0.75, and never reaches 1) — instead of cbrt(w): cbrt has no Pallas lowering and its
    exp(log(w)/3) expansion is two transcendentals on the per-bounce critical
    path, vs. two vector max ops here. 10-bit radial resolution (the three
    draws share one hash word); direction resolution stays 16-bit. Uses slots
    slot0 (pair16) and slot0+1 — two hashes total.
    """
    u, v = uniform_pair16(seed, ray_id, bounce, slot0)
    bits = hash_bits(seed, ray_id, bounce, slot0 + 1)
    w1 = (bits & np.uint32(0x3FF)).astype(jnp.int32)
    w2 = ((bits >> np.uint32(10)) & np.uint32(0x3FF)).astype(jnp.int32)
    w3 = ((bits >> np.uint32(20)) & np.uint32(0x3FF)).astype(jnp.int32)
    r = jnp.maximum(jnp.maximum(w1, w2), w3).astype(jnp.float32) * _INV_2_10
    z = 2.0 * u - 1.0
    s = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    sp, cp = sincos2pi(v)
    return r * s * cp, r * s * sp, r * z


def in_unit_disk(seed, ray_id, bounce, slot0=0):
    """Uniform point inside the unit disk (x, y components).

    Replaces the reference's rejection loop random_in_unit_disk
    (rayweek1.cpp:353-362) with the analytic polar map. One hash (pair16) at
    slot0.
    """
    u, v = uniform_pair16(seed, ray_id, bounce, slot0)
    r = jnp.sqrt(u)
    st, ct = sincos2pi(v)
    return r * ct, r * st


def in_unit_ball_rejection(seed, ray_id, bounce, slot0=0, max_tries=8):
    """Uniform point in the unit ball via FIXED-COUNT masked rejection — the
    closest jit-compatible analog of the reference's do/while rejection
    (mymath.h:224-235): each try draws a cube point, the first in-ball try
    wins. P(all misses) = (1 - pi/6)^max_tries ~ 0.5% at 8; the (biased)
    last draw is kept then, scaled into the ball.

    Provided for reference-parity studies; the default analytic sampler
    (in_unit_ball) has the exact distribution at a third of the cost.
    """
    bx = jnp.zeros_like(jnp.asarray(ray_id, dtype=jnp.float32))
    by, bz = bx, bx
    found = bx > 1.0  # all-False
    for k in range(max_tries):
        u, v = uniform_pair16(seed, ray_id, bounce, slot0 + 2 * k)
        w, _ = uniform_pair16(seed, ray_id, bounce, slot0 + 2 * k + 1)
        px = 2.0 * u - 1.0
        py = 2.0 * v - 1.0
        pz = 2.0 * w - 1.0
        inside = px * px + py * py + pz * pz < 1.0
        take = inside & ~found
        bx = jnp.where(take, px, bx)
        by = jnp.where(take, py, by)
        bz = jnp.where(take, pz, bz)
        found = found | inside
    # fallback for never-found lanes: normalize the zero-init safely
    norm = jnp.sqrt(jnp.maximum(bx * bx + by * by + bz * bz, 1e-12))
    scale = jnp.where(found | (norm < 1.0), 1.0, 0.999 / norm)
    return bx * scale, by * scale, bz * scale


def pixel_jitter(seed, ray_id):
    """Film-plane AA jitter (ju, jv) in [0,1)^2 — the uv jitter of
    rayweek1.cpp:757-759, one hash on the bounce == -1 lattice row."""
    return uniform_pair16(seed, ray_id, jnp.int32(-1), Slots.PIXEL_JITTER_U)


# Reserved draw-slot layout per (ray, bounce). Keeping slots disjoint and fixed
# makes every draw reproducible no matter which material branch consumes it.
class Slots:
    PIXEL_JITTER_U = 0     # primary-ray uv jitter (bounce == -1 lattice row)
    PIXEL_JITTER_V = 1
    LENS_U = 2             # thin-lens aperture sample
    LENS_V = 3
    SCATTER_BALL = 8       # 5 slots: lambertian/metal unit-ball sample
    DIELECTRIC_P = 13      # reflect-vs-refract probability draw
    SILHOUETTE_P = 14      # soft-silhouette bounce-vs-pass-through draw
