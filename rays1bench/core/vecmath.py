"""Vector math in planar (structure-of-arrays) form.

The reference's Vec3 packs xyz into one SSE register (reference:
src/latest/mymath.h:82-216). On an accelerator a trailing length-3 axis
would waste most of each vector, so the device-side convention here is *planar*: a "vector field"
is three same-shaped float32 arrays (x, y, z), with every op elementwise on
full-width arrays. This is the analog of the reference's own
step7 AoS→SoA split of sphere centers into center_x/y/z columns
(src/step7/soa_generator_config.py).

Host-side camera setup uses tiny tuples of Python floats (see render/camera.py);
these helpers work for both since everything is jnp-broadcastable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dot3(ax, ay, az, bx, by, bz):
    """Elementwise dot product of two planar vector fields (mymath.h:212)."""
    return ax * bx + ay * by + az * bz


def sq_length3(x, y, z):
    return x * x + y * y + z * z


def length3(x, y, z):
    return jnp.sqrt(sq_length3(x, y, z))


def normalize3(x, y, z, eps=1e-12):
    """Unit vector (mymath.h:215 unit_vector), safe at zero length.

    The squared length is clamped to a strictly positive eps BEFORE rsqrt so
    both the value and the VJP stay finite at zero vectors (rsqrt'(0) = -inf
    would otherwise produce inf*0 = NaN through the clamp's zero gradient).
    """
    inv = jax.lax.rsqrt(jnp.maximum(sq_length3(x, y, z), eps))
    return x * inv, y * inv, z * inv


def cross3(ax, ay, az, bx, by, bz):
    """Cross product (mymath.h:190-198)."""
    return (ay * bz - az * by,
            az * bx - ax * bz,
            ax * by - ay * bx)


def lerp3(ax, ay, az, bx, by, bz, t):
    """(1-t)*a + t*b (mymath.h:216-220)."""
    s = 1.0 - t
    return s * ax + t * bx, s * ay + t * by, s * az + t * bz


def reflect3(vx, vy, vz, nx, ny, nz):
    """Mirror reflection v - 2*dot(v,n)*n (rayweek1.cpp:414-417)."""
    d2 = 2.0 * dot3(vx, vy, vz, nx, ny, nz)
    return vx - d2 * nx, vy - d2 * ny, vz - d2 * nz


def safe_sqrt(x, eps=1e-12):
    """sqrt clamped at a strictly positive floor: finite value AND finite VJP
    at x <= 0.

    sqrt'(0) = inf, and sqrt(max(x, 0)) backward gives inf * 0 = NaN at every
    clamped lane (e.g. negative discriminants of rays that miss, SURVEY.md
    §7.3). With eps > 0 the inner derivative is finite (~0.5/sqrt(eps)) and
    the clamp's zero gradient cleanly kills it.
    """
    return jnp.sqrt(jnp.maximum(x, eps))


# --- host-side scalar 3-vectors (camera setup; tiny, traced-once) -----------

def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vcross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vnorm(a):
    import math
    inv = 1.0 / math.sqrt(vdot(a, a))
    return vscale(a, inv)
