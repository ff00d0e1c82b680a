"""Thin-lens camera.

Same model as the reference RTiOW camera (reference: src/latest/rayweek1.cpp:
364-394): an orthonormal basis from lookfrom/lookat/vup, a film rectangle at
the focus distance, and a lens-disk origin jitter for depth of field. The basis
is computed host-side once (CameraSpec.build); ray generation is vectorized
over whole ray batches in planar form (see core/vecmath.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp

from rays1bench.core import rng as rng_mod
from rays1bench.core.vecmath import vcross, vnorm, vsub


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """User-facing camera parameters (Camera::init args, rayweek1.cpp:366)."""
    lookfrom: Tuple[float, float, float]
    lookat: Tuple[float, float, float]
    vup: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov: float = 60.0          # vertical field of view, degrees
    aspect: float = 16.0 / 9.0
    aperture: float = 0.0
    focus_dist: float = 1.0

    def build(self) -> "Camera":
        """Derive the ray-gen basis (rayweek1.cpp:366-379)."""
        theta = self.vfov * math.pi / 180.0
        half_h = math.tan(theta / 2.0)
        half_w = self.aspect * half_h
        origin = self.lookfrom
        w = vnorm(vsub(self.lookfrom, self.lookat))
        u = vnorm(vcross(self.vup, w))
        v = vcross(w, u)
        fd = self.focus_dist
        lower_left = tuple(
            origin[i] - half_w * fd * u[i] - half_h * fd * v[i] - fd * w[i]
            for i in range(3))
        horizontal = tuple(2.0 * half_w * fd * u[i] for i in range(3))
        vertical = tuple(2.0 * half_h * fd * v[i] for i in range(3))
        f32 = lambda t: jnp.asarray(t, dtype=jnp.float32)
        return Camera(
            origin=f32(origin), lower_left=f32(lower_left),
            horizontal=f32(horizontal), vertical=f32(vertical),
            u=f32(u), v=f32(v),
            lens_radius=f32(self.aperture / 2.0),
        )


def build_camera(lookfrom, lookat, vup, vfov, aspect, aperture, focus_dist
                 ) -> "Camera":
    """DIFFERENTIABLE Camera constructor: the same derivation as
    CameraSpec.build (rayweek1.cpp:366-379) in jnp, so camera parameters
    (lookfrom, vfov, ...) can be FIT by gradient descent through the
    renderer's existing camera VJP (grad/inverse.fit_camera). lookfrom /
    lookat / vup are length-3 arrays or tuples; vfov is in degrees."""
    f32 = lambda t: jnp.asarray(t, dtype=jnp.float32)
    lookfrom, lookat, vup = f32(lookfrom), f32(lookat), f32(vup)
    theta = f32(vfov) * jnp.float32(jnp.pi / 180.0)
    half_h = jnp.tan(theta * 0.5)
    half_w = jnp.float32(aspect) * half_h
    w = lookfrom - lookat
    w = w / jnp.linalg.norm(w)
    u = jnp.cross(vup, w)
    u = u / jnp.linalg.norm(u)
    v = jnp.cross(w, u)
    fd = jnp.float32(focus_dist)
    lower_left = lookfrom - half_w * fd * u - half_h * fd * v - fd * w
    return Camera(
        origin=lookfrom, lower_left=lower_left,
        horizontal=2.0 * half_w * fd * u, vertical=2.0 * half_h * fd * v,
        u=u, v=v, lens_radius=f32(aperture / 2.0))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Device-side derived camera (each vector a float32[3]; unpacked to
    scalars at trace time, so no length-3 axis reaches the hot loop)."""
    origin: jax.Array
    lower_left: jax.Array
    horizontal: jax.Array
    vertical: jax.Array
    u: jax.Array
    v: jax.Array
    lens_radius: jax.Array

    def generate_rays(self, s, t, seed, ray_id):
        """Primary rays for film coordinates (s, t) in [0,1)^2.

        Mirrors Camera::getRay (rayweek1.cpp:381-386): jitter the origin on
        the lens disk, aim at the film point, normalize the direction (the
        reference normalizes in the Ray constructor, rayweek1.cpp:108).
        Returns planar (ox,oy,oz, dx,dy,dz).
        """
        rdx, rdy = rng_mod.in_unit_disk(seed, ray_id, jnp.int32(-1),
                                        rng_mod.Slots.LENS_U)
        rdx = rdx * self.lens_radius
        rdy = rdy * self.lens_radius
        ox = self.origin[0] + self.u[0] * rdx + self.v[0] * rdy
        oy = self.origin[1] + self.u[1] * rdx + self.v[1] * rdy
        oz = self.origin[2] + self.u[2] * rdx + self.v[2] * rdy
        dx = self.lower_left[0] + s * self.horizontal[0] + t * self.vertical[0] - ox
        dy = self.lower_left[1] + s * self.horizontal[1] + t * self.vertical[1] - oy
        dz = self.lower_left[2] + s * self.horizontal[2] + t * self.vertical[2] - oz
        inv = jax.lax.rsqrt(dx * dx + dy * dy + dz * dz)
        return ox, oy, oz, dx * inv, dy * inv, dz * inv
