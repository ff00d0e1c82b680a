"""The three benchmark scenes.

Faithful data-level reconstructions of the reference's scene builders
(reference: src/latest/rayweek1.cpp:552-719): same sphere positions, radii,
materials, camera parameters, and placeholder padding convention. The hollow
glass sphere in the small scene keeps its negative radius (rayweek1.cpp:572) —
this framework renders it correctly (step1 semantics; the optimized reference
silently drops it, see SURVEY.md §7.1 and scene/spheres.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from rays1bench.scene.soa_spheres import SphereSOA, SphereSOABuilder
from rays1bench.scene.spheres import LAMBERTIAN, METAL, DIELECTRIC
from rays1bench.scene.crt_colors import CRT_COLOR_BYTES
from rays1bench.render.camera import CameraSpec


@dataclasses.dataclass(frozen=True)
class Scene:
    """A camera spec + the sphere SoA (reference: Scene, rayweek1.cpp:539-549).

    n_real = sphere count before placeholder padding (static metadata used by
    the kernel pipeline to trim padding rows)."""
    name: str
    camera: CameraSpec
    spheres: SphereSOA
    n_real: int = 0


class _W:
    """add() helper giving the reference's `add(center, radius, material)`
    call shape (soa_sphere.h:22) on top of the generated builder."""

    def __init__(self, pad_multiple: int):
        self.b = SphereSOABuilder()
        self.pad_multiple = pad_multiple

    def lambertian(self, c, r, albedo):
        self.b.add(c[0], c[1], c[2], r, LAMBERTIAN, albedo[0], albedo[1], albedo[2], 0.0, 1.0)

    def metal(self, c, r, albedo, fuzz):
        fuzz = fuzz if fuzz < 1 else 1.0  # Metal clamps fuzz (rayweek1.cpp:422)
        self.b.add(c[0], c[1], c[2], r, METAL, albedo[0], albedo[1], albedo[2], fuzz, 1.0)

    def dielectric(self, c, r, ref_idx):
        self.b.add(c[0], c[1], c[2], r, DIELECTRIC, 1.0, 1.0, 1.0, 0.0, ref_idx)

    @property
    def count(self) -> int:
        return self.b.count

    def finalize(self) -> SphereSOA:
        # Padding rows default to radius 0 == placeholder, the analog of the
        # reference's (999999999,…, radius 0) spheres (rayweek1.cpp:575-576).
        return self.b.finalize(pad_multiple=self.pad_multiple)


def create_small_scene(aspect: float, pad_multiple: int = 128) -> Scene:
    """5 spheres incl. hollow glass (rayweek1.cpp:552-579)."""
    cam = CameraSpec(lookfrom=(2, 1, 2), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov=60.0, aspect=aspect, aperture=0.1, focus_dist=5.0)
    w = _W(pad_multiple)
    w.lambertian((0, 0, -1), 0.5, (0.1, 0.2, 0.5))
    w.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))
    w.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.3)
    w.dielectric((-1, 0, -1), 0.5, 1.5)
    w.dielectric((-1, 0, -1), -0.45, 1.5)   # hollow interior, normal flipped
    return Scene("small", cam, w.finalize(), n_real=w.count)


def create_medium_scene(aspect: float, pad_multiple: int = 128) -> Scene:
    """The 46-sphere aras_p Toy Path Tracer scene (rayweek1.cpp:582-651)."""
    cam = CameraSpec(lookfrom=(0, 2, 3), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov=60.0, aspect=aspect, aperture=0.1 * 0.2, focus_dist=3.0)
    w = _W(pad_multiple)
    w.lambertian((0, -100.5, -1), 100, (0.8, 0.8, 0.8))
    w.lambertian((2, 0, -1), 0.5, (0.8, 0.4, 0.4))
    w.lambertian((0, 0, -1), 0.5, (0.4, 0.8, 0.4))
    w.metal((-2, 0, -1), 0.5, (0.4, 0.4, 0.8), 0)
    w.metal((2, 0, 1), 0.5, (0.4, 0.8, 0.4), 0)
    w.metal((0, 0, 1), 0.5, (0.4, 0.8, 0.4), 0.2)
    w.metal((-2, 0, 1), 0.5, (0.4, 0.8, 0.4), 0.6)
    w.dielectric((0.5, 1, 0.5), 0.5, 1.5)
    w.lambertian((-1.5, 1.5, 0.0), 0.3, (0.8, 0.6, 0.2))
    # row z=-3: lambertian gray ramp
    for i, x in enumerate(range(4, -5, -1)):
        g = 0.1 * (i + 1)
        w.lambertian((x, 0, -3), 0.5, (g, g, g))
    # row z=-4: metal gray ramp
    for i, x in enumerate(range(4, -5, -1)):
        g = 0.1 * (i + 1)
        w.metal((x, 0, -4), 0.5, (g, g, g), 0)
    # row z=-5: metal rainbow
    rainbow = [(0.8, 0.1, 0.1), (0.8, 0.5, 0.1), (0.8, 0.8, 0.1),
               (0.4, 0.8, 0.1), (0.1, 0.8, 0.1), (0.1, 0.8, 0.5),
               (0.1, 0.8, 0.8), (0.1, 0.1, 0.8), (0.5, 0.1, 0.8)]
    for i, x in enumerate(range(4, -5, -1)):
        w.metal((x, 0, -5), 0.5, rainbow[i], 0)
    # row z=-6: lambertian rainbow, except the last is metal (rayweek1.cpp:645)
    for i, x in enumerate(range(4, -5, -1)):
        if i < 8:
            w.lambertian((x, 0, -6), 0.5, rainbow[i])
        else:
            w.metal((x, 0, -6), 0.5, rainbow[i], 0)
    w.lambertian((1.5, 1.5, -2), 0.3, (0.1, 0.2, 0.5))
    return Scene("medium", cam, w.finalize(), n_real=w.count)


def create_large_scene(aspect: float, pad_multiple: int = 128) -> Scene:
    """30x16 grid + ground + 3 big spheres = 484 (rayweek1.cpp:654-719).

    Grid colors come from the captured CRT rand() sequence (crt_colors.py);
    the material pattern is i%20==0 -> Dielectric(1.2 + 0.05*i),
    i%10==0 -> Metal raised +0.1y, else Lambertian."""
    cam = CameraSpec(lookfrom=(3, 8, 15), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov=60.0, aspect=aspect, aperture=0.1, focus_dist=10.0)
    w = _W(pad_multiple)
    W_, H_ = 30, 16
    for y in range(H_):
        for x in range(W_):
            i = x + y * W_
            px, py, pz = (x - W_ // 2) * 1.1, 0.0, (y - H_ // 2) * 1.1
            r = CRT_COLOR_BYTES[i * 3 + 0] / 255.0
            g = CRT_COLOR_BYTES[i * 3 + 1] / 255.0
            b = CRT_COLOR_BYTES[i * 3 + 2] / 255.0
            if i % 20 == 0:
                w.dielectric((px, py, pz), 0.45, 1.2 + i * 0.05)
            elif i % 10 == 0:
                w.metal((px, py + 0.1, pz), 0.45, (r, g, b), 0.01 + 0.5 * y / float(H_))
            else:
                w.lambertian((px, py, pz), 0.45, (r, g, b))
    w.lambertian((0, -1000.5, 0), 1000, (0.5, 0.5, 0.5))
    w.metal((5, 3, 0), 2, (0.5, 0.5, 0.8), 0.65)
    w.dielectric((0, 3, 0), 2, 1.5)
    w.metal((-5, 3, 0), 2, (0.8, 0.2, 0.2), 0.05)
    return Scene("large", cam, w.finalize(), n_real=w.count)


def create_giant_scene(aspect: float, pad_multiple: int = 128) -> Scene:
    """66x62 grid + ground + 3 big spheres = 4096 real rows — an 8.5x
    stress scene with NO reference analog (the reference tops out at 484,
    rayweek1.cpp:654-719). Same material pattern and big-sphere layout as
    the large scene; grid colors come from a fixed-seed PRNG instead of the
    captured CRT byte table (which only covers 480 grid spheres). The
    camera sits inside a field far wider than its frustum."""
    import random
    cam = CameraSpec(lookfrom=(3, 8, 15), lookat=(0, 0, 0), vup=(0, 1, 0),
                     vfov=60.0, aspect=aspect, aperture=0.1, focus_dist=10.0)
    w = _W(pad_multiple)
    rng = random.Random(111)
    W_, H_ = 66, 62
    for y in range(H_):
        for x in range(W_):
            i = x + y * W_
            px, py, pz = (x - W_ // 2) * 1.1, 0.0, (y - H_ // 2) * 1.1
            r = rng.randrange(256) / 255.0
            g = rng.randrange(256) / 255.0
            b = rng.randrange(256) / 255.0
            if i % 20 == 0:
                # Large's 1.2 + 0.05*i walks unbounded; wrap to the physical
                # 1.2..2.4 band so deep-grid glass stays glass-like.
                w.dielectric((px, py, pz), 0.45, 1.2 + (i % 24) * 0.05)
            elif i % 10 == 0:
                w.metal((px, py + 0.1, pz), 0.45, (r, g, b),
                        0.01 + 0.5 * y / float(H_))
            else:
                w.lambertian((px, py, pz), 0.45, (r, g, b))
    w.lambertian((0, -1000.5, 0), 1000, (0.5, 0.5, 0.5))
    w.metal((5, 3, 0), 2, (0.5, 0.5, 0.8), 0.65)
    w.dielectric((0, 3, 0), 2, 1.5)
    w.metal((-5, 3, 0), 2, (0.8, 0.2, 0.2), 0.05)
    return Scene("giant", cam, w.finalize(), n_real=w.count)


SCENES: Dict[str, Callable[..., Scene]] = {
    "small": create_small_scene,
    "medium": create_medium_scene,
    "large": create_large_scene,
    "giant": create_giant_scene,
}
