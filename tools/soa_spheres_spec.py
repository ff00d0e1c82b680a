"""Column spec for the sphere SoA container.

The analog of the reference's per-step soa_generator_config.py
(src/latest/soa_generator_config.py declares center_x/y/z, radius_sq,
inv_radius, Material*). Differences, by design:

* `radius` is stored signed as the differentiable leaf; radius_sq/inv_radius
  are derived at trace time (scene/spheres.py) so gradients flow through one
  parameter. The reference precomputes them at add() time
  (soa_sphere.cpp:80-82) — and in doing so zeroes inv_radius for negative
  radii, breaking the small scene's hollow-glass sphere (SURVEY.md §7.1).
  Deriving inv_radius = 1/radius signed restores step1 semantics.
* `Material*` virtual dispatch becomes data columns: an integer mat_type plus
  the union of material parameters (albedo, fuzz, ref_idx), selected
  branchlessly in the integrator.
* Placeholder rows (radius == 0) are the reference's padding spheres at
  (999999999, …) with radius 0 (rayweek1.cpp:575-576).

Run:  python tools/soa_spheres_spec.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from soa_codegen import Column, SoaSpec, write

SPEC = SoaSpec(
    class_name="SphereSOA",
    columns=[
        Column("center_x"),
        Column("center_y"),
        Column("center_z"),
        # Signed; 0 marks a placeholder row. Padding default 0 keeps padded
        # rows masked everywhere.
        Column("radius"),
        # Material code: 0 = Lambertian, 1 = Metal, 2 = Dielectric.
        # Padding default 0 is harmless because radius==0 masks the row.
        Column("mat_type", dtype="int32", default=0),
        Column("albedo_x"),
        Column("albedo_y"),
        Column("albedo_z"),
        Column("fuzz"),
        Column("ref_idx", default=1.0),
    ],
    pad_multiple=128,
    mask_col="radius",
    doc="""
Sphere scene storage: centers, signed radii, and flattened material columns.
The device-side derived view (radius_sq, inv_radius, validity mask) is built
by rays1bench.scene.spheres.prepare().""",
)

if __name__ == "__main__":
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                       "rays1bench", "scene", "soa_spheres.py")
    write(SPEC, "tools/soa_spheres_spec.py", os.path.normpath(out))
