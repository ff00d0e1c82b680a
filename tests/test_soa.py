"""SoA container + codegen tests.

Covers the generated SphereSOA (the analog of the reference's generated
soa_sphere container, soa_sphere.h:22-63) and regeneration idempotence of the
codegen (soa_generator parity, SURVEY.md §2.2 #23/#24).
"""

import os
import subprocess
import sys

import numpy as np

from rays1bench.scene.soa_spheres import SphereSOA, SphereSOABuilder
from rays1bench.scene.spheres import prepare, LAMBERTIAN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _add(b, r=0.5):
    b.add(1.0, 2.0, 3.0, r, LAMBERTIAN, 0.1, 0.2, 0.3, 0.0, 1.0)


def test_builder_pad_and_count():
    b = SphereSOABuilder()
    for _ in range(5):
        _add(b)
    s = b.finalize(pad_multiple=128)
    assert s.count == 128
    # Padding rows are placeholders: radius == 0.
    assert np.asarray(s.radius)[5:].sum() == 0


def test_builder_remove_swaps_last():
    b = SphereSOABuilder()
    for i in range(3):
        b.add(float(i), 0, 0, 0.5, LAMBERTIAN, 0, 0, 0, 0, 1)
    b.remove(0)  # reference semantics: last row swapped in (soa_sphere.cpp:108)
    assert b.count == 2
    assert b.center_x == [2.0, 1.0]


def test_exact_multiple_not_padded_further():
    b = SphereSOABuilder()
    for _ in range(8):
        _add(b)
    assert b.finalize(pad_multiple=8).count == 8


def test_prepare_derived_columns():
    b = SphereSOABuilder()
    _add(b, r=2.0)
    _add(b, r=-0.45)  # hollow glass: signed radius
    p = prepare(b.finalize(pad_multiple=8))
    rsq = np.asarray(p.radius_sq)
    inv = np.asarray(p.inv_radius)
    valid = np.asarray(p.valid)
    assert np.isclose(rsq[0], 4.0) and np.isclose(inv[0], 0.5)
    # Negative radius: radius_sq positive, inv_radius negative (normal flip).
    assert np.isclose(rsq[1], 0.2025) and np.isclose(inv[1], -1.0 / 0.45)
    assert valid[:2].all() and not valid[2:].any()
    # Placeholders contribute inv_radius 0 like the reference (rayweek1.cpp:291).
    assert (inv[2:] == 0).all()


def test_codegen_idempotent():
    """Re-running the spec reproduces the checked-in generated module."""
    gen_path = os.path.join(REPO, "rays1bench", "scene", "soa_spheres.py")
    with open(gen_path) as f:
        before = f.read()
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "soa_spheres_spec.py")],
                   check=True, capture_output=True)
    with open(gen_path) as f:
        after = f.read()
    assert before == after
