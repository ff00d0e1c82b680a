"""Inverse rendering demo (BASELINE.json config 4).

Perturb the small scene, then recover the perturbation by Adam through the
differentiable renderer, fitting to the unperturbed render.

Two modes:
  (default)       fit ALBEDOS with the exact renderer — the fixed-topology
                  gradient (SURVEY.md §7.3) recovers them cleanly.
  --fit-geometry  fit sphere CENTER (x, y) and RADIUS with the
                  soft-silhouette renderer (cfg.soft_silhouette: detached
                  two-branch silhouette sampler + cross-seed U-statistic
                  loss, render/integrator.py / grad/inverse.image_loss) —
                  the relaxation that makes silhouette motion
                  differentiable against its true occluded background.
                  Measured on this scene (2026-08-20 sweep): a
                  (+0.06, -0.04) center shift and -0.03 radius error
                  recover to 10-28% of the initial error in 150 steps at
                  lr 2e-3, width 0.005 (the superseded one-sided estimator
                  capped at lr 1e-3 / ~35%; lr 5e-3 drifts on center_x;
                  depth (center_z) stays ill-conditioned from a single
                  view — scale/depth ambiguity).

    python examples/inverse_rendering.py [--steps 120] [--cpu] [--fit-geometry]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=0.0,
                    help="Adam lr (default: 1e-2 albedo, 2e-3 geometry)")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--fit-geometry", action="store_true",
                    help="recover a moved/resized sphere via the "
                         "soft-silhouette renderer")
    ap.add_argument("--fit-camera", action="store_true",
                    help="recover a perturbed camera pose (lookfrom) "
                         "through the renderer's camera VJP "
                         "(grad/inverse.fit_camera; vfov is fit separately "
                         "in tests — jointly with pose it shares the "
                         "dolly-zoom null direction)")
    ap.add_argument("--scene", default="small",
                    choices=["small", "medium"],
                    help="medium = the 46-sphere scene: fit ALL spheres' "
                         "albedos (138 parameters) at once")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import dataclasses
    import numpy as np
    from rays1bench.core.config import RenderConfig
    from rays1bench.grad.inverse import (InverseConfig, fit_scene,
                                         render_for_loss)
    from rays1bench.scene.builders import create_small_scene

    # BASELINE config 4: small scene, 200x100, 4 spp, max-depth 10.
    cfg = RenderConfig(width=200, height=100, spp=4, max_bounces=10,
                       early_exit=False, ray_chunk=131072)
    # pad_multiple=8: the differentiable XLA path sweeps every SoA row
    # densely, so don't carry 120 placeholder rows through the VJP.
    if args.scene == "medium":
        from rays1bench.scene.builders import create_medium_scene
        scene = create_medium_scene(cfg.aspect, pad_multiple=8)
    else:
        scene = create_small_scene(cfg.aspect, pad_multiple=8)
    camera = scene.camera.build()

    if args.scene == "medium":
        # Multi-sphere fit: every real sphere's albedo, simultaneously.
        assert not (args.fit_geometry or args.fit_camera), \
            "--scene medium fits albedos only"
        n = scene.n_real
        target = render_for_loss(scene.spheres, camera, cfg)
        rng = np.random.RandomState(11)
        fac = 0.6 + 0.9 * rng.rand(3, scene.spheres.albedo_x.shape[0])
        fac[:, n:] = 1.0
        import jax.numpy as jnp
        perturbed = dataclasses.replace(
            scene.spheres,
            albedo_x=jnp.clip(scene.spheres.albedo_x * fac[0], 0, 1),
            albedo_y=jnp.clip(scene.spheres.albedo_y * fac[1], 0, 1),
            albedo_z=jnp.clip(scene.spheres.albedo_z * fac[2], 0, 1))
        names = ("albedo_x", "albedo_y", "albedo_z")
        inv = InverseConfig(learning_rate=args.lr or 1e-2, steps=args.steps,
                            optimize=names)
        fitted, losses = fit_scene(perturbed, camera, target, cfg, inv,
                                   verbose=True,
                                   checkpoint_path=args.checkpoint or None)
        print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
        for nm in names:
            e0 = np.abs(np.asarray(getattr(perturbed, nm))[:n]
                        - np.asarray(getattr(scene.spheres, nm))[:n]).mean()
            e1 = np.abs(np.asarray(getattr(fitted, nm))[:n]
                        - np.asarray(getattr(scene.spheres, nm))[:n]).mean()
            print(f"{nm:9s} mean abs error over {n} spheres: "
                  f"{e0:.4f} -> {e1:.4f}")
        return

    if args.fit_camera:
        from rays1bench.grad.inverse import fit_camera
        target = render_for_loss(scene.spheres, camera, cfg)
        spec = scene.camera
        pert = dataclasses.replace(
            spec, lookfrom=(spec.lookfrom[0] + 0.06,
                            spec.lookfrom[1] - 0.05,
                            spec.lookfrom[2] + 0.04))
        fitted, losses = fit_camera(
            scene.spheres, pert, target, cfg,
            learning_rate=args.lr or 5e-3, steps=max(args.steps, 120),
            optimize=("lookfrom",), verbose=True)
        print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
        e0 = np.abs(np.asarray(pert.lookfrom) - np.asarray(spec.lookfrom))
        e1 = np.abs(np.asarray(fitted["lookfrom"])
                    - np.asarray(spec.lookfrom))
        print(f"lookfrom abs error before: {np.round(e0, 4)}  "
              f"after: {np.round(e1, 4)}")
        return

    if args.fit_geometry:
        # Soft-silhouette geometry fit: move + resize the diffuse sphere,
        # recover it. The relaxation width (world units, ~1% of the small
        # spheres' radius) and the lr=2e-3 rate are calibrated in
        # tests/test_grad.py::test_soft_silhouette_recovers_geometry.
        cfg = cfg.replace(soft_silhouette=0.005)
        target = render_for_loss(scene.spheres, camera, cfg)
        perturbed = dataclasses.replace(
            scene.spheres,
            center_x=scene.spheres.center_x.at[0].add(0.06),
            center_y=scene.spheres.center_y.at[0].add(-0.04),
            radius=scene.spheres.radius.at[0].add(-0.03))
        names = ("center_x", "center_y", "radius")
        # rows=(0,): fit the sphere we know is uncertain. Without the mask
        # the glass sphere's weakly-observed x walks ~0.1 along a flat loss
        # direction (loss unchanged) under Adam's normalization.
        inv = InverseConfig(learning_rate=args.lr or 2e-3,
                            steps=max(args.steps, 150), optimize=names,
                            rows=(0,))
    else:
        # Albedos — cleanly recoverable with the exact renderer's
        # fixed-topology gradient.
        target = render_for_loss(scene.spheres, camera, cfg)
        ax = np.asarray(scene.spheres.albedo_x).copy()
        ay = np.asarray(scene.spheres.albedo_y).copy()
        ax[0] *= 1.8; ay[0] *= 0.4
        ax[1] *= 0.5; ay[1] *= 1.2
        perturbed = dataclasses.replace(
            scene.spheres,
            albedo_x=scene.spheres.albedo_x * 0 + ax,
            albedo_y=scene.spheres.albedo_y * 0 + ay,
        )
        names = ("albedo_x", "albedo_y")
        inv = InverseConfig(learning_rate=args.lr or 1e-2, steps=args.steps,
                            optimize=names)

    fitted, losses = fit_scene(perturbed, camera, target, cfg, inv,
                               verbose=True,
                               checkpoint_path=args.checkpoint or None)
    print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e} "
          f"({losses[0] / max(losses[-1], 1e-12):.0f}x reduction)")
    for n in names:
        e0 = np.abs(np.asarray(getattr(perturbed, n))
                    - np.asarray(getattr(scene.spheres, n)))[:3]
        e1 = np.abs(np.asarray(getattr(fitted, n))
                    - np.asarray(getattr(scene.spheres, n)))[:3]
        print(f"{n:9s} abs error before: {np.round(e0, 4)}  "
              f"after: {np.round(e1, 4)}")


if __name__ == "__main__":
    main()
