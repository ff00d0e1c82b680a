#!/usr/bin/env python3
"""Smoke test of the renderer and its gradient step on one GPU.

Drives the main path through the entry points a user calls, at full width
(1280x720), and checks what comes out against the repository's own plain
references:

  1. forward parity: the respawn kernel (kernels/pipeline.render_image_pallas)
     against the XLA renderer (render/pipeline.render_image) on the large
     and medium scenes at 1280x720, 4 spp, 10 bounces;
  2. the golden check of tests/test_pipeline.py at the quick profile, all
     three scenes, rendered by the kernel on the card;
  3. sustained mrays/s of the kernel at the full profile (large scene,
     250 spp, 50 bounces; bench.harness.benchmark_sustained);
  4. three Adam steps of grad/inverse.fit_scene at 1280x720 @ 4 spp on the
     small scene: the loss is finite and falls at every step;
  5. a finite-difference check of the gradient on the card (grad/fd.py) at
     a reduced size.

With --four-cards it runs only the sharded paths on four cards instead: the
sharded respawn render against the one-card render, and one sharded training
step against the one-card loss and gradient.

Exits 2 when JAX finds no GPU and 1 when any phase fails; prints the card's
name and power limit first and, on success, one JSON line last:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Usage: python chip_smoke.py [--four-cards]
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# Forward parity tolerances, kernel vs XLA reference at 1280x720 @ 4 spp.
# Both renderers run the same per-ray math, but the GPU compilers contract
# multiply-adds differently, so a few chaotic paths (deep glass chains) take
# another branch: ray counts then differ by a few hundred in ~10^7 and the
# affected pixels by up to a whole sample's radiance.
COUNT_REL_TOL = 5e-4      # |kernel - xla| / xla, ray counts
MAD_TOL = 1e-3            # mean |difference| of the linear image
BLOCK_TOL = 0.02          # worst 8x8 block mean of |difference|


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _block_worst(diff: np.ndarray, block: int = 8) -> float:
    h, w = diff.shape[0] // block * block, diff.shape[1] // block * block
    d = diff[:h, :w].mean(axis=-1)
    return float(d.reshape(h // block, block, w // block, block).mean(
        axis=(1, 3)).max())


def phase_forward_parity():
    from rays1bench.core.config import RenderConfig
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.render.pipeline import render_image
    from rays1bench.scene import builders
    cfg = RenderConfig(width=1280, height=720, spp=4, max_bounces=10)
    for name in ("large", "medium"):
        scene = builders.SCENES[name](cfg.aspect)
        cam = scene.camera.build()
        img, n = render_image_pallas(scene.spheres, cam, cfg,
                                     n_real=scene.n_real)
        ref, n_ref = render_image(scene.spheres, cam, cfg)
        diff = np.abs(np.asarray(img) - np.asarray(ref))
        rel = (int(n) - int(n_ref)) / int(n_ref)
        mad, worst = float(diff.mean()), _block_worst(diff)
        print(f"  {name}: rays kernel={int(n)} xla={int(n_ref)} "
              f"rel={rel:.2e} (tol {COUNT_REL_TOL:g}) mad={mad:.2e} "
              f"(tol {MAD_TOL:g}) worst 8x8 block={worst:.2e} "
              f"(tol {BLOCK_TOL:g})", flush=True)
        assert np.isfinite(np.asarray(img)).all(), name
        assert abs(rel) <= COUNT_REL_TOL, (name, rel)
        assert mad <= MAD_TOL and worst <= BLOCK_TOL, (name, mad, worst)


def phase_golden():
    """tests/test_pipeline.py's statistical golden checks, on the card."""
    from rays1bench.core.config import RenderConfig
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.render.pipeline import to_srgb_u8
    from rays1bench.scene import builders, tga
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "golden")
    blocks = lambda a: a.reshape(15, 4, 10, 8, 3).mean(axis=(1, 3))
    for name, spp, ref_file, tol_mean, tol_block in (
            ("medium", 4, "latest_quick_medium.tga", 5.0, 6.0),
            ("large", 4, "latest_quick_large.tga", 5.0, 6.0),
            ("small", 16, "step1_quick_small.tga", None, 8.0)):
        cfg = RenderConfig(width=80, height=60, spp=spp, max_bounces=12)
        scene = builders.SCENES[name](cfg.aspect)
        img, _ = render_image_pallas(scene.spheres, scene.camera.build(), cfg,
                                     n_real=scene.n_real)
        ours = np.asarray(to_srgb_u8(img)).astype(np.float64)
        ref = tga.read_rgb24(os.path.join(golden, ref_file)).astype(
            np.float64)
        dmean = abs(ours.mean() - ref.mean())
        dblock = float(np.abs(blocks(ours) - blocks(ref)).mean())
        print(f"  {name} vs {ref_file}: |mean diff|={dmean:.3f}/255 "
              f"(tol {tol_mean}) block diff={dblock:.3f}/255 "
              f"(tol {tol_block})", flush=True)
        assert tol_mean is None or dmean < tol_mean, (name, dmean)
        assert dblock < tol_block, (name, dblock)


def phase_sustained():
    from rays1bench.bench.harness import benchmark_sustained
    from rays1bench.core.config import RenderConfig
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.scene import builders
    cfg = RenderConfig(width=1280, height=720, spp=250, max_bounces=50)
    scene = builders.SCENES["large"](cfg.aspect)
    res = benchmark_sustained(
        scene, cfg, frames=2, num_runs=2,
        render_fn=lambda s, c, cf: render_image_pallas(s, c, cf,
                                                       n_real=scene.n_real))
    print(f"  large 1280x720 @ 250 spp, 50 bounces: {res.num_rays} rays in "
          f"2 frames, {res.elapsed_seconds:.4f} s, "
          f"{res.mrays_per_sec:.2f} mrays/s", flush=True)
    assert res.num_rays > 0 and res.mrays_per_sec > 0


def phase_fit():
    import dataclasses
    from rays1bench.core.config import RenderConfig
    from rays1bench.grad.inverse import (InverseConfig, fit_scene,
                                         render_for_loss)
    from rays1bench.scene import builders
    cfg = RenderConfig(width=1280, height=720, spp=4, max_bounces=10)
    scene = builders.create_small_scene(cfg.aspect)
    cam = scene.camera.build()
    target = render_for_loss(scene.spheres, cam, cfg)
    s = scene.spheres
    perturbed = dataclasses.replace(
        s, albedo_x=jnp.clip(s.albedo_x * 0.7, 0, 1),
        albedo_y=jnp.clip(s.albedo_y * 1.2, 0, 1))
    inv = InverseConfig(learning_rate=1e-2, steps=3,
                        optimize=("albedo_x", "albedo_y", "albedo_z"))
    t0 = time.perf_counter()
    _, losses = fit_scene(perturbed, cam, target, cfg, inv)
    print(f"  small 1280x720 @ 4 spp, 3 Adam steps: losses "
          f"{[f'{v:.6g}' for v in losses]} "
          f"({time.perf_counter() - t0:.1f} s incl. compile)", flush=True)
    assert len(losses) == 3 and all(math.isfinite(v) for v in losses)
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def phase_fd():
    """grad/fd.py on a fuzz-0 metal sphere filling the frame: no silhouette
    in view, so the fixed-topology gradient is the whole gradient (the
    setup of tests/test_grad.test_fd_gradients_center_radius_albedo)."""
    from rays1bench.core.config import RenderConfig
    from rays1bench.grad.fd import fd_check
    from rays1bench.grad.inverse import (image_loss, params_of,
                                         render_for_loss)
    from rays1bench.render.camera import CameraSpec
    from rays1bench.scene.soa_spheres import SphereSOABuilder
    from rays1bench.scene.spheres import METAL
    cfg = RenderConfig(width=48, height=32, spp=2, max_bounces=2,
                       ray_chunk=8192, early_exit=False, seed=5)

    def metal(c=(0., 0., 0.), r=2.0, albedo=(0.9, 0.8, 0.7)):
        b = SphereSOABuilder()
        b.add(c[0], c[1], c[2], r, METAL, *albedo, 0.0, 1.0)
        return b.finalize(pad_multiple=8)

    cam = CameraSpec(lookfrom=(0, 0, 2.4), lookat=(0, 0, 0), vfov=45,
                     aspect=cfg.aspect, aperture=0.0, focus_dist=3.0).build()
    spheres = metal()
    target = render_for_loss(metal(c=(0.05, -0.03, 0.1), r=1.95,
                                   albedo=(0.8, 0.85, 0.75)), cam, cfg)
    names = ("center_y", "center_z", "radius", "albedo_x", "albedo_y",
             "albedo_z")
    f = lambda p: image_loss(p, spheres, cam, target, cfg)
    for name, idx, analytic, numeric, _, rel in fd_check(
            f, params_of(spheres, names), [(n, 0) for n in names], eps=1e-3):
        print(f"  {name}[{idx}]: analytic={analytic:.4e} "
              f"numeric={numeric:.4e} rel={rel:.2e} (tol 0.02)", flush=True)
        assert abs(numeric) < 5e-6 or rel < 0.02, (name, analytic, numeric)


def phase_four_cards():
    from rays1bench.core.config import RenderConfig
    from rays1bench.grad.inverse import (InverseConfig, image_loss,
                                         make_train_step, params_of)
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.parallel.mesh import make_mesh
    from rays1bench.parallel.shard import render_image_pallas_sharded
    from rays1bench.scene import builders
    assert len(jax.devices()) >= 4, jax.devices()
    mesh = make_mesh(4)
    cfg = RenderConfig(width=1280, height=720, spp=4, max_bounces=10)
    scene = builders.create_large_scene(cfg.aspect)
    cam = scene.camera.build()
    img1, n1 = render_image_pallas(scene.spheres, cam, cfg,
                                   n_real=scene.n_real)
    img4, n4 = render_image_pallas_sharded(scene.spheres, cam, cfg, mesh,
                                           n_real=scene.n_real)
    diff = float(np.abs(np.asarray(img4) - np.asarray(img1)).max())
    print(f"  sharded respawn render, large 1280x720 @ 4 spp / 10 bounces: "
          f"rays 4 cards={int(n4)} 1 card={int(n1)}, max |image diff|="
          f"{diff:.3e}", flush=True)
    assert int(n4) == int(n1) and diff <= 1e-6, (int(n4), int(n1), diff)

    small = builders.create_small_scene(cfg.aspect)
    cam = small.camera.build()
    inv = InverseConfig(steps=1, optimize=("center_y", "radius", "albedo_x"))
    params = params_of(small.spheres, inv.optimize)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    step, opt = make_train_step(small.spheres, cam, cfg, inv, mesh=mesh)
    _, _, loss4 = step(params, opt.init(params), target)
    grads = [jax.value_and_grad(image_loss)(params, small.spheres, cam,
                                            target, cfg, m)
             for m in (None, mesh)]
    (l1, g1), (l4, g4) = grads
    rel = abs(float(loss4) - float(l1)) / abs(float(l1))
    gerr = max(float(np.abs(np.asarray(g4[k]) - np.asarray(g1[k])).max()
                     / (np.abs(np.asarray(g1[k])).max() + 1e-30))
               for k in g1)
    print(f"  sharded training step, small 1280x720 @ 4 spp: loss 4 cards="
          f"{float(loss4):.8g} 1 card={float(l1):.8g} rel={rel:.2e}; "
          f"gradient max rel diff={gerr:.2e}", flush=True)
    assert abs(float(l4) - float(loss4)) <= 1e-6 * abs(float(loss4))
    assert rel < 1e-5 and gerr < 1e-4, (rel, gerr)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four cards")
    args = ap.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke.py: needs a GPU, found {devices[0].platform!r}",
              file=sys.stderr)
        sys.exit(2)
    from rays1bench.core.cache import enable
    enable()
    print(_card(), flush=True)

    phases = ([phase_four_cards] if args.four_cards else
              [phase_forward_parity, phase_golden, phase_sustained, phase_fit,
               phase_fd])
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        print(f"[{phase.__name__}]", flush=True)
        try:
            phase()
        except Exception:
            traceback.print_exc()
            failed.append(phase.__name__)
        print(f"[{phase.__name__}] {'FAILED' if failed[-1:] == [phase.__name__] else 'ok'} "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
