#!/usr/bin/env python3
"""Headline benchmark entry point (needs a GPU; exits 2 on anything else).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "mrays/s", "vs_baseline": N,
   "device": {"platform": ..., "kind": ..., "count": ...}}

Metric: sustained mrays/s on the large scene at the reference's OWN published
headline workload — 1280x720 @ 250 spp @ max 50 bounces
(src/common/common.h:23-28, the profile behind every published step13
number) — rays counted per radiance evaluation incl. bounces, the reference's
own metric (src/latest/rayweek1.cpp:517, src/common/common.h:41-44).
vs_baseline divides by the reference's best published number at the SAME
workload: step13 multithreaded large = 59.362 mrays/s on an i9 9900K
(README.md:52). The renderer is the respawn kernel
(kernels/respawn.py), which retires each ray the moment it dies.

"Sustained" = N frames rendered back-to-back inside one jit dispatch
(bench.harness.benchmark_sustained), total rays / total seconds. The
single-dispatch time is printed on stderr alongside.

Usage: python bench.py [--runs N] [--frames N] [--scene large] [--spp 250]
"""

import argparse
import json
import sys
import time

BASELINE_MRAYS = 59.362  # reference step13 MT, large scene (README.md:52)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--frames", type=int, default=2,
                    help="frames per dispatch for the sustained metric")
    ap.add_argument("--scene", default="large", choices=["small", "medium", "large"])
    ap.add_argument("--spp", type=int, default=250)
    ap.add_argument("--max-bounces", type=int, default=50)
    ap.add_argument("--quick", action="store_true", help="80x60 smoke config")
    ap.add_argument("--save", action="store_true", help="write out_<scene>.tga")
    args = ap.parse_args()

    import jax
    from rays1bench.core import route
    device = route.require_gpu("bench.py")
    from rays1bench.core.cache import enable as enable_compile_cache
    enable_compile_cache()
    from rays1bench.core.config import RenderConfig
    from rays1bench.bench.harness import benchmark_sustained
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.render.pipeline import to_srgb_u8
    from rays1bench.scene import builders, tga

    if args.quick:
        cfg = RenderConfig(width=80, height=60, spp=args.spp,
                           max_bounces=args.max_bounces)
    else:
        cfg = RenderConfig(width=1280, height=720, spp=args.spp,
                           max_bounces=args.max_bounces)

    scene = builders.SCENES[args.scene](cfg.aspect)
    camera = scene.camera.build()
    render = lambda sph, cam_, cfg_: render_image_pallas(
        sph, cam_, cfg_, n_real=scene.n_real)

    jax.block_until_ready(render(scene.spheres, camera, cfg))  # compile
    times = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        img, num_rays = jax.block_until_ready(
            render(scene.spheres, camera, cfg))
        times.append(time.perf_counter() - t0)
    best1 = min(times)
    rays1 = int(num_rays)

    res = benchmark_sustained(scene, cfg, frames=args.frames,
                              num_runs=args.runs, render_fn=render)
    mrays = res.mrays_per_sec

    if args.save:
        import numpy as np
        tga.write_rgb24(f"out_{args.scene}.tga", np.asarray(to_srgb_u8(img)))

    print(f"# sustained: rays={res.num_rays} frames={args.frames} "
          f"total={res.elapsed_seconds:.4f}s "
          f"per_frame={res.elapsed_seconds / args.frames * 1e3:.1f}ms | "
          f"single-dispatch: rays={rays1} best={best1:.4f}s "
          f"({rays1 / best1 / 1e6:.1f} mrays/s) "
          f"times={[round(t, 4) for t in times]}", file=sys.stderr)
    print(json.dumps({
        "metric": f"mrays_per_sec_{args.scene}_{cfg.width}x{cfg.height}_{cfg.spp}spp",
        "value": round(mrays, 3),
        "unit": "mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "device": device,
    }))


if __name__ == "__main__":
    main()
