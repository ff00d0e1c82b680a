"""Scaling sweep: rays/s vs device count.

BASELINE target: > 60% linear scaling from one device to many. The sweep
runs on whatever mesh is available (the GPUs of a host; virtual CPU devices
for tests). Rendering is embarrassingly parallel with the scene replicated —
the only cross-device traffic is the psum'd ray counter — so efficiency is
limited by per-device underutilization at small shards, not communication
(SURVEY.md §7.3).

Usage (virtual 8-device CPU mesh; the pallas engine needs --interpret there):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python -m rays1bench.bench.scaling --scene medium --spp 4 \
        --interpret [--engine xla]
"""

from __future__ import annotations

import argparse
import time
from typing import List

import jax

from rays1bench.utils.metrics import ScalingPoint, scaling_efficiency


def sweep(scene_name: str, cfg, device_counts: List[int],
          runs: int = 2, engine: str = "pallas",
          interpret: bool = False, telemetry: bool = False):
    """Returns List[ScalingPoint]; with telemetry=True (pallas engine
    only), also a parallel list of per-device dicts from
    parallel.shard.render_image_pallas_sharded(telemetry=True) — the
    per-chip ray/step counters behind each point (the reference's
    per-thread counters, rayweek1.cpp:809-813)."""
    from rays1bench.parallel.mesh import make_mesh
    from rays1bench.parallel.shard import (render_image_pallas_sharded,
                                           render_image_sharded)
    from rays1bench.scene import builders
    scene = builders.SCENES[scene_name](cfg.aspect)
    camera = scene.camera.build()
    assert not (telemetry and engine != "pallas"), \
        "telemetry rides the kernel's step counters"
    n_real = getattr(scene, "n_real", None) or None
    if engine == "pallas":
        # The multi-device path: the respawn kernel under shard_map.
        render = (lambda sph, cam, cf, mesh:
                  render_image_pallas_sharded(sph, cam, cf, mesh,
                                              n_real=n_real,
                                              interpret=interpret))
    else:
        render = render_image_sharded
    points = []
    telems = []
    for nd in device_counts:
        mesh = make_mesh(nd)
        jax.block_until_ready(render(scene.spheres, camera, cfg, mesh))
        best = float("inf")
        for _ in range(runs):
            t0 = time.perf_counter()
            img, num = jax.block_until_ready(
                render(scene.spheres, camera, cfg, mesh))
            best = min(best, time.perf_counter() - t0)
        points.append(ScalingPoint(nd, int(num), best))
        if telemetry:
            import numpy as _np
            _, _, tl = render_image_pallas_sharded(
                scene.spheres, camera, cfg, mesh, n_real=n_real,
                interpret=interpret, telemetry=True)
            telems.append({k: _np.asarray(v).reshape(-1).tolist()
                           for k, v in tl.items()})
    if telemetry:
        return points, telems
    return points


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="medium")
    ap.add_argument("--width", type=int, default=400)
    ap.add_argument("--height", type=int, default=200)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-bounces", type=int, default=10)
    ap.add_argument("--devices", default="")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--engine", default="pallas", choices=["pallas", "xla"],
                    help="pallas = the respawn kernel under shard_map; "
                         "xla = pure-XLA sharded pipeline")
    ap.add_argument("--interpret", action="store_true",
                    help="run the Pallas engine in interpreter mode "
                         "(required on the CPU backend)")
    ap.add_argument("--telemetry", action="store_true",
                    help="also collect per-DEVICE ray/step counters "
                         "(parallel.shard telemetry=True) and print/record "
                         "them per point — the load-imbalance signal")
    ap.add_argument("--record", default="",
                    help="write 'label|devices|seconds|rays|mrays|eff|' "
                         "lines to this file — the source for RESULTS.md's "
                         "__RESULTS_SCALING__ table "
                         "(bench/report_cli.scaling_table)")
    args = ap.parse_args(argv)

    n = len(jax.devices())
    req = [int(x) for x in args.devices.split(",") if x]
    if req and max(req) > n:
        raise SystemExit(f"requested more devices than available ({n})")
    counts = ([int(x) for x in args.devices.split(",") if x]
              or [c for c in (1, 2, 4, 8, 16) if c <= n])
    from rays1bench.core.config import RenderConfig
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_bounces=args.max_bounces, ray_chunk=16384)
    out = sweep(args.scene, cfg, counts, runs=args.runs,
                engine=args.engine, interpret=args.interpret,
                telemetry=args.telemetry)
    points, telems = out if args.telemetry else (out, None)
    effs = scaling_efficiency(points)
    print(f"{'devices':>8} {'mrays/s':>10} {'efficiency':>10}")
    for i, (p, e) in enumerate(zip(points, effs)):
        print(f"{p.n_devices:>8} {p.mrays:>10.2f} {e:>10.2%}")
        if telems:
            t = telems[i]
            print(f"         per-device rays  {t['device_rays']}")
            print(f"         per-device steps {t['device_iters']}")
    if args.record:
        import os
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        backend = jax.devices()[0].platform
        label = (f"{args.scene} {args.width}x{args.height} @ {args.spp} spp, "
                 f"{args.engine}"
                 f"{' (interpret)' if args.interpret else ''}, {backend}")
        with open(args.record, "a") as f:
            for i, (p, e) in enumerate(zip(points, effs)):
                f.write(f"{label}|{p.n_devices}|{p.elapsed_seconds:.4f}s|"
                        f"{p.num_rays}|{p.mrays:.3f}|{e:.3f}|\n")
                if telems:
                    # Comment row (no pipe fields): report_cli's
                    # scaling_table skips it; humans and probes read it.
                    t = telems[i]
                    f.write(f"# per-device rays {t['device_rays']} "
                            f"steps {t['device_iters']}\n")


if __name__ == "__main__":
    main()
