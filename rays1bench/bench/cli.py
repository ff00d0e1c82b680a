"""Benchmark CLI.

Mirrors the reference harness surface (reference: bench.py:10-38 —
--quick/--save/--num plus scene selection; binary flags -w/-n,
rayweek1.cpp:943-958), adapted to a single Python entry point:

    python -m rays1bench.bench [--scenes small,medium,large]
        [--quick] [--save] [--num N] [--spp S] [--max-bounces B]
        [--sharded N] [--out-dir DIR] [--report]

Needs a GPU (exits 2 on anything else); every result names the device.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rays1bench.bench")
    ap.add_argument("--scenes", default="small,medium,large")
    ap.add_argument("--quick", action="store_true",
                    help="80x60 QUICKBENCH profile (common.h:3-15)")
    ap.add_argument("--save", "-w", action="store_true",
                    help="write out_<scene>.tga (rayweek1.cpp:943-947)")
    ap.add_argument("--num", "-n", type=int, default=1,
                    help="runs per scene, averaged (rayweek1.cpp:949-958)")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--max-bounces", type=int, default=None)
    ap.add_argument("--engine", default="pallas", choices=["pallas", "xla"],
                    help="the respawn kernel (default) or the pure-XLA "
                         "pipeline")
    ap.add_argument("--sharded", type=int, default=0, metavar="NDEV",
                    help="render sharded over NDEV devices; with the default "
                         "pallas engine this drives the multi-device path "
                         "(parallel.shard.render_image_pallas_sharded)")
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--label", default=None,
                    help="record version label written to out_<scene>.txt "
                         "(default: the harness VERSION_NAME) — lets one "
                         "records/ table hold rows from several engine "
                         "configurations")
    ap.add_argument("--report", action="store_true",
                    help="print the markdown results table afterwards")
    ap.add_argument("--sustained", type=int, default=0, metavar="FRAMES",
                    help="time FRAMES frames inside one jit dispatch "
                         "(bench.harness.benchmark_sustained)")
    ap.add_argument("--profile", default="", metavar="LOGDIR",
                    help="capture a jax.profiler trace of the benchmark "
                         "runs into LOGDIR (TensorBoard/Perfetto; "
                         "utils/profiling.py)")
    args = ap.parse_args(argv)

    from rays1bench.core import route
    device = route.require_gpu("rays1bench.bench")
    from rays1bench.core.cache import enable as enable_compile_cache
    enable_compile_cache()
    from rays1bench.bench.harness import (benchmark, benchmark_sustained,
                                          log_results)
    from rays1bench.bench import report
    from rays1bench.core.config import get_config
    from rays1bench.scene import builders

    cfg = get_config("quick" if args.quick else "full")
    if args.spp:
        cfg = cfg.replace(spp=args.spp)
    if args.max_bounces is not None:
        cfg = cfg.replace(max_bounces=args.max_bounces)

    def make_render_fn(scene):
        """Resolve the engine x sharding matrix to a (spheres, camera, cfg)
        -> (image, num_rays) callable. None = harness default (the
        single-device kernel with the scene's real-sphere trim)."""
        if args.sharded:
            from rays1bench.parallel.mesh import make_mesh
            mesh = make_mesh(args.sharded)
            if args.engine == "pallas":
                from rays1bench.parallel.shard import \
                    render_image_pallas_sharded
                n_real = getattr(scene, "n_real", None) or None
                return (lambda s, c, cf, _m=mesh, _nr=n_real:
                        render_image_pallas_sharded(s, c, cf, _m, n_real=_nr))
            from rays1bench.parallel.shard import render_image_sharded
            return (lambda s, c, cf, _m=mesh:
                    render_image_sharded(s, c, cf, _m))
        if args.engine == "xla":
            from rays1bench.render.pipeline import render_image
            return render_image
        return None

    scene_names = [s.strip() for s in args.scenes.split(",") if s.strip()]
    unknown = [s for s in scene_names if s not in builders.SCENES]
    if unknown:
        ap.error(f"unknown scene(s) {unknown}; choose from "
                 f"{sorted(builders.SCENES)}")
    if not 1 <= args.num <= 31:  # reference clamps -n to 1..31 (rayweek1.cpp:952)
        ap.error("--num must be in 1..31")

    os.makedirs(args.out_dir, exist_ok=True)
    print(f"device: {device['kind']} x{device['count']} "
          f"({device['platform']})", flush=True)
    import contextlib
    profile_cm = contextlib.nullcontext()
    if args.profile:
        from rays1bench.utils import profiling
        profile_cm = profiling.trace(args.profile)
    with profile_cm:
        for name in scene_names:
            scene = builders.SCENES[name](cfg.aspect)
            render_fn = make_render_fn(scene)
            tga_path = os.path.join(args.out_dir, f"out_{name}.tga") \
                if args.save else None
            if args.sustained:
                res = benchmark_sustained(scene, cfg, frames=args.sustained,
                                          num_runs=args.num,
                                          render_fn=render_fn)
                results = [res]
                if tga_path:  # the sustained path reads back only scalars
                    benchmark(scene, cfg, num_runs=1, write_tga=tga_path,
                              render_fn=render_fn, warmup=False)
            else:
                results = benchmark(scene, cfg, num_runs=args.num,
                                    write_tga=tga_path, render_fn=render_fn)
            kw = {"version": args.label} if args.label else {}
            rec = log_results(name, results, directory=args.out_dir, **kw)
            r = results[-1]
            print(f"{name}\nelapsed time:\t{r.elapsed_seconds:.3f}s\n"
                  f"total rays:\t{r.num_rays}\n"
                  f"mrays/s:\t{r.mrays_per_sec:.2f}\n"
                  f"device:\t{device['kind']} x{device['count']}\n",
                  flush=True)
    if args.profile:
        print(f"profile trace written to {args.profile}", flush=True)

    if args.report:
        for name in scene_names:
            recs = report.collect([args.out_dir], name)
            if recs:
                print(f"### {name}\n{report.markdown_table(recs)}\n")


if __name__ == "__main__":
    main()
