"""Hand-written kernels against what XLA makes of the plain version, on the
GPU, at the benchmark's shapes (the numbers behind PERF.md's "Kernel
decisions").

  --sweep    respawn kernel launch parameters (block, warps, unroll) at one
             workload, single dispatches, with parity against the XLA render
  --forward  sustained full frames inside one jit (bench.harness.
             benchmark_sustained): respawn kernel vs the XLA renderer
  --grad     one Adam step of grad/inverse.make_train_step at 1280x720 with
             the closest-hit index sweep in XLA vs the Triton kernel, plus
             the step's compiled memory analysis

Usage: python tools/kernel_timing.py --forward [--scene large] [--spp 250]
           [--bounces 50] [--frames 1]
       python tools/kernel_timing.py --grad [--scene small] [--spp 4]
           [--bounces 10]
       python tools/kernel_timing.py --sweep [--blocks 32,64] [--warps 1,2]
"""
import argparse
import itertools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from rays1bench.core import route  # noqa: E402
from rays1bench.core.config import RenderConfig  # noqa: E402
from rays1bench.scene import builders  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()


def sweep(args, cfg, scene):
    from rays1bench.kernels import respawn as rk
    from rays1bench.render.pipeline import render_image
    from rays1bench.scene.spheres import prepare
    cam = scene.camera.build()
    prep = prepare(scene.spheres)
    span = jnp.array([0, 0, cfg.spp, 0], jnp.int32)
    ref, nref = render_image(scene.spheres, cam, cfg)
    ref = np.asarray(ref)
    for block, nw, un in itertools.product(
            [int(v) for v in args.blocks.split(",")],
            [int(v) for v in args.warps.split(",")],
            [int(v) for v in args.unrolls.split(",")]):
        gy, gx, _, _ = rk.tile_grid(cfg, block)
        f = jax.jit(lambda p, c, s: rk.trace_respawn(
            p, c, s, cfg, gy * gx, block, nw, un))
        (rr, rg, rb), n = jax.block_until_ready(f(prep, cam, span))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(f(prep, cam, span))
            ts.append(time.perf_counter() - t0)
        img = np.stack([np.asarray(rk.untile(a, cfg, block))
                        for a in (rr, rg, rb)], -1) / cfg.spp
        print(f"block={block} warps={nw} unroll={un} "
              f"best={min(ts) * 1e3:.2f}ms rays={int(n)} "
              f"mrays/s={int(n) / min(ts) / 1e6:.1f} "
              f"count_rel={(int(n) - int(nref)) / int(nref):.2e} "
              f"mad={np.abs(img - ref).mean():.2e}", flush=True)


def forward(args, cfg, scene):
    from rays1bench.bench.harness import benchmark_sustained
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.render.pipeline import render_image
    engines = {
        "respawn kernel": lambda s, c, cf: render_image_pallas(
            s, c, cf, n_real=scene.n_real),
        "xla render_image": render_image,
    }
    for name in args.engines.split(","):
        t0 = time.perf_counter()
        res = benchmark_sustained(scene, cfg, frames=args.frames,
                                  num_runs=args.runs,
                                  render_fn=engines[name])
        print(f"{name}: {args.frames} frame(s) in {res.elapsed_seconds:.4f}s "
              f"rays={res.num_rays} mrays/s={res.mrays_per_sec:.2f} "
              f"(wall incl. compile {time.perf_counter() - t0:.1f}s)",
              flush=True)


def grad(args, cfg, scene):
    from rays1bench.grad.inverse import (InverseConfig, make_train_step,
                                         params_of, render_for_loss)
    cam = scene.camera.build()
    inv = InverseConfig(steps=1)
    target = render_for_loss(scene.spheres, cam, cfg)
    for kernel in (False, True):
        c = cfg.replace(pallas_intersect=kernel)
        step, opt = make_train_step(scene.spheres, cam, c, inv)
        params = params_of(scene.spheres, inv.optimize)
        state = opt.init(params)
        compiled = step.lower(params, state, target).compile()
        mem = compiled.memory_analysis()
        out = jax.block_until_ready(compiled(params, state, target))
        ts = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            out = jax.block_until_ready(compiled(params, state, target))
            ts.append(time.perf_counter() - t0)
        print(f"index sweep={'triton kernel' if kernel else 'xla'}: "
              f"step best={min(ts) * 1e3:.2f}ms all="
              f"{[round(t * 1e3, 2) for t in ts]} loss={float(out[2]):.6g} "
              f"temp={mem.temp_size_in_bytes / 2**30:.2f}GiB "
              f"args={mem.argument_size_in_bytes / 2**20:.1f}MiB", flush=True)


def main():
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--sweep", action="store_true")
    mode.add_argument("--forward", action="store_true")
    mode.add_argument("--grad", action="store_true")
    ap.add_argument("--scene", default="large")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--bounces", type=int, default=10)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--engines", default="respawn kernel,xla render_image")
    ap.add_argument("--blocks", default="32,64")
    ap.add_argument("--warps", default="1,2")
    ap.add_argument("--unrolls", default="4")
    args = ap.parse_args()
    info = route.require_gpu("kernel_timing.py")
    print(card(), info, flush=True)
    cfg = RenderConfig(width=1280, height=720, spp=args.spp,
                       max_bounces=args.bounces)
    scene = builders.SCENES[args.scene](cfg.aspect)
    print(f"scene={args.scene} {cfg.width}x{cfg.height} spp={cfg.spp} "
          f"bounces={cfg.max_bounces}", flush=True)
    (sweep if args.sweep else forward if args.forward else grad)(
        args, cfg, scene)


if __name__ == "__main__":
    main()
