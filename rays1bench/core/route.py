"""Where each piece of work runs: the GPU kernel, plain XLA, or the CPU
interpreter.

One module decides, from what the code can observe, and nothing else in the
package asks the backend. The rules:

* a hand-written kernel runs compiled for the GPU, or — only when the caller
  asks for it with interpret=True (tests, dry runs on virtual CPU devices) —
  in the Pallas interpreter. On any other backend a kernel request is an
  error: the plain XLA renderer (render/pipeline.py) is the portable path,
  and nothing falls back to it quietly;
* where the config leaves the gradient path's index sweep open, it is the
  kernel on a GPU and XLA elsewhere (index_kernel_default);
* measurement entry points (bench.py, the bench CLI, chip_smoke.py) refuse
  to run anywhere but on a GPU, and every result they print names the
  device it ran on.
"""

from __future__ import annotations

import sys

import jax

KERNEL = "kernel"
INTERPRET = "interpret"


def device_info() -> dict:
    """{"platform", "kind", "count"} of the default backend, as JAX reports
    them."""
    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def kernel_route(interpret: bool = False) -> str:
    """Route of a hand-written Pallas kernel: INTERPRET when asked for,
    KERNEL on a GPU, and an error anywhere else."""
    if interpret:
        return INTERPRET
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"the Pallas kernels are compiled for the GPU, and this process "
            f"runs on {platform!r}: render with render/pipeline.render_image "
            f"or pass interpret=True to run the kernel in the interpreter")
    return KERNEL


def index_kernel_default() -> bool:
    """Whether the gradient path's closest-hit index sweep runs as the
    Triton kernel when the config leaves it open: yes on a GPU, where the
    kernel measured faster than XLA's fused reduction inside a
    full-resolution gradient step (PERF.md, "Kernel decisions"); XLA
    anywhere else."""
    return jax.devices()[0].platform == "gpu"


def require_gpu(program: str) -> dict:
    """Exit with status 2 unless JAX's default device is a GPU; returns
    device_info() otherwise."""
    info = device_info()
    if info["platform"] != "gpu":
        print(f"{program}: needs a GPU, found {info['platform']!r} "
              f"({info['kind']}); refusing to measure anything else",
              file=sys.stderr)
        raise SystemExit(2)
    return info
