"""Multi-process distributed init, exercised end to end (SURVEY.md §5
"distributed communication backend"; round-3 verdict item 3).

The reference is strictly single-process (SURVEY.md §2.3 — an atomic tile
counter is its whole communication stack), so this is extension surface:
two REAL OS processes run `parallel.multihost.init()` against a localhost
coordinator (jax.distributed / gRPC), form one global 2-device CPU mesh,
render a sharded image through the production shard_map path, and verify it
equals the single-process render BITWISE (stateless RNG: sharding cannot
change any ray's math — parallel/shard.py). They then evaluate one
gradient across the same mesh (the XLA renderer under shard_map, the
sphere-cotangent psum over gRPC — the training step's communication
pattern) and check it against a purely local evaluation.

The workers run with an empty XLA_FLAGS (one CPU device per process), so
the mesh really spans processes: every collective in the render (the psum'd
ray counter, the all-gather of sharded radiance implicit in the out_specs)
crosses the process boundary.
"""

import os
import socket
import subprocess
import sys

_WORKER = r'''
import sys

import jax

from rays1bench.parallel import multihost

coord, pid = sys.argv[1], int(sys.argv[2])
multihost.init(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2, jax.devices()

import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils

from rays1bench.core.config import RenderConfig
from rays1bench.parallel.mesh import make_mesh
from rays1bench.parallel.shard import render_image_sharded
from rays1bench.render.pipeline import render_image
from rays1bench.scene.builders import create_small_scene

cfg = RenderConfig(width=64, height=32, spp=2, max_bounces=4, ray_chunk=1024)
scene = create_small_scene(cfg.aspect)
camera = scene.camera.build()

mesh = make_mesh(2)
image, num_rays = render_image_sharded(scene.spheres, camera, cfg, mesh)
# The global image is sharded across the two processes; gather it so each
# process holds the full array, then compare against a purely local render.
full = multihost_utils.process_allgather(image, tiled=True)
full = np.asarray(full).reshape(image.shape)

ref, ref_rays = render_image(scene.spheres, camera, cfg)
assert int(num_rays) == int(ref_rays), (int(num_rays), int(ref_rays))
np.testing.assert_array_equal(full, np.asarray(ref))

# One gradient evaluation ACROSS the process boundary — the XLA renderer
# under shard_map over the 2-process mesh, with the sphere-cotangent psum
# riding gRPC. The loss must agree with a purely local single-device
# evaluation to summation order, and the gradients (replicated by the psum)
# must agree across processes — pinned by the cross-process line comparison
# below.
from rays1bench.grad.inverse import image_loss, params_of
scene8 = create_small_scene(cfg.aspect, pad_multiple=8)
gcfg = cfg.replace(max_bounces=2, early_exit=False)
params = params_of(scene8.spheres, ("albedo_x",))
target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
loss_sh, grads = jax.value_and_grad(image_loss)(
    params, scene8.spheres, camera, target, gcfg, mesh)
loss_1p = image_loss(params, scene8.spheres, camera, target, gcfg)
rel = abs(float(loss_sh) - float(loss_1p)) / max(abs(float(loss_1p)), 1e-12)
assert rel < 1e-6, (float(loss_sh), float(loss_1p))
gsum = float(np.asarray(grads["albedo_x"]).sum())
assert np.isfinite(gsum) and gsum != 0.0

print(f"MULTIPROC_OK pid={pid} rays={int(num_rays)} "
      f"checksum={float(full.sum()):.6f} grad={gsum:.6e}", flush=True)
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_render():
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = ""  # one CPU device per process
    env["JAX_PLATFORMS"] = "cpu"  # a test of the CPU mesh, never a card
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(pid)],
                         env=env, cwd=repo, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIPROC_OK" in out, f"worker {pid} output:\n{out}"
    # Both processes saw the same global render.
    line0 = [l for l in outs[0].splitlines() if "MULTIPROC_OK" in l][0]
    line1 = [l for l in outs[1].splitlines() if "MULTIPROC_OK" in l][0]
    assert line0.split("pid=")[1].split()[1:] == \
        line1.split("pid=")[1].split()[1:], (line0, line1)
