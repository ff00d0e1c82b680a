"""Routing (core/route.py), the compile cache (core/cache.py) and the
gradient's numerical precision."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rays1bench.core import cache, route
from rays1bench.core.config import RenderConfig
from rays1bench.scene.builders import create_small_scene

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_kernel_route_refuses_cpu_without_interpret():
    """No hidden fallback: on a CPU the kernel paths refuse to run unless
    the caller asks for the interpreter."""
    from rays1bench.kernels.pipeline import render_image_pallas
    from rays1bench.parallel.mesh import make_mesh
    from rays1bench.parallel.shard import render_image_pallas_sharded
    from rays1bench.render.pipeline import render_image

    cfg = RenderConfig(width=16, height=8, spp=1, max_bounces=1)
    scene = create_small_scene(cfg.aspect)
    cam = scene.camera.build()
    assert route.kernel_route(interpret=True) == route.INTERPRET
    with pytest.raises(RuntimeError, match="interpret=True"):
        render_image_pallas(scene.spheres, cam, cfg)
    with pytest.raises(RuntimeError, match="interpret=True"):
        render_image_pallas_sharded(scene.spheres, cam, cfg, make_mesh(2))
    with pytest.raises(RuntimeError, match="interpret=True"):
        render_image(scene.spheres, cam, cfg.replace(pallas_intersect=True))


def test_require_gpu_exits_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        route.require_gpu("prog")
    assert exc.value.code == 2
    assert "needs a GPU" in capsys.readouterr().err
    assert route.device_info() == {"platform": "cpu",
                                   "kind": jax.devices()[0].device_kind,
                                   "count": len(jax.devices())}


@pytest.mark.parametrize("argv", [["bench.py", "--quick"],
                                  ["-m", "rays1bench.bench", "--quick"],
                                  ["chip_smoke.py"]])
def test_entry_points_refuse_cpu(argv):
    """The measurement entry points exit non-zero and print no result when
    JAX finds no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 2, r.stderr
    assert r.stdout.strip() == "", r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository fails."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_no_package_code_asks_the_backend():
    """Only core/route.py looks at the platform; no package code derives a
    route (interpret=...) from jax.default_backend()."""
    offenders = [str(p) for p in (REPO / "rays1bench").rglob("*.py")
                 if "default_backend" in p.read_text()]
    assert offenders == []


def test_compile_cache_env_honoured(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache: enable() returns
    it and sets nothing in code."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable()
    assert path == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (REPO / ".gitignore").read_text()


def test_take_cols_vjp_matches_float64():
    """The sphere-cotangent contraction (render/intersect.take_cols) at
    HIGHEST precision matches a float64 numpy reference: TF32 would keep
    only ~3 digits of these sums."""
    from rays1bench.render.intersect import take_cols

    rng = np.random.default_rng(0)
    cols = rng.normal(size=(11, 37)).astype(np.float32)
    j = rng.integers(0, 37, size=4096).astype(np.int32)
    ct = rng.normal(size=(11, 4096)).astype(np.float32)
    _, vjp = jax.vjp(lambda c: take_cols(c, jnp.asarray(j)),
                     jnp.asarray(cols))
    (got,) = vjp(jnp.asarray(ct))
    want = np.zeros((11, 37))
    np.add.at(want.T, j, ct.astype(np.float64).T)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-4)
    fwd = np.asarray(take_cols(jnp.asarray(cols), jnp.asarray(j)))
    assert (fwd == cols[:, j]).all()
