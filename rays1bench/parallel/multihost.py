"""Multi-host initialization and fault-tolerant shard re-rendering.

The reference is a single process (SURVEY.md §5: no failure detection; "the
process either completes or crashes"). For multi-host rendering:

* `init()` wraps jax.distributed.initialize — JAX's failure semantics (a dead
  host fails collective init / hangs the mesh) are the detection mechanism;
* `render_with_retry` provides the renderer-level recovery story: because the
  RNG is stateless in ray ids, ANY subset of rays can be re-rendered on any
  device at any time and merged bit-exactly — so a failed shard is simply
  rendered again, locally, without restarting the job. (The analog in the
  reference would be re-running a tile whose thread died — impossible there
  because RNG state dies with the thread.)
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import jax
import numpy as np


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Initialize JAX distributed (no-op for single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def render_with_retry(render_shard: Callable[[np.ndarray], np.ndarray],
                      ray_id_shards: Sequence[np.ndarray],
                      max_retries: int = 2) -> Tuple[np.ndarray, int]:
    """Render shards with per-shard retry; returns (concatenated radiance,
    number of retried shards).

    `render_shard(ids) -> radiance` may raise on device failure; statelessness
    makes the retry produce bit-identical results.
    """
    out = []
    retried = 0
    for ids in ray_id_shards:
        for attempt in range(max_retries + 1):
            try:
                out.append(np.asarray(render_shard(ids)))
                break
            except Exception:
                if attempt == max_retries:
                    raise
                retried += 1
    return np.concatenate(out, axis=0), retried


def render_image_with_retry(spheres_soa, camera, cfg, num_shards: int = 4,
                            max_retries: int = 2, _render_shard=None):
    """Fault-tolerant full-image render: the ray stream is split into
    `num_shards` equal slices, each rendered as its own dispatch through
    render_with_retry and merged. Because the RNG is stateless in the global
    ray id, a retried shard is bit-identical to a never-failed one, so the
    assembled image equals render_image()'s exactly (pinned in
    tests/test_aux.py).

    `_render_shard` is a test hook wrapping the per-shard render (e.g. to
    inject transient failures). Returns (image, num_rays, retried_shards).
    """
    import jax
    import jax.numpy as jnp
    from rays1bench.render.pipeline import _trace_chunk, _round_up
    from rays1bench.scene.spheres import prepare

    n = cfg.num_primary_rays
    per = _round_up(-(-n // num_shards), 1024)
    padded = per * num_shards
    spheres = prepare(spheres_soa)
    seed = jnp.uint32(cfg.seed)

    @jax.jit
    def shard_fn(ids):
        rr, rg, rb, cnt = _trace_chunk(spheres, camera, ids, ids < n, seed,
                                       cfg)
        return jnp.stack([rr, rg, rb]), cnt

    counts = {}  # shard's first ray id -> count (idempotent across retries)

    def render_shard(ids):
        fn = _render_shard(shard_fn) if _render_shard else shard_fn
        rad, cnt = fn(jnp.asarray(ids))
        rad = np.asarray(rad).T  # (per, 3); readback before recording count
        counts[int(ids[0])] = np.uint64(np.uint32(cnt))
        return rad

    all_ids = np.arange(padded, dtype=np.int32).reshape(num_shards, per)
    rad, retried = render_with_retry(render_shard, list(all_ids),
                                     max_retries=max_retries)
    num_rays = int(sum(counts.values()))
    image = rad[:n].reshape(cfg.height, cfg.width, cfg.spp, 3).mean(axis=2)
    return image, num_rays, retried
