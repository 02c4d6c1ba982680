"""Device-mesh sharding of the search.

The reference's only parallelism is a single-host JVM thread pool over
windows (SearchReference.scala:75-94); this design shards the
genome across devices instead (SURVEY.md §2.10):

  - **dp axis ("windows")**: batches of fixed-shape windows are sharded
    across devices; each device runs the DP screen on its shard, and hit
    masks/scores are gathered.  This is the production path: window
    enumeration already provides the overlap halo, so shards are
    independent by construction and the merged result is bit-identical to
    single-device execution (the deterministic global dedup+sort happens
    after the gather).
  - **sp axis ("positions")**: a single very long target can additionally
    be split along its length with an overlap halo of (Q - 1 + max
    diffs) columns, each device screening its own column range.  Used for
    contig-scale pairwise alignment.

Collectives ride ICI via shard_map + jax.lax collectives; no NCCL/MPI
analogue exists in the reference (it is new design, SURVEY.md §2.10).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from calitas_tpu import _enable_jax_compilation_cache

_enable_jax_compilation_cache()
from calitas_tpu.core.scoring import Scorer
from calitas_tpu.ops.dp_screen import _screen_scores

WINDOW_AXIS = "windows"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (WINDOW_AXIS,))


_SHARDED_FN_CACHE: dict = {}


def sharded_screen_fn(mesh: Mesh, scorer: Scorer):
    """Build a jitted, mesh-sharded screen: windows sharded over the
    window axis, query replicated, per-window best scores sharded out.
    Includes a psum'd global hit count so the collective path is exercised
    end-to-end.

    Cached per (mesh, scorer): looping callers (screen_on_mesh per batch)
    reuse one traced function instead of retracing."""
    key = (
        tuple(d.id for d in mesh.devices.flat), mesh.axis_names,
        scorer.match_score, scorer.mismatch_score,
        scorer.query_gap_score, scorer.target_gap_score,
    )
    cached = _SHARDED_FN_CACHE.get(key)
    if cached is not None:
        return cached
    match, mismatch = scorer.match_score, scorer.mismatch_score
    qgap, tgap = scorer.query_gap_score, scorer.target_gap_score

    def local_screen(qmask, tmasks, lengths, min_score):
        best = _screen_scores(
            qmask, tmasks, lengths,
            match=match, mismatch=mismatch, qgap=qgap, tgap=tgap,
        )
        local_hits = jnp.sum((best >= min_score).astype(jnp.int32))
        total_hits = jax.lax.psum(local_hits, WINDOW_AXIS)
        return best, total_hits

    shard = jax.shard_map(
        local_screen,
        mesh=mesh,
        in_specs=(P(), P(WINDOW_AXIS, None), P(WINDOW_AXIS), P()),
        out_specs=(P(WINDOW_AXIS), P()),
        check_vma=False,  # scan carries start replicated, become varying
    )
    fn = jax.jit(shard)
    _SHARDED_FN_CACHE[key] = fn
    return fn


def screen_on_mesh(
    mesh: Mesh,
    scorer: Scorer,
    qmask: np.ndarray,
    tmasks: np.ndarray,
    lengths: np.ndarray,
    min_score: int,
):
    """Convenience wrapper: pads the batch to a multiple of the mesh size
    and runs the sharded screen."""
    n = mesh.devices.size
    B = tmasks.shape[0]
    pad = (-B) % n
    if pad:
        tmasks = np.concatenate(
            [tmasks, np.zeros((pad, tmasks.shape[1]), tmasks.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    fn = sharded_screen_fn(mesh, scorer)
    best, total = fn(
        jnp.asarray(qmask),
        jnp.asarray(tmasks),
        jnp.asarray(lengths, dtype=jnp.int32),
        jnp.int32(min_score),
    )
    return np.asarray(best)[:B], int(total)
