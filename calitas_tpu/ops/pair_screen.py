"""Pair-batched glocal-DP screening: per-row query AND per-row target.

PairwiseAlignSequences and AlignToReference align a *different* query
against each target (PairwiseAlignSequences.scala:62-64,
AlignToReference.scala:104-118), so the genome screen's one-query /
many-windows kernels don't apply.  This kernel batches whole (query,
target) pairs: one device dispatch computes, exactly in int32, both
chains' best final-row DP scores for thousands of pairs at once.

Exactness contract (same recurrence as ``align/oracle.py::dp_matrix``,
via ``ops/dp_screen.py``):

- chain A = DP(query, target); chain B = DP(revcomp(query), target),
  which is score-equivalent to DP(query, revcomp(target)) — the engine's
  other strand pass (docs/ARCHITECTURE.md strand trick).
- The chain maximum is an upper bound on the guide-DP part of ANY
  alignment the host engine can accept on that pass, so callers can skip
  a pass whose bound cannot reach / beat what the other pass achieved
  (the tie goes to the fwd pass: ``engine.align_best`` takes the first
  maximum and fwd alignments precede rev ones).

Pairs are bucketed by query length (each bucket is one compiled shape)
and targets padded to power-of-two slots; zero padding has mask 0 (never
compatible), identical to the N/padding convention of the genome screen.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from calitas_tpu import _enable_jax_compilation_cache

_enable_jax_compilation_cache()
from calitas_tpu.core.scoring import Scorer
from calitas_tpu.core.sequence import TARGET_MASK_TABLE, encode_query, revcomp


@partial(jax.jit, static_argnames=("match", "mismatch", "qgap", "tgap"))
def _pair_scores_dual(
    qmasks_a, qmasks_b, tmasks, lengths, match, mismatch, qgap, tgap
):
    """Both chains' best final-row scores, per pair.

    qmasks_a/b: [B, Q] uint8 query IUPAC masks (chain A / chain B)
    tmasks:     [B, T] uint8 target masks (N and padding -> 0)
    lengths:    [B]    int32 valid target lengths
    returns:    ([B], [B]) int32 chain maxima

    The target masks are uploaded once and duplicated on device; the two
    chains run as one 2B-row scan (identical cost profile to
    ``dp_screen._screen_scores`` with twice the batch).
    """
    B, T = tmasks.shape
    Q = qmasks_a.shape[1]
    qm = jnp.concatenate([qmasks_a, qmasks_b]).astype(jnp.uint8)  # [2B, Q]
    tm = jnp.concatenate([tmasks, tmasks])  # [2B, T]
    ln = jnp.concatenate([lengths, lengths])
    idec = jnp.arange(Q + 1, dtype=jnp.int32) * tgap
    init_col = jnp.broadcast_to(idec, (2 * B, Q + 1))
    neg_inf = jnp.int32(-(2**30))

    def step(carry, xs):
        s_prev, best = carry
        tcol, j = xs  # tcol: [2B] uint8
        compat = (qm & tcol[:, None]) != 0  # [2B, Q]
        pair = jnp.where(compat, jnp.int32(match), jnp.int32(mismatch))
        tmp = jnp.maximum(s_prev[:, :-1] + pair, s_prev[:, 1:] + jnp.int32(qgap))
        tmp_full = jnp.concatenate(
            [jnp.zeros((2 * B, 1), jnp.int32), tmp], axis=1
        )
        new = jax.lax.cummax(tmp_full - idec[None, :], axis=1) + idec[None, :]
        end_score = jnp.where(j <= ln, new[:, Q], neg_inf)
        best = jnp.maximum(best, end_score)
        return (new, best), None

    xs = (tm.T, jnp.arange(1, T + 1, dtype=jnp.int32))
    (_, best), _ = jax.lax.scan(
        step, (init_col, jnp.full((2 * B,), neg_inf, jnp.int32)), xs
    )
    return best  # [2B]: chain A maxima then chain B maxima


@partial(jax.jit, static_argnames=("match", "mismatch", "qgap", "tgap"))
def _pair_scores_dual_ranges(
    qmasks_a, qmasks_b, tmasks, lengths, min_scores,
    match, mismatch, qgap, tgap
):
    """Like :func:`_pair_scores_dual` but also returns, per chain row,
    the (min, max) 1-based end columns whose final-row score reaches
    that pair's ``min_scores`` entry (min = T+1 / max = 0 when none) —
    the device side of the sliced pair finish (same contract as
    ``dp_screen._screen_scores_ranges``)."""
    B, T = tmasks.shape
    Q = qmasks_a.shape[1]
    qm = jnp.concatenate([qmasks_a, qmasks_b]).astype(jnp.uint8)
    tm = jnp.concatenate([tmasks, tmasks])
    ln = jnp.concatenate([lengths, lengths])
    ms = jnp.concatenate([min_scores, min_scores]).astype(jnp.int32)
    idec = jnp.arange(Q + 1, dtype=jnp.int32) * tgap
    init_col = jnp.broadcast_to(idec, (2 * B, Q + 1))
    neg_inf = jnp.int32(-(2**30))

    def step(carry, xs):
        s_prev, best, mn, mx = carry
        tcol, j = xs
        compat = (qm & tcol[:, None]) != 0
        pair = jnp.where(compat, jnp.int32(match), jnp.int32(mismatch))
        tmp = jnp.maximum(s_prev[:, :-1] + pair, s_prev[:, 1:] + jnp.int32(qgap))
        tmp_full = jnp.concatenate(
            [jnp.zeros((2 * B, 1), jnp.int32), tmp], axis=1
        )
        new = jax.lax.cummax(tmp_full - idec[None, :], axis=1) + idec[None, :]
        end_score = jnp.where(j <= ln, new[:, Q], neg_inf)
        best = jnp.maximum(best, end_score)
        qual = end_score >= ms
        mn = jnp.where(qual, jnp.minimum(mn, j), mn)
        mx = jnp.where(qual, j, mx)
        return (new, best, mn, mx), None

    xs = (tm.T, jnp.arange(1, T + 1, dtype=jnp.int32))
    (_, best, mn, mx), _ = jax.lax.scan(
        step,
        (
            init_col,
            jnp.full((2 * B,), neg_inf, jnp.int32),
            jnp.full((2 * B,), T + 1, jnp.int32),
            jnp.zeros((2 * B,), jnp.int32),
        ),
        xs,
    )
    return best, mn, mx  # each [2B]: chain A rows then chain B rows


class PairScreen:
    """Batched exact DP maxima for heterogeneous (query, target) pairs.

    ``chain_maxima(queries, targets)`` returns two int32 arrays [N]: the
    chain A (query vs target) and chain B (revcomp(query) vs target)
    final-row DP maxima for every pair.  Pairs are screened in
    length-bucketed batches; order is preserved.
    """

    MIN_SLOT = 64
    MAX_SLOT = 8192  # longer targets are reported as unscreened
    NO_SCREEN = -(2**30)  # sentinel: caller must run the pass unaided

    def __init__(self, scorer: Scorer, batch_rows: int = 4096):
        self.scorer = scorer
        self.batch_rows = batch_rows

    def chain_maxima(
        self, queries: list[str], targets: list
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.chain_maxima_ranges(queries, targets, None)[:2]

    def chain_maxima_ranges(
        self,
        queries: list[str],
        targets: list,
        min_scores: Optional[list] = None,
    ) -> tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
        """Chain maxima plus, when ``min_scores`` is given (one qualifying
        threshold per pair), the per-chain qualifying end-column ranges.

        Returns ``(best_a, best_b, ranges)`` with ranges int32 [N, 4] =
        (loA, hiA, loB, hiB): 1-based inclusive end columns of the pair's
        target whose chain final-row DP score reaches the pair's
        threshold (lo > hi when none — the empty range).  Unscreenable
        pairs keep the NO_SCREEN sentinel in best_* and -1s in ranges.
        With ``min_scores=None``, ranges is None (maxima-only screen)."""
        n = len(queries)
        best_a = np.full(n, self.NO_SCREEN, dtype=np.int64)
        best_b = np.full(n, self.NO_SCREEN, dtype=np.int64)
        out_ranges = (
            np.full((n, 4), -1, dtype=np.int32)
            if min_scores is not None
            else None
        )
        # Bucket by (query length, target slot): one compiled shape each.
        buckets: dict[tuple[int, int], list[int]] = {}
        tbytes: list[bytes] = []
        for i, (q, t) in enumerate(zip(queries, targets)):
            tb = t if isinstance(t, (bytes, bytearray)) else str(t).encode("ascii")
            tbytes.append(bytes(tb))
            if not q or not tb or len(tb) > self.MAX_SLOT:
                # Unscreenable (incl. empty targets, whose masked DP
                # would return NO_SCREEN with contradictory non-sentinel
                # ranges): leave the NO_SCREEN sentinel and -1 ranges.
                continue
            slot = self.MIN_SLOT
            while slot < len(tb):
                slot *= 2
            buckets.setdefault((len(q), slot), []).append(i)

        s = self.scorer
        # Dispatch every chunk before resolving any: the device works
        # through all chunks back to back while the host packs the next,
        # and each chunk's (small) readback starts as soon as its compute
        # finishes — one D2H per chunk, no serialized round trips.
        launched = []  # (chunk, out device array(s))
        for (Q, slot), idxs in buckets.items():
            for c0 in range(0, len(idxs), self.batch_rows):
                chunk = idxs[c0 : c0 + self.batch_rows]
                # Bucket the batch shape to a power of two: XLA compiles
                # per static shape — a ragged tail chunk must not
                # trigger a fresh compile.  Pad rows have length 0
                # (every end column masked) and are discarded below.
                B = max(64, 1 << (len(chunk) - 1).bit_length())
                qa = np.zeros((B, Q), dtype=np.uint8)
                qb = np.zeros((B, Q), dtype=np.uint8)
                tm = np.zeros((B, slot), dtype=np.uint8)
                ln = np.zeros(B, dtype=np.int32)
                ms = np.zeros(B, dtype=np.int32)
                for r, i in enumerate(chunk):
                    qa[r] = encode_query(queries[i])
                    qb[r] = encode_query(revcomp(queries[i]))
                    t = np.frombuffer(tbytes[i], dtype=np.uint8)
                    tm[r, : len(t)] = TARGET_MASK_TABLE[t]
                    ln[r] = len(t)
                    if min_scores is not None:
                        ms[r] = int(min_scores[i])
                skw = dict(
                    match=s.match_score, mismatch=s.mismatch_score,
                    qgap=s.query_gap_score, tgap=s.target_gap_score,
                )
                if min_scores is not None:
                    out = _pair_scores_dual_ranges(
                        jnp.asarray(qa), jnp.asarray(qb), jnp.asarray(tm),
                        jnp.asarray(ln), jnp.asarray(ms), **skw
                    )
                else:
                    out = (
                        _pair_scores_dual(
                            jnp.asarray(qa), jnp.asarray(qb),
                            jnp.asarray(tm), jnp.asarray(ln), **skw
                        ),
                    )
                for o in out:
                    try:
                        o.copy_to_host_async()
                    except Exception:
                        pass
                launched.append((chunk, out))
        for chunk, out in launched:
            ab = np.asarray(out[0])
            B = len(ab) // 2
            for r, i in enumerate(chunk):
                best_a[i] = int(ab[r])
                best_b[i] = int(ab[B + r])
            if out_ranges is not None:
                mn = np.asarray(out[1])
                mx = np.asarray(out[2])
                for r, i in enumerate(chunk):
                    out_ranges[i] = (mn[r], mx[r], mn[B + r], mx[B + r])
        return best_a, best_b, out_ranges


def pass_bounds_for(guide, chain_a: int, chain_b: int) -> dict:
    """Map the two chain maxima onto the engine's strand passes.

    Chain A (the DP-orientation query over the forward target) IS the
    engine's rev pass for 5'-PAM guides and the fwd pass otherwise;
    chain B is the score-equivalent of the other pass (same mapping as
    ``parallel/screen_runner.py``).  ``NO_SCREEN`` chain values map to an
    unbounded pass (the caller must run it)."""
    if guide.pam_is_5prime:
        return {"rev": chain_a, "fwd": chain_b}
    return {"fwd": chain_a, "rev": chain_b}
