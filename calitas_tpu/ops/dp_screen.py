"""Batched glocal-DP screening on device (XLA path).

The genome search is screen-then-traceback (SURVEY.md §7.3): hits are
sparse, so the device computes — exactly, in int32 — the final DP row
(best score per alignment *end* column) for a batch of windows, and only
windows with a qualifying end column are handed to the host engine for
traceback + PAM extension.  False positives are impossible by
construction (same integer recurrence as the oracle); so are false
negatives.

Recurrence (matches calitas_tpu.align.oracle.dp_matrix):

    S[0, j] = 0
    S[i, 0] = i * target_gap
    S[i, j] = max(S[i-1, j-1] + pair, S[i-1, j] + tgap, S[i, j-1] + qgap)

Layout: we scan target columns (length T) and keep the full DP *column*
[B, Q+1] as carry.  The in-column "up" chain is a max-plus prefix scan,
computed as ``cummax(tmp - i*tgap) + i*tgap`` along the (tiny) Q axis.
All lanes of the [B, Q+1] tile do useful work; batch B provides the
parallelism.

``gate`` applies the PAM gate bits that ``annotate_genome_pam`` puts in
bits 4/5 of each target byte, exactly as the GPU kernel
(``ops/dp_kernel.py``) does: ``"end"`` (chain A) lets only columns with
bit 4 end an alignment; ``"start"`` (chain B) closes the free start
(row 0) on columns without bit 5.  This module is the plain reference
of that kernel and the screen on backends the kernel does not serve.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from calitas_tpu import _enable_jax_compilation_cache

_enable_jax_compilation_cache()
from calitas_tpu.core.scoring import Scorer

NEG_INF = -(2**30)
#: chain B's closed-start row-0 value: far below any reachable DP value,
#: far above int32 overflow as gap costs accumulate
NEG_GATE = -(2**26)

_SCORES = ("match", "mismatch", "qgap", "tgap")


def _column_step(qmask, match, mismatch, qgap, tgap, gate):
    """The scan step shared by every XLA screen: (column [B, Q+1], tcol
    [B] uint8) -> (new column, end score [B] before length masking), plus
    the initial column's row offsets."""
    Q = qmask.shape[0]
    qm = qmask.astype(jnp.uint8)
    idec = jnp.arange(Q + 1, dtype=jnp.int32) * tgap

    def step(s_prev, tcol):
        B = s_prev.shape[0]
        compat = (qm[None, :] & tcol[:, None]) != 0  # [B, Q]
        pair = jnp.where(compat, jnp.int32(match), jnp.int32(mismatch))
        tmp = jnp.maximum(s_prev[:, :-1] + pair, s_prev[:, 1:] + jnp.int32(qgap))
        if gate == "start":
            row0 = jnp.where((tcol & 32) != 0, 0, NEG_GATE).astype(jnp.int32)
        else:
            row0 = jnp.zeros((B,), jnp.int32)  # free start
        tmp_full = jnp.concatenate([row0[:, None], tmp], axis=1)
        new = jax.lax.cummax(tmp_full - idec[None, :], axis=1) + idec[None, :]
        end = new[:, Q]
        if gate == "end":
            end = jnp.where((tcol & 16) != 0, end, NEG_INF)
        return new, end

    return idec, step


@partial(jax.jit, static_argnames=(*_SCORES, "gate"))
def _screen_scores(qmask, tmasks, lengths, match, mismatch, qgap, tgap,
                   gate=None):
    """Best final-row score over valid end columns, per batch row.

    qmask:   [Q]    uint8 query IUPAC masks (uppercase guide)
    tmasks:  [B, T] uint8 target masks (N and padding -> 0; bits 4/5 =
             PAM gate when ``gate`` is set)
    lengths: [B]    int32 valid window lengths (end columns > length ignored)
    returns: [B]    int32 max_{1<=j<=len} S[Q, j]
    """
    B, T = tmasks.shape
    idec, col = _column_step(qmask, match, mismatch, qgap, tgap, gate)

    def step(carry, xs):
        s_prev, best = carry
        tcol, j = xs
        new, end = col(s_prev, tcol)
        best = jnp.maximum(best, jnp.where(j <= lengths, end, NEG_INF))
        return (new, best), None

    xs = (tmasks.T, jnp.arange(1, T + 1, dtype=jnp.int32))
    init = (jnp.broadcast_to(idec, (B, idec.shape[0])),
            jnp.full((B,), NEG_INF, jnp.int32))
    (_, best), _ = jax.lax.scan(step, init, xs)
    return best


@partial(jax.jit, static_argnames=(*_SCORES, "gate"))
def _screen_scores_ranges(
    qmask, tmasks, lengths, min_score, match, mismatch, qgap, tgap, gate=None
):
    """Like :func:`_screen_scores` but also returns the (min, max) 1-based
    end columns whose final-row score reaches ``min_score`` (min = T+1 /
    max = 0 when none) — the device side of the sliced host finish."""
    B, T = tmasks.shape
    idec, col = _column_step(qmask, match, mismatch, qgap, tgap, gate)
    ms = jnp.asarray(min_score, jnp.int32)

    def step(carry, xs):
        s_prev, best, mn, mx = carry
        tcol, j = xs
        new, end = col(s_prev, tcol)
        end = jnp.where(j <= lengths, end, NEG_INF)
        best = jnp.maximum(best, end)
        qual = end >= ms
        mn = jnp.where(qual, jnp.minimum(mn, j), mn)
        mx = jnp.where(qual, j, mx)
        return (new, best, mn, mx), None

    xs = (tmasks.T, jnp.arange(1, T + 1, dtype=jnp.int32))
    init = (
        jnp.broadcast_to(idec, (B, idec.shape[0])),
        jnp.full((B,), NEG_INF, jnp.int32),
        jnp.full((B,), T + 1, jnp.int32),
        jnp.zeros((B,), jnp.int32),
    )
    (_, best, mn, mx), _ = jax.lax.scan(step, init, xs)
    return best, mn, mx


@partial(jax.jit, static_argnames=_SCORES)
def _final_rows(qmask, tmasks, match, mismatch, qgap, tgap):
    """Full final DP row per batch element: [B, T] with entry j-1 = S[Q, j].
    (Used by tests as the per-column reference.)"""
    B, _ = tmasks.shape
    idec, col = _column_step(qmask, match, mismatch, qgap, tgap, None)
    _, rows = jax.lax.scan(
        col, jnp.broadcast_to(idec, (B, idec.shape[0])), tmasks.T
    )
    return rows.T  # [B, T]


class ScreenKernel:
    """Callable wrapper binding a scorer; dispatches to the XLA screen."""

    def __init__(self, scorer: Scorer):
        self.scorer = scorer

    def _scores(self):
        s = self.scorer
        return dict(
            match=s.match_score, mismatch=s.mismatch_score,
            qgap=s.query_gap_score, tgap=s.target_gap_score,
        )

    def max_scores(
        self, qmask: np.ndarray, tmasks: np.ndarray, lengths: np.ndarray
    ) -> np.ndarray:
        return np.asarray(
            _screen_scores(
                jnp.asarray(qmask), jnp.asarray(tmasks),
                jnp.asarray(lengths, dtype=jnp.int32), **self._scores()
            )
        )

    def final_rows(self, qmask: np.ndarray, tmasks: np.ndarray) -> np.ndarray:
        return np.asarray(
            _final_rows(jnp.asarray(qmask), jnp.asarray(tmasks), **self._scores())
        )
