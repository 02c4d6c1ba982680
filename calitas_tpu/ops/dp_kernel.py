"""The device DP screen kernel: Pallas on Triton, one thread per window.

Contract (the full screen, for G same-length guides in one launch): for
every window and both chains (chain A = the DP-orientation query, chain
B = its reverse complement) the best final-row score over the window's
end columns, and optionally the (min, max) 1-based end columns whose
score reaches that guide's ``min_score``.  With ``pam_gate`` the target
bytes carry two gate bits (``annotate_genome_pam``): bit 4 = a PAM fits
after an alignment ENDING here (chain A may only end on such columns),
bit 5 = a revcomp'd PAM fits before an alignment STARTING after here
(chain B's free start is closed elsewhere).  Exact int32, bit-identical
to ``align/oracle.py`` and to the XLA scan in ``ops/dp_screen.py``.

Layout: tcols is ``[ceil(T/4), B]`` int32 — four annotated column bytes
per word (byte b = column 4w+b) — so one loop step is one coalesced row
load across a block's windows.  A program owns ``BLOCK_W`` windows, one
per thread; the DP column of both chains (2 x (Q+1) int32) lives in
registers, the Q rows unrolled statically.  The program loops over the
packed words; blocks (and guides, the second grid axis) run in parallel.

Per column per row i (query mask q_i), the same recurrence as the oracle:
    new[i] = max(S[i-1] + (q_i & t ? match : mismatch),
                 S[i] + qgap, new[i-1] + tgap)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from calitas_tpu import _enable_jax_compilation_cache
from calitas_tpu.ops.dp_screen import NEG_GATE, NEG_INF

_enable_jax_compilation_cache()

#: windows per program, one thread per window (BLOCK_W // 32 warps);
#: 32, 64 and 128 run within 1% of each other on an H100, 256 ~10%
#: slower (PERF.md)
BLOCK_W = 128
#: longest query the register-resident column takes: up to 48 rows the
#: per-cell time stays within 11% of Q = 23 on an H100, at 64 it is 52%
#: slower and from 80 on ~33x (spilled registers; PERF.md).  Longer
#: guides run the XLA scan (genome_screen routes them explicitly).
MAX_Q = 48


def supports(q_len: int) -> bool:
    return 0 < q_len <= MAX_Q


def pack_tcols(wins):
    """[B, T] uint8 annotated window bytes -> [ceil(T/4), B] int32 words,
    four consecutive DP columns per word (byte b = column 4w+b)."""
    B, T = wins.shape
    W4 = -(-T // 4)
    if T != W4 * 4:
        wins = jnp.pad(wins, ((0, 0), (0, W4 * 4 - T)))
    w = wins.reshape(B, W4, 4).astype(jnp.int32)
    words = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    return words.T


def _kernel(
    qvals_ref,  # [G, 2, Q] int32: chain A and chain B query masks
    minscore_ref,  # [G] int32: per-guide qualifying-end thresholds
    tcols_ref,  # [ceil(T/4), B] int32 packed annotated columns
    best_ref,  # [G, 2, B] int32 out: per-chain maxima
    ranges_ref=None,  # [G, 2, 2, B] int32 out: per-chain (min, max) end col
    *,
    T: int,
    Q: int,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
    pam_gate: bool,
    emit_ranges: bool,
):
    blk = pl.program_id(0)
    g = pl.program_id(1)
    lanes = pl.ds(blk * BLOCK_W, BLOCK_W)
    q_a = [qvals_ref[g, 0, i] for i in range(Q)]
    q_b = [qvals_ref[g, 1, i] for i in range(Q)]
    ms = minscore_ref[g]
    zeros = jnp.zeros((BLOCK_W,), jnp.int32)
    neg = jnp.full((BLOCK_W,), NEG_INF, jnp.int32)

    def chain(state, tcol, qs, row0):
        new = [row0]
        diag = state[0]
        for i in range(1, Q + 1):
            pair = jnp.where((tcol & qs[i - 1]) != 0, match, mismatch)
            cand = jnp.maximum(diag + pair, state[i] + qgap)
            cand = jnp.maximum(cand, new[i - 1] + tgap)
            diag = state[i]
            new.append(cand)
        return tuple(new)

    def col_step(jj, raw, valid, carry):
        """One DP column: ``jj`` its 1-based index, ``raw`` its annotated
        byte, ``valid`` a traced bool for the tail bytes of a last word
        past T (None = statically in range)."""
        s_a, s_b, best_a, best_b, rng = carry
        tcol = raw & 15
        row0_b = jnp.where((raw & 32) != 0, 0, NEG_GATE) if pam_gate else zeros
        n_a = chain(s_a, tcol, q_a, zeros)
        n_b = chain(s_b, tcol, q_b, row0_b)
        end_a = jnp.where((raw & 16) != 0, n_a[Q], NEG_INF) if pam_gate else n_a[Q]
        end_b = n_b[Q]
        if valid is not None:
            end_a = jnp.where(valid, end_a, NEG_INF)
            end_b = jnp.where(valid, end_b, NEG_INF)
        best_a = jnp.maximum(best_a, end_a)
        best_b = jnp.maximum(best_b, end_b)
        if emit_ranges:
            mn_a, mx_a, mn_b, mx_b = rng
            ok_a = end_a >= ms
            ok_b = end_b >= ms
            rng = (
                jnp.where(ok_a, jnp.minimum(mn_a, jj), mn_a),
                jnp.where(ok_a, jj, mx_a),
                jnp.where(ok_b, jnp.minimum(mn_b, jj), mn_b),
                jnp.where(ok_b, jj, mx_b),
            )
        return n_a, n_b, best_a, best_b, rng

    def body(w, carry):
        word = tcols_ref[w, lanes]
        for b in range(4):
            raw = (word >> (8 * b)) & 0xFF
            valid = None if (T % 4 == 0 or b < T % 4) else (4 * w + b) < T
            carry = col_step(4 * w + b + 1, raw, valid, carry)
        return carry

    init = tuple(jnp.full((BLOCK_W,), i * tgap, jnp.int32) for i in range(Q + 1))
    top = jnp.full((BLOCK_W,), T + 1, jnp.int32)
    rng0 = (top, zeros, top, zeros) if emit_ranges else ()
    _, _, best_a, best_b, rng = jax.lax.fori_loop(
        0, -(-T // 4), body, (init, init, neg, neg, rng0)
    )
    best_ref[g, 0, lanes] = best_a
    best_ref[g, 1, lanes] = best_b
    if emit_ranges:
        ranges_ref[g, 0, 0, lanes] = rng[0]
        ranges_ref[g, 0, 1, lanes] = rng[1]
        ranges_ref[g, 1, 0, lanes] = rng[2]
        ranges_ref[g, 1, 1, lanes] = rng[3]


@partial(
    jax.jit,
    static_argnames=(
        "T", "Q", "match", "mismatch", "qgap", "tgap", "pam_gate",
        "emit_ranges", "interpret",
    ),
)
def screen_multi(
    qvals, tcols, min_scores=None, *, T, Q, match, mismatch, qgap, tgap,
    pam_gate=False, emit_ranges=False, interpret=False,
):
    """Both-chain screen of G same-length guides over a packed window
    batch: ``qvals`` [G, 2, Q] int32, ``tcols`` [ceil(T/4), B] int32 from
    :func:`pack_tcols` (B a multiple of ``BLOCK_W``).  Returns per-chain
    maxima [G, 2, B] int32 and, with ``emit_ranges``, also [G, 2, 2, B]
    int32 per-chain (min, max) 1-based end columns scoring >= that
    guide's ``min_scores[g]`` (min = T+1 / max = 0 when none qualify).

    ``interpret`` runs the kernel in the Pallas interpreter (CPU tests)."""
    G = qvals.shape[0]
    B = tcols.shape[1]
    if B % BLOCK_W or tcols.shape[0] != -(-T // 4):
        raise ValueError(
            f"tcols {tcols.shape}: need [ceil({T}/4), a multiple of {BLOCK_W}]"
        )
    if min_scores is None:
        min_scores = jnp.zeros((G,), jnp.int32)
    kernel = partial(
        _kernel, T=T, Q=Q, match=match, mismatch=mismatch, qgap=qgap,
        tgap=tgap, pam_gate=pam_gate, emit_ranges=emit_ranges,
    )
    out_shape = [jax.ShapeDtypeStruct((G, 2, B), jnp.int32)]
    if emit_ranges:
        out_shape.append(jax.ShapeDtypeStruct((G, 2, 2, B), jnp.int32))
    out = pl.pallas_call(
        kernel,
        grid=(B // BLOCK_W, G),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=BLOCK_W // 32, num_stages=1),
        interpret=interpret,
        name="dp_screen",
    )(
        jnp.asarray(qvals, jnp.int32),
        jnp.asarray(min_scores, jnp.int32).reshape(G),
        tcols,
    )
    return tuple(out) if emit_ranges else out[0]
