"""Device-resident genome screening.

The production SearchReference path: the contig's IUPAC-mask array is
staged to device memory **once**; window extraction, layout, and the DP
screen all run on device inside a single dispatch that loops over window
batches.  Only bit-packed per-window flags and coarse end-column ranges
return to the host.

The DP itself is the Pallas/Triton kernel of ``ops/dp_kernel.py`` on a
GPU, and the XLA scan of ``ops/dp_screen.py`` elsewhere (and for guides
longer than the kernel's register column); both compute the same exact
int32 contract, PAM gate included.

Strand handling: screening query q against revcomp(window) is equivalent
to screening revcomp(q) against the window (the pairing and gap costs are
side-preserving under joint reversal), so both strands run against the
same device-resident forward genome with two queries.
"""

from __future__ import annotations

import logging
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from calitas_tpu import _enable_jax_compilation_cache

_enable_jax_compilation_cache()
from calitas_tpu.core.scoring import Scorer
from calitas_tpu.core.sequence import TARGET_MASK_TABLE, encode_query
from calitas_tpu.ops import dp_kernel
from calitas_tpu.ops.dp_kernel import BLOCK_W

#: windows per device batch: enough threads (one per window) to fill a
#: GPU's SMs — the kernel runs ~2.6x more cells/s at 65536 windows per
#: launch than at 8192 (PERF.md)
BATCH_WINDOWS = 65536



def range_block(window: int) -> int:
    """Column width of one coarse end-column range block at this window.

    Ranges travel as one (min_block, max_block) uint8 pair per chain per
    window, so the block width is the smallest power-of-two multiple of 8
    with ``window <= 256 * block``: 8 columns up to ``-w 2048``, then
    16/32/64/... doubling without bound — 256 blocks cover ANY window
    width, so ranges (and the sliced native finish they enable) stay on
    at every legal ``-w`` (SearchReference.scala:460 accepts any window
    size).  A coarser block only widens
    the host finish's DP column slice (by < block columns per side),
    never its correctness — the widened slice is always a superset of the
    qualifying end columns."""
    rb = 8
    while window > rb * 256:
        rb *= 2
    return rb


def _pad_genome(genome_dev, need: int):
    """Zero-pad the staged genome to a power-of-two >= ``need`` (zero
    mask = mismatch-everything pad; the bucketed length keeps one
    compilation across contigs)."""
    if need <= genome_dev.shape[0]:
        return genome_dev
    need = 1 << (need - 1).bit_length()
    return jnp.concatenate(
        [genome_dev, jnp.zeros(need - genome_dev.shape[0], jnp.uint8)]
    )



def _static_pam_spec(pam_spec):
    """Hashable (encoded-PAM, max_mm, max_gap) static arg for the jitted
    screens, or None when the gate is off (no PAMs)."""
    if pam_spec is None:
        return None
    pams, max_pam_mm, max_gap = pam_spec
    if not pams or any(len(p) == 0 for p in pams):
        return None
    return (
        tuple(tuple(int(m) for m in encode_query(p)) for p in pams),
        int(max_pam_mm),
        int(max_gap),
    )


_LONG_GUIDES_LOGGED: set = set()


def kernel_for(use_kernel: bool, q_len: int) -> bool:
    """Whether a guide group of DP-query length ``q_len`` runs the kernel:
    queries longer than the kernel's register column take the XLA scan,
    logged once per length."""
    if not use_kernel:
        return False
    if dp_kernel.supports(q_len):
        return True
    if q_len not in _LONG_GUIDES_LOGGED:
        _LONG_GUIDES_LOGGED.add(q_len)
        logging.getLogger("calitas_tpu.screen").warning(
            "DP query length %d exceeds the kernel's %d-row limit; "
            "screening it with the XLA scan.", q_len, dp_kernel.MAX_Q,
        )
    return False


def default_device_platform() -> str:
    """Platform of the device computations will actually land on —
    honors ``jax_default_device`` (tests pin it to CPU)."""
    dev = jax.config.jax_default_device
    if dev is None:
        dev = jax.devices()[0]
    return dev.platform


def extract_window_grid(genome, base, n_windows: int, step: int, window: int):
    """Windows at the regular grid base + i*step, i in [0, n_windows), as a
    [n_windows, window] array — built from contiguous reshapes, not a
    gather.

    Works whenever window <= 2*step (the search default: overlap ~6% of
    the window).  Row i of reshape(genome[base:base+n*step], (n, step)) is
    genome[base+i*step : base+(i+1)*step); the remaining window-step
    columns continue at base+step+i*step, i.e. row i of the same reshape
    shifted by one step.
    """
    if window <= step:
        flat = jax.lax.dynamic_slice(genome, (base,), (n_windows * step,))
        return flat.reshape(n_windows, step)[:, :window]
    if window <= 2 * step:
        a = jax.lax.dynamic_slice(genome, (base,), (n_windows * step,)).reshape(
            n_windows, step
        )
        b = jax.lax.dynamic_slice(
            genome, (base + step,), (n_windows * step,)
        ).reshape(n_windows, step)[:, : window - step]
        return jnp.concatenate([a, b], axis=1)
    # Fallback: the general (slow) gather.
    starts = base + jnp.arange(n_windows) * step
    return jax.vmap(
        lambda s: jax.lax.dynamic_slice(genome, (s,), (window,))
    )(starts)


def _pack_flag_bits(flags):
    """Pack a [..., N] boolean/int array into [..., N//8] uint8 bitmasks
    (bit k = element k, little-endian).  The screen's host-visible output:
    flags are 32x smaller than int32 maxima on the D2H path."""
    b = flags.astype(jnp.uint8).reshape(*flags.shape[:-1], -1, 8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return (b * weights).sum(axis=-1).astype(jnp.uint8)


def _unpack_flag_bits(packed: np.ndarray, n: int) -> np.ndarray:
    """Host-side inverse of :func:`_pack_flag_bits`, trimmed to n flags."""
    flat = np.unpackbits(packed, axis=-1, bitorder="little")
    return flat[..., :n].astype(bool)


def _encode_block(u):
    """The IUPAC select chain on a case-folded block (see _encode_staged)."""
    from calitas_tpu.core.sequence import IUPAC_MASK

    m = jnp.zeros_like(u)
    for ch, mask in IUPAC_MASK.items():
        if ch == "N":
            continue  # target N -> 0 (always mismatch)
        m = jnp.where(u == jnp.uint8(ord(ch)), jnp.uint8(mask), m)
    return m


_ENCODE_CHUNK = 1 << 22  # 4 MB per loop step: keeps per-op shapes small


@jax.jit
def _encode_staged(raw):
    """Raw contig bytes -> 4-bit IUPAC target masks, on device.

    Equivalent to ``TARGET_MASK_TABLE[raw]`` (core/sequence.py:50-57:
    case-insensitive, N and unknown bytes -> 0) but computed as an
    arithmetic select chain on device: the host-side 256-entry table
    gather is the single most expensive staging step on low-memory-
    bandwidth hosts, while on device the 15 compares are free next to
    the H2D transfer.  ``x & 0xDF`` folds case (x&0xDF == L iff
    x in {L, L|0x20} for an uppercase letter L, so non-letters can't
    alias).

    Callers zero-pad the raw array on the host (a memset) to a power of
    two — zero bytes encode to mask 0.  Like the screen itself this runs
    as a fori_loop over fixed-size slices: per-op shapes (and the
    compiled program) stay the same size no matter the contig length."""
    n = raw.shape[0]
    if n <= _ENCODE_CHUNK:
        return _encode_block(raw & jnp.uint8(0xDF))
    # n is a power of two > _ENCODE_CHUNK, so it divides evenly.
    n_chunks = n // _ENCODE_CHUNK

    def body(i, out):
        c = jax.lax.dynamic_slice(raw, (i * _ENCODE_CHUNK,), (_ENCODE_CHUNK,))
        m = _encode_block(c & jnp.uint8(0xDF))
        return jax.lax.dynamic_update_slice(out, m, (i * _ENCODE_CHUNK,))

    return jax.lax.fori_loop(0, n_chunks, body, jnp.zeros_like(raw))


@jax.jit
def _unpack_staged(packed):
    """[n/2] uint8 nibble pairs -> [n] uint8 4-bit IUPAC masks, on device
    (element 2i = low nibble of byte i, 2i+1 = high nibble).  Chunked
    like :func:`_encode_staged`."""
    n2 = packed.shape[0]

    def block(p):
        return jnp.stack([p & jnp.uint8(15), p >> 4], axis=-1).reshape(-1)

    if n2 <= _ENCODE_CHUNK:
        return block(packed)
    n_chunks = n2 // _ENCODE_CHUNK  # n2 is a power of two > chunk

    def body(i, out):
        c = jax.lax.dynamic_slice(
            packed, (i * _ENCODE_CHUNK,), (_ENCODE_CHUNK,)
        )
        return jax.lax.dynamic_update_slice(
            out, block(c), (i * 2 * _ENCODE_CHUNK,)
        )

    return jax.lax.fori_loop(
        0, n_chunks, body, jnp.zeros(2 * n2, jnp.uint8)
    )


def _pack_staging_nibbles(contig_bases: np.ndarray, padded_len: int):
    """Host-side 4-bit packing for staging: encode to IUPAC masks (the
    256-entry table gather runs at memory speed — negligible next to a
    slow link) and pack two masks per byte.  Zero pad -> mask 0."""
    masks = TARGET_MASK_TABLE[contig_bases]
    packed = np.zeros(padded_len // 2, np.uint8)
    h = len(masks) // 2
    m = masks[: 2 * h]
    packed[:h] = m[0::2] | (m[1::2] << 4)
    if len(masks) & 1:
        packed[h] = masks[-1]
    return packed


_LINK_RATE_MBPS: float | None = None
_PACK_RATE_MBPS: float | None = None


def _measured_link_rate_mbps() -> float:
    """One-time H2D link-rate probe (8 MB, after a tiny warmup put)."""
    global _LINK_RATE_MBPS
    if _LINK_RATE_MBPS is None:
        import time

        try:
            jax.device_put(jnp.zeros(1024, jnp.uint8)).block_until_ready()
            probe = np.zeros(8 << 20, np.uint8)
            t0 = time.perf_counter()
            jax.device_put(jnp.asarray(probe)).block_until_ready()
            dt = max(time.perf_counter() - t0, 1e-6)
            _LINK_RATE_MBPS = (len(probe) / 1e6) / dt
        except Exception:
            _LINK_RATE_MBPS = float("inf")  # probe failed: raw path
    return _LINK_RATE_MBPS


def _measured_pack_rate_mbps() -> float:
    """One-time host encode+pack rate probe (8 MB of input bases)."""
    global _PACK_RATE_MBPS
    if _PACK_RATE_MBPS is None:
        import time

        probe = np.full(8 << 20, ord("A"), np.uint8)
        t0 = time.perf_counter()
        _pack_staging_nibbles(probe, 8 << 20)
        dt = max(time.perf_counter() - t0, 1e-6)
        _PACK_RATE_MBPS = (len(probe) / 1e6) / dt
    return _PACK_RATE_MBPS


def _packing_pays() -> bool:
    """Nibble-packing halves H2D bytes at the cost of one host-side
    encode+pack pass: it wins when saved transfer time (N/2 / link)
    exceeds the pack cost (N / pack_rate), i.e. link < pack_rate / 2
    (a slow link pays; a PCIe link at GB/s does not)."""
    return _measured_link_rate_mbps() < _measured_pack_rate_mbps() / 2.0


def _rc_mask(m: int) -> int:
    r = 0
    if m & 1:
        r |= 8
    if m & 2:
        r |= 4
    if m & 4:
        r |= 2
    if m & 8:
        r |= 1
    return r


@partial(jax.jit, static_argnames=("pam_spec",))
def annotate_genome_pam(genome, *, pam_spec):
    """One-time per-contig PAM-gate annotation: returns the staged mask
    array with bit 4 = PAM-ok chain-A END at this position and bit 5 =
    PAM-ok chain-B START after it, in a single fused pass over the
    contig: some PAM (some revcomp'd PAM) fits with <= max_mm
    mismatches at one of the gap offsets after (before) the position.

    Window edges see the real neighboring genome instead of treating
    out-of-window bases as mismatches, so the gate is a conservative
    superset of a window-local one (resolved by the exact host
    alignment); it flags every window with actual hits, which is the
    correctness contract (tests/test_screen.py::TestPamGate).

    Chunked like :func:`_encode_staged`.  Zero padding annotates to
    gate-closed (a zero mask mismatches every PAM base), matching the
    window-local planes' treatment of beyond-contig windows."""
    pams, max_mm, max_gap = pam_spec
    L = genome.shape[0]
    pad = max(len(p) for p in pams) + max_gap + 2
    gp = jnp.concatenate(
        [jnp.zeros(pad, jnp.uint8), genome, jnp.zeros(pad, jnp.uint8)]
    )
    C = min(_ENCODE_CHUNK, L)
    n_chunks = L // C  # exact for staged arrays (power-of-two lengths)

    def block(base0):
        base = base0 + pad  # gp index of genome position base0
        ext = C + max_gap
        end = jnp.zeros(C, jnp.bool_)
        start = jnp.zeros(C, jnp.bool_)
        for pam in pams:
            plen = len(pam)
            rc_pam = tuple(_rc_mask(m) for m in reversed(pam))
            # fit_e[t] = PAM fits (<= max_mm mismatches) at genome
            # positions starting j0+1+t; fit_s[t] = revcomp'd PAM fits
            # starting j0 - max_gap - plen + 1 + t.
            mm_e = jnp.zeros(ext, jnp.int32)
            mm_s = jnp.zeros(ext, jnp.int32)
            for k in range(plen):
                se = jax.lax.dynamic_slice(gp, (base + 1 + k,), (ext,))
                mm_e = mm_e + ((se & jnp.uint8(pam[k])) == 0)
                ss = jax.lax.dynamic_slice(
                    gp, (base - max_gap - plen + 1 + k,), (ext,)
                )
                mm_s = mm_s + ((ss & jnp.uint8(rc_pam[k])) == 0)
            fe = mm_e <= max_mm
            fs = mm_s <= max_mm
            for o in range(max_gap + 1):
                # end_ok[j] = OR_o fit_e[j+1+o]; start_ok[j] =
                # OR_o fit_s[j-o-plen+1] (gap-offset max-pools)
                end = end | jax.lax.slice(fe, (o,), (o + C,))
                start = start | jax.lax.slice(
                    fs, (max_gap - o,), (max_gap - o + C,)
                )
        g = jax.lax.dynamic_slice(gp, (base,), (C,))
        return (
            g
            | (end.astype(jnp.uint8) << 4)
            | (start.astype(jnp.uint8) << 5)
        )

    if L == C:
        return block(0)

    def body(i, out):
        return jax.lax.dynamic_update_slice(out, block(i * C), (i * C,))

    out = jax.lax.fori_loop(0, n_chunks, body, jnp.zeros(L, jnp.uint8))
    if L % C:
        # Ragged tail (non-power-of-two caller arrays): recompute the
        # last C positions anchored at the end — the overlapped span
        # gets identical values, so the double write is a no-op.
        out = jax.lax.dynamic_update_slice(out, block(L - C), (L - C,))
    return out


def _xla_screen_multi(qvals, wins, lengths, min_scores, *, G, pam_gate,
                      emit_ranges, match, mismatch, qgap, tgap):
    """The XLA-scan form of :func:`dp_kernel.screen_multi` on unpacked
    windows: per guide and chain one gated scan.  Returns ([G, 2, B]
    maxima, [G, 2, 2, B] ranges or None)."""
    from calitas_tpu.ops.dp_screen import _screen_scores, _screen_scores_ranges

    skw = dict(match=match, mismatch=mismatch, qgap=qgap, tgap=tgap)
    gates = ("end", "start") if pam_gate else (None, None)
    best, rng = [], []
    for g in range(G):
        per_chain = []
        for c in range(2):
            q = qvals[g, c].astype(jnp.uint8)
            if emit_ranges:
                b, mn, mx = _screen_scores_ranges(
                    q, wins, lengths, min_scores[g], gate=gates[c], **skw
                )
                per_chain.append(b)
                rng.append(jnp.stack([mn, mx]))
            else:
                per_chain.append(
                    _screen_scores(q, wins, lengths, gate=gates[c], **skw)
                )
        best.append(jnp.stack(per_chain))
    best = jnp.stack(best)
    if not emit_ranges:
        return best, None
    return best, jnp.stack(rng).reshape(G, 2, 2, -1)


def _screen_batch(qvals, wins, lengths, min_scores, *, G, Q, use_kernel,
                  pam_gate, emit_ranges, interpret, **scores):
    """One window batch through the kernel or the XLA scan: ([G, 2, B]
    maxima, [G, 2, 2, B] ranges or None).  The kernel ignores ``lengths``
    (every window it screens is full length, or zero-padded — padding only
    adds candidate end columns, which the exact host finish resolves)."""
    if use_kernel:
        res = dp_kernel.screen_multi(
            qvals, dp_kernel.pack_tcols(wins), min_scores, T=wins.shape[1],
            Q=Q, pam_gate=pam_gate, emit_ranges=emit_ranges,
            interpret=interpret, **scores,
        )
        return (res[0], res[1]) if emit_ranges else (res, None)
    return _xla_screen_multi(
        qvals, wins, lengths, min_scores, G=G, pam_gate=pam_gate,
        emit_ranges=emit_ranges, **scores,
    )


def _screen_grid_multi(
    genome,
    qvals,  # [G, 2, Q] int32: chain A / chain B query masks per guide
    n_batches,  # traced scalar: actual batches to run (<= max_batches)
    min_scores,  # [G] int32: per-guide candidate thresholds
    base0,  # traced int32: genome offset of this grid's first window —
    #         0 on a single device; each mesh shard passes its span start
    *,
    window: int,
    step: int,
    batch_windows: int,
    max_batches: int,
    Q: int,
    G: int,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
    use_kernel: bool,
    pam_gate: bool = False,  # genome carries the gate bits 4/5
    interpret: bool = False,
):
    """The device batch loop shared by the single-device and mesh-sharded
    screens: extract windows, screen both chains of every guide, threshold
    + bit-pack on device.  Returns ([G, 2, total//8] uint8 flags,
    [G, 2, total, 2] uint8 coarse ranges)."""
    lens_flat = jnp.full((batch_windows,), window, jnp.int32)
    n_total = max_batches * batch_windows

    def body(b, outs):
        out, out_r = outs
        wins = extract_window_grid(
            genome, base0 + b * batch_windows * step, batch_windows, step,
            window,
        )  # [bw, T] uint8
        best, rng = _screen_batch(
            qvals, wins, lens_flat, min_scores, G=G, Q=Q,
            use_kernel=use_kernel, pam_gate=pam_gate, emit_ranges=True,
            interpret=interpret, match=match, mismatch=mismatch, qgap=qgap,
            tgap=tgap,
        )
        # Threshold + bit-pack on device: the host only ever needs the
        # per-chain candidate flags, 32x smaller than int32 maxima.
        packed = _pack_flag_bits(best >= min_scores[:, None, None])
        out = jax.lax.dynamic_update_slice(
            out, packed, (0, 0, b * (batch_windows // 8))
        )
        # Coarse block-granular uint8 ranges: 4 bytes per window; the host
        # widens each block edge back out, so coarseness only costs
        # < range_block(window) extra DP columns per side.
        rb = range_block(window)
        mn, mx = rng[:, :, 0], rng[:, :, 1]
        mnb = jnp.clip((mn - 1) // rb, 0, 255).astype(jnp.uint8)
        mxb = jnp.clip((mx - 1) // rb, 0, 255).astype(jnp.uint8)
        pr = jnp.stack([mnb, mxb], axis=-1)  # [G, 2, bw, 2]
        out_r = jax.lax.dynamic_update_slice(
            out_r, pr, (0, 0, b * batch_windows, 0)
        )
        return out, out_r

    out0 = jnp.zeros((G, 2, n_total // 8), jnp.uint8)
    out_r0 = jnp.zeros((G, 2, n_total, 2), jnp.uint8)
    return jax.lax.fori_loop(0, n_batches, body, (out0, out_r0))


_GRID_STATICS = (
    "window", "step", "batch_windows", "max_batches", "Q", "G", "match",
    "mismatch", "qgap", "tgap", "use_kernel", "pam_gate", "interpret",
)


@partial(jax.jit, static_argnames=_GRID_STATICS)
def _screen_genome_span(genome, qvals, n_batches, min_scores, base0, **kw):
    """A window-span slice of the contig screen (traced ``base0`` genome
    offset): the segmented screen dispatches several of these back to
    back so the host can finish segment N's candidates while the device
    screens segment N+1."""
    return _screen_grid_multi(genome, qvals, n_batches, min_scores, base0, **kw)


def _qvals(dp_queries) -> jax.Array:
    """[(dp_query, dp_query_rc), ...] -> [G, 2, Q] int32 query masks."""
    return jnp.asarray(
        np.stack(
            [
                np.stack([encode_query(q), encode_query(qrc)]).astype(np.int32)
                for q, qrc in dp_queries
            ]
        )
    )


def _copy_to_host_async(*arrays) -> None:
    """Start the (tiny) D2H copies as soon as the compute finishes, so a
    resolver only waits instead of paying a serialized round trip."""
    for a in arrays:
        a.copy_to_host_async()


class GenomeScreen:
    """Per-contig device screen: stage once, screen every window layout."""

    def __init__(
        self,
        scorer: Scorer,
        window: int = 1024,
        batch_windows: int = BATCH_WINDOWS,
        use_kernel: bool | None = None,
        interpret: bool = False,
        pack_staging: bool | None = None,
    ):
        self.scorer = scorer
        self.window = window
        self.batch_windows = batch_windows
        if use_kernel is None:
            use_kernel = default_device_platform() == "gpu"
        self.use_kernel = use_kernel
        #: Pallas interpreter for the kernel (CPU tests only)
        self.interpret = interpret
        #: None = decide from a one-time link-rate probe at first stage()
        self.pack_staging = pack_staging

    def _scores(self) -> dict:
        s = self.scorer
        return dict(
            match=s.match_score, mismatch=s.mismatch_score,
            qgap=s.query_gap_score, tgap=s.target_gap_score,
        )

    def _should_pack(self) -> bool:
        if self.pack_staging is None:
            self.pack_staging = _packing_pays()
        return self.pack_staging

    def _annotate(self, genome_dev, static_pam_spec):
        """Gate-annotated form of the genome for this pam_spec: one fused
        device pass over the contig per screen call; deliberately not
        cached (an id-keyed cache would pin staged contigs in device
        memory past their lifetime)."""
        return annotate_genome_pam(genome_dev, pam_spec=static_pam_spec)

    def _staging_host_array(self, contig_bases: np.ndarray):
        """Host array + device decoder for staging a contig: raw bytes
        with an on-device encode, or (on slow links) host-encoded masks
        nibble-packed two per byte with an on-device unpack.  Both decode
        to the identical zero-padded mask array."""
        padded_len = 1 << (len(contig_bases) + self.window - 1).bit_length()
        if self._should_pack():
            return _pack_staging_nibbles(contig_bases, padded_len), _unpack_staged
        host = np.zeros(padded_len, np.uint8)  # zero pad -> mask 0
        host[: len(contig_bases)] = contig_bases
        return host, _encode_staged

    def stage(self, contig_bases: np.ndarray) -> jax.Array:
        """Upload a contig (raw bytes) as a zero-padded device mask array."""
        host, decode = self._staging_host_array(contig_bases)
        return decode(jax.device_put(host))

    def window_starts(self, contig_len: int, step: int) -> np.ndarray:
        """The reference's window starts: range(0, len-1, step)
        (SearchReference.scala:52)."""
        return np.arange(0, max(contig_len - 1, 0), step, dtype=np.int64)

    #: per-dispatch extraction footprint budget (window-bytes): wide
    #: windows shrink the batch instead of inflating the [bw, window]
    #: device intermediates (the default 65536 x 1024 layout is exactly
    #: at budget; -w 16384 screens 4096 windows per dispatch).
    BATCH_ELEM_BUDGET = 64 << 20

    def _batch_windows_for(self, n: int, unit: int) -> int:
        """Windows per device dispatch: the configured batch rounded up
        to the kernel unit, trimmed to the window count, and capped so
        batch * window stays within BATCH_ELEM_BUDGET (never below one
        unit)."""
        cap = max(
            unit,
            (self.BATCH_ELEM_BUDGET // max(self.window, 1)) // unit * unit,
        )
        bw = min(-(-self.batch_windows // unit) * unit, -(-n // unit) * unit)
        return min(bw, cap)

    @staticmethod
    def _empty_result(return_chains: bool, return_ranges: bool):
        """Zero-window results shaped per the requested interface."""
        chains = np.zeros((2, 0), dtype=bool)
        if return_ranges:
            return chains, np.zeros((2, 0, 2), dtype=np.uint8)
        if return_chains:
            return chains
        return np.zeros(0, dtype=bool)

    def screen_contig(
        self,
        genome_dev: jax.Array,
        contig_len: int,
        step: int,
        dp_query: str,
        dp_query_rc: str,
        min_score: int,
        pam_spec=None,  # (dp-orientation pam strings, max_pam_mm, max_gap)
        return_chains: bool = False,
        return_ranges: bool = False,
    ) -> np.ndarray:
        """Returns the boolean hit flags for every reference window start.

        ``dp_query``/``dp_query_rc`` are the two DP queries (the guide in
        search orientation and its revcomp).  A True flag means some end
        column in [start, start+window) reaches ``min_score`` on either
        strand — a conservative superset of the reference's per-window
        hits (zero-padding, untrimmed Ns and the relaxed staged PAM gate
        can only add candidates, which the exact host alignment then
        resolves).

        With ``return_ranges`` (implies per-chain flags) also returns a
        [2, n, 2] uint8 array of coarse per-chain qualifying end-column
        ranges: entry (c, i) = (min_block, max_block) in blocks of
        ``rb = range_block(self.window)`` columns (8 up to 2048-column
        windows, doubling beyond), i.e. qualifying 1-based end columns
        of window i on chain c all lie within
        [min_block*rb + 1, (max_block+1)*rb].  Only meaningful where the
        chain flag is set.
        """
        segs = self.screen_contig_async(
            genome_dev, contig_len, step, dp_query, dp_query_rc, min_score,
            pam_spec=pam_spec, segments=1,
        )
        if not segs:
            return self._empty_result(return_chains, return_ranges)
        [(_i0, _n, resolve)] = segs
        chain_flags, ranges = resolve()
        if return_ranges:
            return chain_flags, ranges
        if return_chains:
            return chain_flags
        return chain_flags.any(axis=0)

    #: segments per contig for the pipelined screen (screen_contig_async);
    #: each segment is its own device dispatch, so the host finishes
    #: segment N's candidates while the device screens segment N+1
    SEGMENTS = 16
    #: below this many window batches segmentation can't amortize its
    #: extra dispatches — fall back to one span
    MIN_BATCHES_PER_SEGMENT = 4

    def screen_contig_async(
        self,
        genome_dev: jax.Array,
        contig_len: int,
        step: int,
        dp_query: str,
        dp_query_rc: str,
        min_score: int,
        pam_spec=None,
        segments: int | None = None,
    ) -> list:
        """The pipelined form of :meth:`screen_contig` (always per-chain
        flags + coarse ranges): dispatches the contig's window grid as
        several independent spans — all enqueued immediately, executed
        back to back by the device — and returns a list of
        ``(start_index, n_windows, resolve)`` triples in window order.
        ``resolve()`` blocks on that span's (tiny, bit-packed) readback
        and returns ``(chain_flags, ranges)`` for windows
        ``[start_index, start_index + n_windows)``.  The single-guide
        case of :meth:`screen_contig_multi_async`."""
        segs = self.screen_contig_multi_async(
            genome_dev, contig_len, step, [(dp_query, dp_query_rc)],
            [min_score], pam_spec=pam_spec, segments=segments,
        )
        return [
            (i0, n, lambda r=r: tuple(x[0] for x in r())) for i0, n, r in segs
        ]

    def _prepare(self, genome_dev, n: int, Q: int, pam_spec):
        """Per-screen set-up shared by the single-device and sharded
        screens: (kernel choice, batch windows, batch count, gate spec,
        gate-annotated genome)."""
        use_kernel = kernel_for(self.use_kernel, Q)
        bw = self._batch_windows_for(n, BLOCK_W)
        static_pam_spec = _static_pam_spec(pam_spec)
        if static_pam_spec is not None:
            genome_dev = self._annotate(genome_dev, static_pam_spec)
        return use_kernel, bw, -(-n // bw), static_pam_spec, genome_dev

    def _segments(self, segments, n_batches: int, n_dev: int = 1) -> int:
        if segments is None:
            # Below a few batches per segment the extra dispatches can't
            # amortize; explicit requests skip this heuristic.
            segments = max(
                1,
                min(
                    self.SEGMENTS,
                    n_batches // (self.MIN_BATCHES_PER_SEGMENT * n_dev),
                ),
            )
        return max(1, min(segments, n_batches))

    def screen_contig_multi_async(
        self,
        genome_dev: jax.Array,
        contig_len: int,
        step: int,
        dp_queries: list,  # [(dp_query, dp_query_rc), ...] all same length
        min_scores: list,  # [G] per-guide qualifying thresholds
        pam_spec=None,  # shared (dp-orientation pams, max_pam_mm, max_gap)
        segments: int | None = None,
    ) -> list:
        """The segmented screen of a same-length guide group — the full
        single-guide contract per guide (PAM gate, per-chain flags, coarse
        end-column ranges), with the window blocks extracted and laid out
        once per batch for the whole group.

        Guides must share a length and (when given) a PAM spec — the
        gate bits live in the shared genome annotation.  Returns
        ``(start_index, n_windows, resolve)`` triples; ``resolve()`` ->
        ``(chain_flags [G, 2, n_seg] bool, ranges [G, 2, n_seg, 2]
        uint8)``."""
        n = len(self.window_starts(contig_len, step))
        G = len(dp_queries)
        if n == 0 or G == 0:
            return []
        Q = len(dp_queries[0][0])
        use_kernel, bw, n_batches, static_pam_spec, genome_dev = self._prepare(
            genome_dev, n, Q, pam_spec
        )
        segments = self._segments(segments, n_batches)
        bps = -(-n_batches // segments)  # batches per segment
        segments = -(-n_batches // bps)
        # One static shape for every segment (and every contig at this
        # batch-count bucket): one compilation.
        max_batches = 1 << (bps - 1).bit_length()
        last_base = (segments - 1) * bps * bw * step
        need = last_base + (max_batches * bw - 1) * step + self.window + step
        genome_dev = _pad_genome(genome_dev, need)
        qvals = _qvals(dp_queries)
        ms = jnp.asarray(np.asarray(min_scores, dtype=np.int32))
        out = []
        for seg in range(segments):
            b0 = seg * bps
            nb = min(bps, n_batches - b0)
            i0 = b0 * bw
            n_seg = min(n - i0, bps * bw)
            packed, packed_ranges = _screen_genome_span(
                genome_dev, qvals, jnp.int32(nb), ms,
                jnp.int32(b0 * bw * step),
                window=self.window, step=step, batch_windows=bw,
                max_batches=max_batches, Q=Q, G=G, use_kernel=use_kernel,
                pam_gate=static_pam_spec is not None,
                interpret=self.interpret, **self._scores(),
            )
            _copy_to_host_async(packed, packed_ranges)
            out.append((i0, n_seg, _segment_resolver(packed, packed_ranges, n_seg)))
        return out


def _segment_resolver(packed, packed_ranges, n_seg: int):
    """Zero-arg resolver of one segment's readback; ``resolve.arrays``
    keeps the device arrays (their sharding shows where the screen ran)."""
    def resolve():
        chain_flags = _unpack_flag_bits(np.asarray(packed), n_seg)
        ranges = np.asarray(packed_ranges)[:, :, :n_seg]
        return chain_flags, ranges

    resolve.arrays = (packed, packed_ranges)
    return resolve


# ---------------------------------------------------------------------------
# Multi-device sharding
# ---------------------------------------------------------------------------

def make_sharded_grid_screen(mesh, **kw):
    """Jit a mesh-sharded :func:`_screen_grid_multi`: each device owns a
    contiguous span of ``max_batches`` window batches (its ``base0``) and
    runs the SAME device batch loop as the single-device screen — window
    extraction, kernel, PAM gate, device thresholding, bit-packed flag and
    coarse range output.  The genome is replicated; the window axis is the
    data-parallel axis (SURVEY.md §2.10), so shards are independent and
    the gathered per-guide flags are bit-identical to single-device
    execution."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def local(genome, base0, n_batches, min_scores, qvals):
        return _screen_grid_multi(
            genome, qvals, n_batches[0], min_scores, base0[0], **kw
        )

    shard = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=(P(None, None, axis), P(None, None, axis, None)),
        check_vma=False,
    )
    return jax.jit(shard)


class ShardedGenomeScreen(GenomeScreen):
    """GenomeScreen over a device mesh: the window-batch grid is split
    into contiguous per-device spans; the genome is replicated.  Same
    interface and bit-identical output as :class:`GenomeScreen`
    (PAM gate, per-chain flags, packed D2H, end-column ranges included —
    enforced by tests/test_sharding.py)."""

    def __init__(self, scorer: Scorer, mesh, window: int = 1024,
                 batch_windows: int = BATCH_WINDOWS,
                 use_kernel: bool | None = None, interpret: bool = False,
                 pack_staging: bool | None = None):
        super().__init__(scorer, window=window, batch_windows=batch_windows,
                         use_kernel=use_kernel, interpret=interpret,
                         pack_staging=pack_staging)
        self.mesh = mesh
        self._fn_cache = {}
        self._replicated = None

    def _sharding(self):
        from jax.sharding import NamedSharding, PartitionSpec as P

        if self._replicated is None:
            self._replicated = NamedSharding(self.mesh, P())
        return self._replicated

    def stage(self, contig_bases: np.ndarray):
        """Upload the contig replicated to every mesh device, with the
        same transport as the single-device path."""
        host, decode = self._staging_host_array(contig_bases)
        out = decode(jax.device_put(host, self._sharding()))
        assert out.sharding.is_fully_replicated
        return out

    def _annotate(self, genome_dev, static_pam_spec):
        # Pin the annotation replicated on the mesh (elementwise on a
        # replicated input would stay replicated anyway; the explicit
        # out_sharding makes it structural).
        key = ("anno_fn", static_pam_spec)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = jax.jit(
                partial(annotate_genome_pam, pam_spec=static_pam_spec),
                out_shardings=self._sharding(),
            )
            self._fn_cache[key] = fn
        return fn(genome_dev)

    def _pad_replicated(self, genome_dev, need: int):
        extra = need - genome_dev.shape[0]
        fn = self._fn_cache.get("pad")
        if fn is None:
            fn = jax.jit(
                lambda g, z: jnp.concatenate([g, z]),
                out_shardings=self._sharding(),
            )
            self._fn_cache["pad"] = fn
        zeros = jax.device_put(
            jnp.zeros(extra, jnp.uint8), self._sharding()
        )
        return fn(genome_dev, zeros)

    def screen_contig_multi_async(
        self,
        genome_dev,
        contig_len: int,
        step: int,
        dp_queries: list,
        min_scores: list,
        pam_spec=None,
        segments: int | None = None,
    ) -> list:
        """Mesh-sharded segmented screen: same interface and per-guide
        bit-identical semantics as the single-device
        :meth:`GenomeScreen.screen_contig_multi_async`.  Each segment
        covers exactly ``n_dev * batches_per_dev`` batches (live-clipped
        at the tail), so per-device spans stay globally contiguous and the
        packed flags concatenate in window order; one compiled per-device
        span serves every segment."""
        n = len(self.window_starts(contig_len, step))
        G = len(dp_queries)
        if n == 0 or G == 0:
            return []
        n_dev = self.mesh.devices.size
        Q = len(dp_queries[0][0])
        use_kernel, bw, batches_total, static_pam_spec, genome_dev = (
            self._prepare(genome_dev, n, Q, pam_spec)
        )
        segments = self._segments(segments, batches_total, n_dev)
        batches_per_dev = 1 << (
            -(-batches_total // (segments * n_dev)) - 1
        ).bit_length()
        seg_batches = n_dev * batches_per_dev
        segments = -(-batches_total // seg_batches)
        need = (batches_total * bw + bw - 1) * step + self.window + step
        if need > genome_dev.shape[0]:
            need = 1 << (need - 1).bit_length()
            genome_dev = self._pad_replicated(genome_dev, need)
        key = (Q, G, step, bw, batches_per_dev, static_pam_spec, use_kernel)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = make_sharded_grid_screen(
                self.mesh, window=self.window, step=step, batch_windows=bw,
                max_batches=batches_per_dev, Q=Q, G=G, use_kernel=use_kernel,
                pam_gate=static_pam_spec is not None,
                interpret=self.interpret, **self._scores(),
            )
            self._fn_cache[key] = fn
        qvals = _qvals(dp_queries)
        ms = jnp.asarray(np.asarray(min_scores, dtype=np.int32))
        out = []
        for seg in range(segments):
            b0 = seg * seg_batches
            base0 = (
                (b0 + np.arange(n_dev) * batches_per_dev) * (bw * step)
            ).astype(np.int32)
            # Tail shards run only their populated batches (skipped
            # batches leave zero flags).
            live = np.clip(
                batches_total - b0 - np.arange(n_dev) * batches_per_dev,
                0, batches_per_dev,
            ).astype(np.int32)
            packed, packed_ranges = fn(
                genome_dev, jnp.asarray(base0), jnp.asarray(live), ms, qvals,
            )
            _copy_to_host_async(packed, packed_ranges)
            i0 = b0 * bw
            n_seg = min(n - i0, seg_batches * bw)
            out.append((i0, n_seg, _segment_resolver(packed, packed_ranges, n_seg)))
        return out


def screen_contig_multi(
    screen: GenomeScreen,
    genome_dev,
    contig_len: int,
    step: int,
    dp_queries: list,  # [(dp_query, dp_query_rc), ...] all same length
    min_scores: list,
) -> np.ndarray:
    """Per-chain boolean hit flags [G, 2, n_windows] for a same-length
    guide group (chain 0 = DP query over the forward genome, 1 = its
    revcomp), ungated, in one span."""
    segs = screen.screen_contig_multi_async(
        genome_dev, contig_len, step, dp_queries, min_scores, segments=1
    )
    if not segs:
        return np.zeros((len(dp_queries), 2, 0), dtype=bool)
    return segs[0][2]()[0]


# ---------------------------------------------------------------------------
# Slot batches (variant windows): explicit [B, T] batches
# ---------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=(
        "Q", "G", "match", "mismatch", "qgap", "tgap", "use_kernel",
        "interpret",
    ),
)
def _slot_flags_multi(
    qvals,  # [G, 2, Q] int32: chain A and chain B query masks per guide
    tmasks,  # [B, T] uint8 slot batch (zero-padded rows/columns)
    lengths,  # [B] int32 valid slot lengths
    min_scores,  # [G] int32 per-guide candidate thresholds
    *,
    Q: int,
    G: int,
    match: int,
    mismatch: int,
    qgap: int,
    tgap: int,
    use_kernel: bool,
    interpret: bool = False,
):
    """Candidate flags for G same-length guides over one slot batch in a
    single dispatch: per-guide dual-chain screen, device thresholding,
    bit-packed [G, B//8] uint8 output.  The kernel ignores ``lengths`` —
    zero padding only adds candidate end columns, so its flags are a
    conservative superset, which the exact host alignment then
    resolves."""
    best, _ = _screen_batch(
        qvals, tmasks, lengths, min_scores, G=G, Q=Q, use_kernel=use_kernel,
        pam_gate=False, emit_ranges=False, interpret=interpret, match=match,
        mismatch=mismatch, qgap=qgap, tgap=tgap,
    )
    flags = (best >= min_scores[:, None, None]).any(axis=1)  # [G, B]
    return _pack_flag_bits(flags)


@jax.jit
def _unpack_slot_nibbles(packed):
    """[B, T/2] uint8 nibble pairs -> [B, T] uint8 4-bit masks on device
    (column 2i = low nibble of byte i, 2i+1 = high nibble)."""
    B = packed.shape[0]
    return jnp.stack(
        [packed & jnp.uint8(15), packed >> 4], axis=-1
    ).reshape(B, -1)


#: (mesh, Q, G, scores..., use_kernel, interpret) -> jitted shard_map'd
#: slot screen (jax.sharding.Mesh is hashable)
_SHARDED_SLOT_FN_CACHE: dict = {}


def make_sharded_slot_flags(mesh, **kw):
    """Jit a mesh-sharded :func:`_slot_flags_multi`: the slot-batch axis
    is data-parallel across the mesh (each device screens its own span
    of rows for every guide in the group, exactly like the single-device
    dispatch), queries replicated, bit-packed per-shard flags gathered
    in row order — so the unpacked flags are bit-identical to
    single-device execution.  This is the variant pass's multi-device
    screen (SURVEY.md §2.10; variant windows share the reference pass's
    pool in SearchReference.scala:582)."""
    from jax.sharding import PartitionSpec as P

    axis = mesh.axis_names[0]

    def local(qvals, tmasks, lengths, min_scores):
        return _slot_flags_multi(qvals, tmasks, lengths, min_scores, **kw)

    shard = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=P(None, axis),
        check_vma=False,
    )
    return jax.jit(shard)


def slot_batch_unit(any_kernel: bool, mesh=None) -> int:
    """Row granularity of one slot batch: whole kernel blocks (or the
    bit-packer's 8) per device, times the mesh size when sharded."""
    unit = BLOCK_W if any_kernel else 8
    if mesh is not None:
        unit *= mesh.devices.size
    return unit


def screen_slots_multi(
    scorer: Scorer,
    tmasks: np.ndarray,  # [B, T] uint8, B a multiple of slot_batch_unit()
    lengths: np.ndarray,  # [B] valid slot lengths
    groups,  # [(use_kernel, qvals [G,2,Q] int32, min_scores [G]), ...]
    interpret: bool = False,
    mesh=None,
) -> list:
    """Screen one slot batch for several same-length guide groups: the
    batch uploads once and each group costs one fused dispatch plus one
    bit-packed readback.  Returns one zero-arg resolver per group;
    resolving blocks on that group's (tiny) D2H and returns [G, B] bool
    flags.

    With a ``mesh`` the batch rows shard across the devices
    (:func:`make_sharded_slot_flags`) — B must then be a multiple of
    ``slot_batch_unit(any_kernel, mesh)``; flags are bit-identical to
    the single-device screen.  On slow links the 4-bit masks ship
    nibble-packed and unpack on device, like genome staging."""
    B, T = tmasks.shape
    sharding = None
    if mesh is not None and mesh.devices.size > 1:
        from jax.sharding import NamedSharding, PartitionSpec as P

        sharding = NamedSharding(mesh, P(mesh.axis_names[0]))

    def put(host_arr):
        arr = jnp.asarray(host_arr)
        return jax.device_put(arr, sharding) if sharding is not None else arr

    if T % 2 == 0 and _packing_pays():
        packed = tmasks[:, 0::2] | (tmasks[:, 1::2] << 4)
        tm = _unpack_slot_nibbles(put(packed))
    else:
        tm = put(tmasks)
    ln = put(lengths.astype(np.int32))
    outs = []
    for use_kernel, qvals, min_scores in groups:
        kw = dict(
            Q=int(qvals.shape[2]), G=int(qvals.shape[0]),
            match=scorer.match_score, mismatch=scorer.mismatch_score,
            qgap=scorer.query_gap_score, tgap=scorer.target_gap_score,
            use_kernel=use_kernel, interpret=interpret,
        )
        qv = jnp.asarray(qvals)
        ms = jnp.asarray(np.asarray(min_scores, np.int32))
        if sharding is not None:
            key = (mesh, *sorted(kw.items()))
            fn = _SHARDED_SLOT_FN_CACHE.get(key)
            if fn is None:
                fn = make_sharded_slot_flags(mesh, **kw)
                _SHARDED_SLOT_FN_CACHE[key] = fn
            out = fn(qv, tm, ln, ms)
        else:
            out = _slot_flags_multi(qv, tm, ln, ms, **kw)
        _copy_to_host_async(out)
        outs.append(out)
    return [
        (lambda out=out: _unpack_flag_bits(np.asarray(out), B))
        for out in outs
    ]
