"""Resident-genome serving: amortize staging and indexing across searches.

The reference is a batch CLI: every invocation re-reads the genome and
(if given) re-parses the VCF (SearchReference.scala:513-648).  On a GPU the
expensive one-time work is different — uploading contig masks to device
memory and building the in-memory VCF index — and both are reusable across
guides, so a long-lived server process can answer per-guide searches at
warm-search speed.

:class:`ResidentSearcher` holds the staged genome, the screen and the
VCF index; each :meth:`search` call runs the full production
SearchReference (both passes, global dedup, dictionary sort, 34-column
table) and produces a table byte-identical to a fresh CLI run with the
same arguments (modulo ``time_stamp``) — pinned by tests/test_serve.py.

:func:`serve_stdio` wraps it in a line-oriented JSON protocol for use as
a subprocess sidecar; the ``Serve`` CLI sub-command exposes it.
"""

from __future__ import annotations

import json
import logging
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

from calitas_tpu.core.scoring import Defaults
from calitas_tpu.ops.genome_screen import BATCH_WINDOWS

logger = logging.getLogger("calitas_tpu.Serve")


class ResidentSearcher:
    """A SearchReference engine with the genome resident on device.

    Scoring costs, window size and the reference/VCF are fixed at
    construction (they shape the staged masks and the index); per-search
    limits, guides and PAMs are free per request.
    """

    def __init__(
        self,
        ref: str | Path,
        variants: Optional[str | Path] = None,
        *,
        window_size: int = 1000,
        threads: int = 8,
        engine: str = "auto",
        batch_windows: int = BATCH_WINDOWS,
        guide_mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
        pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
        genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
        guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
        contigs: Optional[Sequence[str]] = None,
        stage: bool = True,
    ):
        from calitas_tpu.io.fasta import IndexedFasta, extract_dictionary
        from calitas_tpu.tools.search_reference import _resolve_engine
        from calitas_tpu.utils import degradable, note_degraded

        self.ref = Path(ref)
        self.variants = Path(variants) if variants is not None else None
        self.window_size = window_size
        self.threads = threads
        self.costs = dict(
            guide_mismatch_net_cost=guide_mismatch_net_cost,
            pam_mismatch_net_cost=pam_mismatch_net_cost,
            genome_gap_net_cost=genome_gap_net_cost,
            guide_gap_net_cost=guide_gap_net_cost,
        )
        self.dictionary = extract_dictionary(self.ref)  # required, like the tool
        self._fasta = IndexedFasta(self.ref)
        self.use_device = _resolve_engine(engine)
        self.engine = "device" if self.use_device else "host"

        self._screen = None
        self._staged: dict = {}
        if self.use_device and stage:
            from calitas_tpu.align.engine import SequentialAligner
            from calitas_tpu.ops.genome_screen import GenomeScreen

            scorer = SequentialAligner(
                mismatch_net_cost=guide_mismatch_net_cost,
                pam_mismatch_net_cost=pam_mismatch_net_cost,
                genome_gap_net_cost=genome_gap_net_cost,
                guide_gap_net_cost=guide_gap_net_cost,
            ).scorer
            self._screen = GenomeScreen(
                scorer, window=window_size, batch_windows=batch_windows
            )
            names = list(contigs) if contigs is not None else self._fasta.names
            t0 = time.perf_counter()
            for name in names:
                if (self._fasta.sequence_length(name) or 0) < 2:
                    continue
                try:
                    self._staged[name] = self._screen.stage(
                        self._fasta.get_bases(name)
                    )
                except Exception as ex:
                    # Degrade exactly like the tool: an unstaged contig
                    # falls back to host alignment inside screened_search.
                    if not degradable(ex):
                        raise
                    note_degraded("staging", name)
            logger.info(
                "Staged %d contigs in %.1fs.", len(self._staged),
                time.perf_counter() - t0,
            )

        self._vcf_index = None
        if self.variants is not None:
            from calitas_tpu.io.vcf import VcfIndex

            t0 = time.perf_counter()
            self._vcf_index = VcfIndex(self.variants)
            logger.info(
                "Indexed VCF %s in %.1fs.", self.variants.name,
                time.perf_counter() - t0,
            )

    def warmup(self, guide_length: int = 23) -> None:
        """Absorb the first-request costs at init: spin the worker pool
        and compile every contig's screen shapes by running a throwaway
        whole-genome search with a dummy guide of ``guide_length``
        characters (kernel shapes depend on the guide-string length
        through the window step; 23 = the ubiquitous 20nt+NGG shape).
        Requests for same-length guides then run at warm speed from the
        first one.  Failures are logged and ignored — warmup is purely
        an optimization."""
        import os

        dummy = ("ACGT" * 8)[: guide_length - 3] + "nrg"
        t0 = time.perf_counter()
        try:
            self.search(guide=dummy, guide_id="_warmup", output=os.devnull)
            logger.info("Warmup search in %.1fs.", time.perf_counter() - t0)
        except Exception:
            logger.warning("Warmup search failed; continuing.", exc_info=True)

    def search(
        self,
        guide: Optional[str] = None,
        guide_id: Optional[str] = None,
        *,
        auxiliary_pams: Sequence[str] = (),
        guide_specs=None,
        output: Optional[str | Path] = None,
        chrom: Optional[str] = None,
        max_variants: int = Defaults.MAX_VARIANTS_IN_CLUSTER,
        max_guide_diffs: int = Defaults.MAX_GUIDE_DIFFS,
        max_pam_mismatches: int = Defaults.MAX_PAM_MISMATCHES,
        max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
        max_total_diffs: Optional[int] = None,
        max_overlap: int = Defaults.MAX_OVERLAP,
    ) -> Optional[str]:
        """One full SearchReference run against the resident genome.

        Writes the table to ``output`` when given (returns None);
        otherwise returns the table as a string."""
        from calitas_tpu.tools import search_reference

        def _run(out_path):
            search_reference.run(
                guide=guide, guide_id=guide_id, ref=self.ref,
                auxiliary_pams=auxiliary_pams, guide_specs=guide_specs,
                variants=self.variants, max_variants=max_variants,
                output=out_path, threads=self.threads,
                window_size=self.window_size,
                max_guide_diffs=max_guide_diffs,
                max_pam_mismatches=max_pam_mismatches,
                max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
                max_total_diffs=max_total_diffs, max_overlap=max_overlap,
                chrom=chrom, engine=self.engine, **self.costs,
                _vcf_index=self._vcf_index, _screen=self._screen,
                _prestaged=self._staged or None,
            )

        if output is not None:
            _run(output)
            return None
        with tempfile.NamedTemporaryFile(
            mode="r", suffix=".tsv", delete=False
        ) as fh:
            tmp = Path(fh.name)
        try:
            _run(tmp)
            return tmp.read_text()
        finally:
            tmp.unlink(missing_ok=True)


def serve_stdio(
    searcher: ResidentSearcher, stdin=None, stdout=None
) -> None:
    """Line-oriented JSON request loop.

    Request:  ``{"guide": "...", "guide_id": "...", "output": "path",
    "auxiliary_pams": [...], "chrom": ..., "max_guide_diffs": ..., ...}``
    (any :meth:`ResidentSearcher.search` keyword).  Without ``output``
    the table text is returned inline as ``"table"``.

    Response: ``{"ok": true, "rows": N, "seconds": S, ...}`` or
    ``{"ok": false, "error": "..."}``.  ``{"cmd": "shutdown"}`` exits;
    ``{"cmd": "ping"}`` reports readiness and staged-contig count.
    """
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout

    def reply(obj: dict) -> None:
        stdout.write(json.dumps(obj) + "\n")
        stdout.flush()

    reply({
        "ok": True, "ready": True, "engine": searcher.engine,
        "staged_contigs": len(searcher._staged),
        "vcf": searcher.variants.name if searcher.variants else None,
    })
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as ex:
            reply({"ok": False, "error": f"bad JSON: {ex}"})
            continue
        cmd = req.pop("cmd", None)
        if cmd == "shutdown":
            reply({"ok": True, "bye": True})
            return
        if cmd == "ping":
            reply({"ok": True, "ready": True})
            continue
        # Classify request-shape errors BEFORE calling: an internal
        # TypeError raised deep inside the search must not be reported
        # as the client's fault (and must not be confused with bad kwargs).
        import inspect

        try:
            inspect.signature(searcher.search).bind(**req)
        except TypeError as ex:
            reply({"ok": False, "error": f"bad request: {ex}"})
            continue
        out = req.get("output")
        if out is not None and (not isinstance(out, str) or out == "-"
                                or out.startswith("/dev/")):
            # '-' would dump the TSV into this JSON protocol stream
            reply({"ok": False, "error": "bad request: output must be a "
                                         "regular file path"})
            continue
        t0 = time.perf_counter()
        try:
            table = searcher.search(**req)
            resp = {"ok": True,
                    "seconds": round(time.perf_counter() - t0, 3)}
            if out is not None:
                with open(out) as fh:
                    resp["rows"] = sum(1 for _ in fh) - 1
                resp["output"] = out
            else:
                resp["rows"] = table.count("\n") - 1
                resp["table"] = table
        except Exception as ex:  # noqa: BLE001 — a bad guide must not kill the server
            reply({"ok": False, "error": repr(ex)})
            continue
        reply(resp)
