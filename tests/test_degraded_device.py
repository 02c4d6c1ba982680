"""Device-failure degradation: when staging or the screen throws, the
search must fall back to host alignment of every window for that contig
and still produce the exact table (the screen is a pure accelerator)."""

import numpy as np
import pytest

from calitas_tpu.align.engine import SequentialAligner
from calitas_tpu.core.guide import Guide
from calitas_tpu.io.fasta import ReferenceSetBuilder, IndexedFasta
from calitas_tpu.ops.genome_screen import GenomeScreen
from calitas_tpu.parallel.screen_runner import GuideTask, screened_search
from calitas_tpu.utils import degradations, reset_degradations

KW = dict(
    max_guide_diffs=5, max_pam_diffs=1, max_gaps_between_guide_and_pam=3,
    max_total_diffs=9, max_overlap=10,
)


class StageFails(GenomeScreen):
    def stage(self, bases):
        raise RuntimeError("injected staging failure")


class ScreenFails(GenomeScreen):
    def screen_contig(self, *a, **k):
        raise RuntimeError("injected screen failure")

    def screen_contig_multi_async(self, *a, **k):
        raise RuntimeError("injected screen failure")


@pytest.fixture()
def ref(tmp_path):
    rng = np.random.default_rng(11)
    proto = "GACGCATAAAGATGAGACGC"
    b = ReferenceSetBuilder(assembly="dg")
    for c in ("chr1", "chr2"):
        seq = list("".join(rng.choice(list("ACGT"), 30_000)))
        for k in range(4):
            p = 2000 + k * 6000
            seq[p : p + 23] = list(proto + "TGG")
        b.add(c).add("".join(seq))
    return IndexedFasta(b.to_file(tmp_path / "ref.fa")), Guide.parse(proto + "nrg")


def rows_of(ref, guide, screen):
    fasta, g = ref, guide
    task = GuideTask(guide_id="g", guide=g, guide_length=len(g.guide) + 3,
                     step_size=970)
    hs = dict(ref_path=str(fasta.path), aligner_id="A", arguments="x",
              vcf_id=None, timestamp="t")
    out = []
    # the yielded start is batch-granular progress info, not a row key —
    # rows carry their own coordinates (and the final table sorts anyway)
    for _t, chrom, _start, rows in screened_search(
        fasta, None, [task], SequentialAligner(), window_size=1000,
        threads=1, hit_spec=hs, screen=screen, **KW,
    ):
        for r in rows:
            out.append((chrom, r._line))
    return out


def test_stage_failure_degrades_to_host(ref):
    fasta, guide = ref
    aligner = SequentialAligner()
    good = rows_of(fasta, guide, GenomeScreen(aligner.scorer, window=1000))
    reset_degradations()
    degraded = rows_of(fasta, guide, StageFails(aligner.scorer, window=1000))
    assert degraded == good
    assert len(good) >= 8
    assert degradations() == {"staging": 2}  # one per contig, counted


def test_screen_failure_degrades_to_host(ref):
    fasta, guide = ref
    aligner = SequentialAligner()
    good = rows_of(fasta, guide, GenomeScreen(aligner.scorer, window=1000))
    reset_degradations()
    degraded = rows_of(fasta, guide, ScreenFails(aligner.scorer, window=1000))
    assert degraded == good
    counts = degradations()
    assert counts["contig screen"] == 2 and counts["segmented screen dispatch"] == 2


def test_variant_screen_failure_degrades(monkeypatch):
    """A device failure inside the variant-window screen yields every
    window for every guide (conservative superset) instead of aborting."""
    from dataclasses import dataclass

    from calitas_tpu.ops import genome_screen
    from calitas_tpu.search.variants import screened_variant_windows_multi

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(genome_screen, "screen_slots_multi", boom)
    reset_degradations()
    aligner = SequentialAligner()
    g = Guide.parse("GACGCATAAAGATGAGACGCngg")

    @dataclass
    class W:
        chrom: str
        start: int
        length: int
        bases: np.ndarray

    wins = [
        W("chr1", 1 + i * 50, 60,
          np.frombuffer(b"ACGT" * 15, dtype=np.uint8))
        for i in range(10)
    ]
    out = list(screened_variant_windows_multi(
        iter(wins), aligner, [("g", g, 0)], batch_slots=4,
    ))
    assert [w.start for w, _ in out] == [w.start for w in wins]
    assert all(keys == frozenset({"g"}) for _w, keys in out)
    assert degradations()["variant screen"] == 3  # one per batch of 4


class StageTypeError(GenomeScreen):
    def stage(self, bases):
        raise TypeError("planted bug")


class ScreenRecursion(GenomeScreen):
    def screen_contig(self, *a, **k):
        raise RecursionError("planted bug")

    def screen_contig_async(self, *a, **k):
        raise RecursionError("planted bug")


def test_programming_errors_propagate(ref):
    """Degradation is for device failures only: a programming error
    (TypeError/RecursionError/...) in the screen must crash the search,
    not silently downgrade the contig to 100x-slower host alignment."""
    fasta, guide = ref
    aligner = SequentialAligner()
    with pytest.raises(TypeError):
        rows_of(fasta, guide, StageTypeError(aligner.scorer, window=1000))
    with pytest.raises(RecursionError):
        rows_of(fasta, guide, ScreenRecursion(aligner.scorer, window=1000))


def test_variant_screen_programming_error_propagates(monkeypatch):
    from dataclasses import dataclass

    from calitas_tpu.ops import genome_screen
    from calitas_tpu.search.variants import screened_variant_windows_multi

    def boom(*a, **k):
        raise TypeError("planted bug")

    monkeypatch.setattr(genome_screen, "screen_slots_multi", boom)
    aligner = SequentialAligner()
    g = Guide.parse("GACGCATAAAGATGAGACGCngg")

    @dataclass
    class W:
        chrom: str
        start: int
        length: int
        bases: np.ndarray

    wins = [
        W("chr1", 1 + i * 50, 60,
          np.frombuffer(b"ACGT" * 15, dtype=np.uint8))
        for i in range(10)
    ]
    with pytest.raises(TypeError):
        list(screened_variant_windows_multi(
            iter(wins), aligner, [("g", g, 0)], batch_slots=4,
        ))


def test_degradable_jax_classification():
    """jax-raised runtime failures degrade; jax tracer/concretization
    errors are programming errors and must propagate (a silently
    disabled device screen is a masked 30x slowdown)."""
    import jax
    import jax.numpy as jnp

    from calitas_tpu.utils import degradable

    # runtime-ish: XlaRuntimeError (module jaxlib/jax._src.lib)
    try:
        jax.errors.JaxRuntimeError  # modern alias
        assert degradable(jax.errors.JaxRuntimeError("backend dropped"))
    except AttributeError:
        pass

    # tracer error: raised by jax itself, but a programming error
    tracer_exc = None
    try:
        jax.jit(lambda x: bool(x))(jnp.ones(()))
    except Exception as e:
        tracer_exc = e
    assert tracer_exc is not None
    assert not degradable(tracer_exc)

    # concretization via data-dependent branching
    conc_exc = None
    try:
        jax.jit(lambda x: x[x[0]])(jnp.arange(3))
    except Exception as e:
        conc_exc = e
    if conc_exc is not None and isinstance(
        conc_exc, (jax.errors.JAXTypeError, jax.errors.JAXIndexError)
    ):
        assert not degradable(conc_exc)

    # builtin errors from our own code still classify as before
    assert not degradable(ValueError("shape mismatch"))
    assert degradable(OSError("device reset"))
