"""Core-layer tests: encoding, cigar, scoring derivation, guide parsing."""

import pytest

from calitas_tpu.core import Guide, Cigar, compatible, derive_scorer, revcomp
from calitas_tpu.core.guide import split_by_case
from calitas_tpu.core.scoring import Defaults, worst_guide_diff_score
from calitas_tpu.core.sequence import revcomp_padded


class TestSequence:
    def test_compatible_basics(self):
        assert compatible("A", "A")
        assert compatible("a", "A")
        assert not compatible("A", "C")
        assert compatible("N", "A")
        assert compatible("R", "A") and compatible("R", "G") and not compatible("R", "C")
        # U behaves as T (SequentialGuideAlignerTest.scala:287-296)
        assert compatible("U", "T") and compatible("U", "A") is False
        assert compatible("u", "t")

    def test_revcomp(self):
        assert revcomp("ACGT") == "ACGT"
        assert revcomp("AACC") == "GGTT"
        assert revcomp("acgtn") == "nacgt"
        assert revcomp("ARY") == "RYT"  # comp(R)=Y, comp(Y)=R
        assert revcomp("AACCGGTTACGTnrg") == "cynACGTAACCGGTT"

    def test_revcomp_padded_preserves_dashes(self):
        # SequentialGuideAligner.scala:527-536
        assert revcomp_padded("AC-GT") == "AC-GT"
        assert revcomp_padded("AA--CC") == "GG--TT"


class TestCigar:
    def test_parse_and_str(self):
        c = Cigar("14=1X1=")
        assert str(c) == "14=1X1="
        assert c.length_on_query == 16
        assert c.length_on_target == 16

    def test_lengths(self):
        c = Cigar("6M3D4M2I9M")
        assert c.length_on_query == 6 + 4 + 2 + 9
        assert c.length_on_target == 6 + 3 + 4 + 9

    def test_coalesce(self):
        from calitas_tpu.core.cigar import CigarElem

        c = Cigar([CigarElem("=", 2), CigarElem("=", 3), CigarElem("X", 1)])
        assert str(c.coalesce()) == "5=1X"

    def test_reverse(self):
        assert str(Cigar("3=1D2=").reverse()) == "2=1D3="

    def test_diff_bases(self):
        assert Cigar("14=1X1=").diff_bases() == 1
        assert Cigar("6=3D4=2I9=").diff_bases() == 5

    @pytest.mark.parametrize("parsed", [False, True])
    def test_lazy_cigar_pickles(self, parsed):
        # worker processes ship LazyCigars back to the parent, parsed or not
        import pickle

        from calitas_tpu.core.cigar import LazyCigar

        c = LazyCigar("6=3D4=2I9=")
        if parsed:
            assert c.diff_bases() == 5
        back = pickle.loads(pickle.dumps(c))
        assert str(back) == "6=3D4=2I9=" and back == c


class TestScoring:
    def test_default_derivation(self):
        # SURVEY.md §2.2 table (SequentialGuideAligner.scala:192-208)
        s = derive_scorer()
        assert s.match_score == 60
        assert s.mismatch_score == -60
        assert s.query_gap_score == -121
        assert s.target_gap_score == -62
        assert s.pam_match_score == 130
        assert s.pam_mismatch_score == -130

    def test_worst_guide_diff(self):
        assert worst_guide_diff_score() == -122

    def test_pairing_rules(self):
        s = derive_scorer()
        # lowercase query selects PAM scores
        assert s.score_pairing("n", "A") == 130
        assert s.score_pairing("N", "A") == 60
        # target N always mismatch, even vs query n (scala :144)
        assert s.score_pairing("n", "n") == -130
        assert s.score_pairing("A", "N") == -60
        # ambiguity-aware
        assert s.score_pairing("R", "G") == 60
        assert s.score_pairing("r", "G") == 130
        assert s.score_pairing("U", "T") == 60


class TestGuide:
    def test_split_by_case(self):
        assert split_by_case("AAAttt") == ["AAA", "ttt"]
        assert split_by_case("tttAAA") == ["ttt", "AAA"]
        assert split_by_case("AAA") == ["AAA"]

    def test_parse_3prime_pam(self):
        g = Guide.parse("ACGTacgt")
        assert g.guide == "ACGT"
        assert g.pams_3prime == ("acgt",)
        assert g.pam_is_3prime and not g.pam_is_5prime
        assert g.protospacer_length == 4
        assert g.pam_length == 4
        assert g.length == 8

    def test_parse_5prime_pam(self):
        g = Guide.parse("tttvAACC")
        assert g.guide == "AACC"
        assert g.pams_5prime == ("tttv",)
        assert g.pam_is_5prime

    def test_parse_pamless(self):
        g = Guide.parse("ACGTACGT")
        assert g.pams == ()
        assert g.pam_length == 0

    def test_invalid_three_runs(self):
        with pytest.raises(ValueError):
            Guide.parse("AAAtttAAA")

    def test_invalid_all_lower(self):
        with pytest.raises(ValueError):
            Guide.parse("aaaa")

    def test_aux_pams(self):
        g = Guide.parse("ACGTnrg", aux_pams=["nnrg", "kgg"])
        assert g.pams_3prime == ("nrg", "nnrg", "kgg")
        assert g.pam_length == 4
        assert g.length == 8

    def test_aux_pams_require_primary(self):
        with pytest.raises(ValueError):
            Guide.parse("ACGT", aux_pams=["nrg"])

    def test_aux_pams_must_be_lower(self):
        with pytest.raises(ValueError):
            Guide.parse("ACGTnrg", aux_pams=["NRG"])

    def test_both_ends_invalid(self):
        with pytest.raises(ValueError):
            Guide.of("ACGT", pams_3prime=["nrg"], pams_5prime=["ttn"])

    def test_rc_views(self):
        g = Guide.parse("AACCnrg")
        assert g.guide_rc == "GGTT"
        assert g.pams_rc == ("cyn",)
