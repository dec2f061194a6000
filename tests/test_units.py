"""Unit/property tests for encodings, PSSM transforms, k-mer index and
consensus decision rules."""
import numpy as np

from mia.constants import FLAT_MATCH, MIN_SCORE_CONS, N_SCORE, NR_SCORE
from mia.ops.consensus import ColumnCounts, find_consensus_cols
from mia.ops.kmer import KmerPosArray, kmer_codes
from mia.ops.pssm import (
    depth_vector,
    find_sm_depth,
    init_flatsubmat,
    revcom_submat,
)
from mia.utils.encoding import (
    compatible,
    encode_seq,
    pop_hpl_and_hps,
    revcom,
    revcom_char,
)


def test_revcom_involution():
    s = "ACGTRYSWKMBDHVN"
    assert revcom(revcom(s)) == s


def test_revcom_chars():
    assert revcom_char("A") == "T"
    assert revcom_char("-") == "-"
    assert revcom_char("R") == "Y"
    assert revcom("ACGT") == "ACGT"  # palindrome
    assert revcom("AAC") == "GTT"


def test_iupac_compat():
    assert compatible("R", "A")
    assert compatible("N", "T")
    assert not compatible("A", "C")
    assert compatible("a", "R")


def test_encode_seq():
    np.testing.assert_array_equal(encode_seq("ACGTN-X"), [0, 1, 2, 3, 4, 4, 4])


def test_homopolymer_arrays():
    hpl, hps = pop_hpl_and_hps("ACCGTGGTAC")
    np.testing.assert_array_equal(hpl, [1, 2, 2, 1, 1, 2, 2, 1, 1, 1])
    np.testing.assert_array_equal(hps, [0, 1, 1, 3, 4, 5, 5, 7, 8, 9])


def test_revcom_submat_involution():
    sm = init_flatsubmat()
    rng = np.random.default_rng(0)
    sm = sm + rng.integers(-50, 50, sm.shape)
    rc = revcom_submat(sm)
    np.testing.assert_array_equal(revcom_submat(rc), sm)


def test_revcom_submat_mapping():
    sm = np.arange(31 * 5 * 5).reshape(31, 5, 5)
    rc = revcom_submat(sm)
    # rc[30-d][A][C] == sm[d][T][G]
    assert rc[30, 0, 1] == sm[0, 3, 2]
    assert rc[0, 4, 0] == sm[30, 4, 3]


def test_depth_vector_matches_scalar():
    for n in (1, 5, 15, 16, 30, 31, 60, 256):
        dv = depth_vector(n)
        for r in range(n):
            assert dv[r] == find_sm_depth(r, n)


def test_flat_submat_values():
    sm = init_flatsubmat()
    assert sm[0, 0, 0] == FLAT_MATCH
    assert sm[15, 0, 1] == -600
    assert sm[30, 2, 4] == N_SCORE
    assert sm[7, 4, 2] == NR_SCORE


def test_kmer_codes():
    codes, valid = kmer_codes("ACGTN", 2)
    assert list(valid) == [True, True, True, False]
    assert codes[0] == 0b0001  # AC
    assert codes[2] == 0b1011  # GT


def test_kmer_index_positions():
    k = KmerPosArray("ACGACGACG", 3)
    np.testing.assert_array_equal(np.sort(k.lookup(int("000110", 2))), [0, 3, 6])  # ACG
    assert len(k.lookup(63)) == 0  # TTT absent


def test_consensus_gap_rule_and_ties():
    cc = ColumnCounts(3)
    # col 0: two gaps of four reads -> 50% -> gap call
    cc.counts[0] = [1, 1, 0, 0, 2]
    cc.cov[0] = 4
    cc.scores[0] = [100, 100, -500, -500]
    # col 1: tie between A and T scores -> later base (T) wins
    cc.counts[1] = [2, 0, 0, 2, 0]
    cc.cov[1] = 4
    cc.scores[1] = [300, -500, -500, 300]
    # col 2: all below MIN_SCORE_CONS -> N
    cc.counts[2] = [1, 0, 0, 0, 0]
    cc.cov[2] = 1
    cc.scores[2] = [MIN_SCORE_CONS - 1] * 4
    chars, frac = find_consensus_cols(cc, 1)
    assert chr(chars[0]) == "-"
    assert chr(chars[1]) == "T"
    assert chr(chars[2]) == "N"


def test_consensus_zero_coverage():
    cc = ColumnCounts(1)
    chars, frac = find_consensus_cols(cc, 1)
    assert chr(chars[0]) == "N" and frac[0] == 0.0
