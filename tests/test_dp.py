"""Differential tests: vectorised DP engine vs the scalar oracle, including
masked/banded, sg5, homopolymer and tie-heavy cases."""
import numpy as np
import pytest

from mia.constants import HIM
from mia.core.driver import init_alignment, set_hp_cols, set_hp_rows, set_seq1, set_seq2
from mia.ops import dp_numpy as dp
from mia.ops.pssm import init_flatsubmat
from mia.utils.encoding import pop_hpl_and_hps

from .reference_dp import scalar_dyn_prog

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet)) for _ in range(n))


def _run_both(ref, read, sg5=True, mask=None, hp=False, sm=None):
    sm = init_flatsubmat() if sm is None else sm
    a = init_alignment(256, len(ref) + 16, False, hp)
    a.submat = sm
    set_seq1(a, ref)
    set_seq2(a, read)
    a.sg5 = sg5
    a.sg3 = True
    if mask is not None:
        a.align_mask[: len(ref)] = mask
    if hp:
        set_hp_cols(a)
        set_hp_rows(a)
    dp.dyn_prog(a)

    m = (
        a.align_mask[: a.len1].astype(bool)
        if mask is not None
        else np.ones(a.len1, dtype=bool)
    )
    hp_arrays = None
    seq1 = seq2 = None
    if hp:
        hp_arrays = (a.hpcl, a.hpcs, a.hprl, a.hprs)
        seq1, seq2 = ref, read
    s_ref, t_ref = scalar_dyn_prog(
        list(a.s1c[: a.len1]), list(a.s2c[: a.len2]), sm, m, sg5, seq1, seq2, hp_arrays
    )
    return a, s_ref, t_ref


def _assert_window_equal(a, s_ref, t_ref):
    lo = a.col_off
    w = a.score.shape[1]
    np.testing.assert_array_equal(a.score, s_ref[:, lo : lo + w])
    # trace values in the window are local; globalise positive column traces
    t_local = t_ref[:, lo : lo + w].copy()
    t_local[t_local > 0] -= lo
    np.testing.assert_array_equal(a.trace, t_local)


@pytest.mark.parametrize("seed", range(6))
def test_random_full_width(seed):
    rng = np.random.default_rng(seed)
    ref = _rand_seq(rng, 300)
    read = _rand_seq(rng, rng.integers(10, 120))
    a, s_ref, t_ref = _run_both(ref, read)
    assert a.col_off == 0
    np.testing.assert_array_equal(a.score, s_ref)
    np.testing.assert_array_equal(a.trace, t_ref)


@pytest.mark.parametrize("seed", range(6))
def test_random_masked_band(seed):
    rng = np.random.default_rng(100 + seed)
    ref = _rand_seq(rng, 400)
    start = int(rng.integers(0, 300))
    read = ref[start : start + 60]
    mask = np.zeros(len(ref), dtype=np.uint8)
    lo = max(start - 15, 0)
    mask[lo : start + 90] = 1
    a, s_ref, t_ref = _run_both(ref, read, mask=mask)
    _assert_window_equal(a, s_ref, t_ref)


@pytest.mark.parametrize("seed", range(4))
def test_homopolymer_paths(seed):
    rng = np.random.default_rng(200 + seed)
    # homopolymer-rich sequences to exercise the discount branches
    parts = []
    for _ in range(20):
        parts.append(rng.choice(list("ACGT")) * int(rng.integers(1, 7)))
    ref = "".join(parts)
    s = int(rng.integers(0, max(len(ref) - 50, 1)))
    read = ref[s : s + 40]
    # introduce a homopolymer length change
    read = read.replace("GGG", "GG", 1)
    a, s_ref, t_ref = _run_both(ref, read, hp=True)
    np.testing.assert_array_equal(a.score, s_ref)
    np.testing.assert_array_equal(a.trace, t_ref)


def test_tie_breaking_matches_scalar():
    # repeat-heavy sequences create score ties; the priority chain and the
    # earliest-argmax rules must match the scalar oracle exactly
    ref = "ACAC" * 40
    read = "ACAC" * 10
    a, s_ref, t_ref = _run_both(ref, read)
    np.testing.assert_array_equal(a.score, s_ref)
    np.testing.assert_array_equal(a.trace, t_ref)


def test_fully_masked():
    ref = "ACGTACGTAA"
    read = "ACGT"
    mask = np.zeros(len(ref), dtype=np.uint8)
    sm = init_flatsubmat()
    a = init_alignment(256, len(ref) + 16, False, False)
    a.submat = sm
    set_seq1(a, ref)
    set_seq2(a, read)
    a.sg5 = a.sg3 = True
    a.align_mask[: len(ref)] = mask
    dp.dyn_prog(a)
    best = dp.max_sg_score(a)
    assert best == HIM
    assert a.aec == 0
    dp.find_align_begin(a)
    assert a.abc == 0


def test_no_sg5_local_start():
    rng = np.random.default_rng(7)
    ref = _rand_seq(rng, 200)
    read = _rand_seq(rng, 30)
    a, s_ref, t_ref = _run_both(ref, read, sg5=False)
    np.testing.assert_array_equal(a.score, s_ref)
    np.testing.assert_array_equal(a.trace, t_ref)
