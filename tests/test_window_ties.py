"""Adversarial property tests for the score-verified window traceback.

The device engine reports (best, aec); the host recomputes the DP restricted
to [lo, aec] with lo = aec - (len2 + slack + 16), slack = (len2*max_sub -
best)//GEP, and accepts iff (best, aec) reproduce and the alignment start
clears the window edge (jax_engine.windowed_exact_dp and
native mia_p1_finish, hostbatch.cc).

Why the accept rule is sound: any path ending at aec with score == best pays
total penalties <= len2*max_sub - best, so its gap columns number at most
slack and its column extent is at most len2 + slack — every cell and every
gap ORIGIN of every co-optimal path lies strictly inside (lo, aec].  Cells on
such paths therefore have identical values windowed and full-width, and the
earliest-tie trace priorities see the same candidate sets, so the windowed
traceback reproduces the full-width traceback exactly — not just its score.

These tests attack that argument with tie-heavy inputs: tandem repeats and
homopolymer-adjacent motifs placed so co-optimal alignment ends and long
co-optimal gap jumps straddle the would-be window edge, then assert the
windowed outputs (strings included) equal the full-width oracle byte-exactly.
"""
from __future__ import annotations

import numpy as np
import pytest

from mia.core.driver import init_alignment, set_seq1, set_seq2
from mia.core.hostbatch import BatchHost
from mia.core.jax_engine import MAX_INTERVALS, WIN_W, windowed_exact_dp
from mia.ops.dp_numpy import populate_pwaln_to_begin, solve_sg
from mia.ops.pssm import init_flatsubmat
from mia.utils.encoding import revcom

_native = (
    __import__("mia.io.native", fromlist=["_load"])._load()
)
pytestmark = pytest.mark.skipif(
    _native is None or not hasattr(_native, "mia_p1_create"),
    reason="native hostbatch not built",
)


def _adversarial_cases(rng):
    """(ref, read) pairs engineered for co-optimal ties near window edges."""
    cases = []
    # tandem repeats: every period-aligned placement is co-optimal
    for period, nrep in (("ACGT", 300), ("ACGTTGCA", 150), ("AT", 500)):
        ref = period * nrep
        for rl in (24, 40, 61):
            read = (period * ((rl // len(period)) + 2))[:rl]
            cases.append((ref, read))
    # repeat with a unique suffix so aec lands just past a tie field
    ref = "ACGT" * 250 + "GGATCCTTAGC" * 3
    cases.append((ref, ("ACGT" * 12)[:37] + "GGATCC"))
    # homopolymer runs abutting the motif: gap origins tie across long runs
    ref = ("A" * 40 + "CGTCA" + "A" * 40 + "CGTCA") * 12
    cases.append((ref, "A" * 20 + "CGTCA" + "A" * 10))
    cases.append((ref, "A" * 35))
    # random low-complexity (2-letter alphabet): dense near-ties
    for seed in range(4):
        r2 = np.random.default_rng(seed)
        ref2 = "".join(np.where(r2.random(1200) < 0.5, "A", "C"))
        p = int(r2.integers(0, 1100))
        cases.append((ref2, ref2[p : p + 50]))
    # duplicated segment far apart: identical best score at two distant ends
    seg = "".join(rng.choice(list("ACGT"), 60))
    filler1 = "".join(rng.choice(list("ACGT"), 500))
    filler2 = "".join(rng.choice(list("ACGT"), 500))
    ref = filler1 + seg + filler2 + seg
    cases.append((ref, seg))
    cases.append((ref, seg[:30] + "T" + seg[31:]))
    return cases


def _oracle(ref, read, sm):
    """Full-width exact DP: (best, abc, aec, pw_ref, pw_frag)."""
    a = init_alignment(256, len(ref) + 16, rc=False, hp_special=False)
    a.submat = sm
    set_seq1(a, ref)
    set_seq2(a, read)
    a.sg5 = a.sg3 = True
    solve_sg(a)
    pw = a.pw if a.pw is not None else populate_pwaln_to_begin(a)
    return a.best_score, a.abc, a.aec, pw


def test_windowed_exact_dp_matches_full_width_on_ties():
    rng = np.random.default_rng(7)
    sm = init_flatsubmat()
    hit_window = 0
    for ref, read in _adversarial_cases(rng):
        best, abc, aec, pw = _oracle(ref, read, sm)
        a = init_alignment(256, len(ref) + 16, rc=False, hp_special=False)
        a.submat = sm
        set_seq1(a, ref)
        set_seq2(a, read)
        a.sg5 = a.sg3 = True
        windowed_exact_dp(a, best, aec)
        pw2 = a.pw if a.pw is not None else populate_pwaln_to_begin(a)
        assert (a.best_score, a.abc, a.aec) == (best, abc, aec), (ref[:20], read[:20])
        assert pw2 == pw, "windowed traceback differs from full-width"
        if aec - (len(read) + 16) > 0:
            hit_window += 1
    assert hit_window >= 8  # the family must actually exercise windowed runs


def test_native_finish_matches_full_width_on_ties():
    rng = np.random.default_rng(9)
    sm = init_flatsubmat()
    for ref, read in _adversarial_cases(rng):
        best, abc, aec, pw = _oracle(ref, read, sm)
        bh = BatchHost.create(
            ref, revcom(ref), len(ref), sm, None, -1, False, WIN_W, MAX_INTERVALS
        )
        arena, off, lens = BatchHost.pack_reads([read])
        ivg = np.zeros((1, MAX_INTERVALS, 2), np.int32)
        ivg[0, 0] = (0, len(ref))
        meta, ra, fa = bh.finish(
            arena,
            off[:-1],
            lens,
            np.zeros(1, np.uint8),
            np.zeros(1, np.uint8),
            np.array([best], np.int32),
            np.array([aec], np.int32),
            ivg,
        )
        bh.close()
        n = int(meta[0, 3])
        got = (
            ra[:n].decode("latin-1"),
            fa[:n].decode("latin-1"),
        )
        assert (meta[0, 0], meta[0, 1], meta[0, 2]) == (best, abc, aec), read[:20]
        assert got == pw, "native windowed traceback differs from full-width"
