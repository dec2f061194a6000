"""Random banded scoring entries and their scalar-oracle scores.

The device entry program (:mod:`mia.core.jax_engine`) must reproduce the
exact host engine's (best, end column) for every entry.  This module makes
entries of the shape production batches have — WIN_W-column windows with up
to a few open band intervals, reads up to L_MAX rows with the ancient-DNA
length mix, both reference strands and both PSSMs — and scores each one with
:func:`mia.ops.dp_numpy.solve_sg` over the full reference with the same
band mask.  Used by the tests and by ``chip_smoke.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .jax_engine import L_MAX, MAX_INTERVALS, WIN_W

_CHARS = np.array(list("ACGTN"))


@dataclass
class Entries:
    fw: np.ndarray      # [len1] int8 forward-strand reference codes
    rc: np.ndarray      # [len1] int8 second strand
    sms: np.ndarray     # [2, 31, 5, 5] int32 PSSMs selected by smidx
    ref_sel: np.ndarray  # [n] int8
    starts: np.ndarray   # [n] int32 window start
    ivl: np.ndarray      # [n, MAX_INTERVALS, 2] int32 window-local bands
    s2c: np.ndarray      # [n, L_MAX] int8 read codes (pad 4)
    lens: np.ndarray     # [n] int32
    smidx: np.ndarray    # [n] int8

    def args(self):
        """Positional arguments of ``Pass1Scorer.dispatch_entries``."""
        return (self.ref_sel, self.starts, self.ivl, self.s2c, self.lens,
                self.smidx)


def random_entries(
    n: int, seed: int = 0, len1: int = 4096, sort_lengths: bool = False,
    full_height: bool = True,
) -> Entries:
    """``n`` random entries against a random ``len1``-column reference.

    Lengths follow the simulator's ancient-DNA mix (Poisson 60, clipped to
    20..150), plus one L_MAX read when ``full_height``; ``sort_lengths``
    orders them longest first.  Window columns 0 and 1 stay closed, as
    every caller ships them (window start = band start - 2)."""
    from ..ops.pssm import init_flatsubmat, revcom_submat

    rng = np.random.default_rng(seed)
    fw = rng.integers(0, 4, len1).astype(np.int8)
    rc = rng.integers(0, 4, len1).astype(np.int8)
    sm = (init_flatsubmat() + rng.integers(-60, 60, (31, 5, 5))).astype(np.int32)
    sms = np.stack([sm, revcom_submat(sm).astype(np.int32)])
    lens = np.clip(rng.poisson(60, n), 20, 150).astype(np.int32)
    if full_height:
        lens[rng.integers(0, n)] = L_MAX
    if sort_lengths:
        lens = -np.sort(-lens)
    starts = rng.integers(0, len1 - WIN_W, n).astype(np.int32)
    ivl = np.zeros((n, MAX_INTERVALS, 2), np.int32)
    for e in range(n):
        k = int(rng.integers(1, 5))
        cuts = np.sort(rng.choice(np.arange(2, WIN_W + 1), 2 * k, replace=False))
        ivl[e, :k] = cuts.reshape(k, 2)
    s2c = np.full((n, L_MAX), 4, np.int8)
    for e in range(n):
        # mostly reads drawn from the window (scores above the gate), with
        # a sprinkle of N and random reads
        ln = int(lens[e])
        src = fw if rng.random() < 0.5 else rc
        lo = int(starts[e]) + int(rng.integers(0, max(WIN_W - ln, 1)))
        read = src[lo : lo + ln].copy()
        if len(read) < ln:
            read = np.concatenate([read, rng.integers(0, 4, ln - len(read))])
        mut = rng.random(ln) < 0.05
        read[mut] = rng.integers(0, 5, int(mut.sum()))
        s2c[e, :ln] = read
    return Entries(
        fw=fw, rc=rc, sms=sms,
        ref_sel=rng.integers(0, 2, n).astype(np.int8),
        starts=starts, ivl=ivl, s2c=s2c, lens=lens,
        smidx=rng.integers(0, 2, n).astype(np.int8),
    )


def oracle_scores(ent: Entries, idx=None) -> tuple[np.ndarray, np.ndarray]:
    """(best, window-local aec) of entries ``idx`` (default all) from the
    exact host engine."""
    from ..ops import dp_numpy as dpn
    from .driver import init_alignment, set_seq1, set_seq2

    idx = np.arange(len(ent.lens)) if idx is None else np.asarray(idx)
    len1 = len(ent.fw)
    best = np.zeros(len(idx), np.int64)
    aec = np.zeros(len(idx), np.int64)
    alns = []
    for codes in (ent.fw, ent.rc):
        a = init_alignment(L_MAX, len1 + 16, False, False)
        set_seq1(a, "".join(_CHARS[codes]))
        alns.append(a)
    for t, e in enumerate(idx):
        a = alns[ent.ref_sel[e]]
        a.submat = ent.sms[ent.smidx[e]]
        set_seq2(a, "".join(_CHARS[ent.s2c[e, : ent.lens[e]]]))
        a.sg5 = a.sg3 = True
        a.align_mask[: a.len1] = 0
        ws = int(ent.starts[e])
        for lo, hi in ent.ivl[e]:
            if hi > 0:
                a.align_mask[ws + lo : ws + hi] = 1
        dpn.solve_sg(a, do_trace=False)
        best[t] = a.best_score
        aec[t] = a.aec - ws
    return best, aec
