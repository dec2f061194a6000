"""Differential tests: native batched host engine vs the per-read Python path.

The native prepare must reproduce new_kmer_filter's masks (as intervals,
window starts and flags) and the native finish must reproduce
windowed_exact_dp's verified traceback, for random reads over a random
reference — both paths feed byte-identical maln output, so any divergence
here is a correctness bug.
"""
from __future__ import annotations

import numpy as np
import pytest

from mia.constants import INIT_ALN_SEQ_LEN
from mia.core.driver import init_alignment, set_seq1, set_seq2
from mia.core.hostbatch import (
    FLAG_HOST_ONLY,
    FLAG_SKIP,
    FLAG_WIDE,
    BatchHost,
)
from mia.core.jax_engine import MAX_INTERVALS, WIN_W, mask_intervals
from mia.ops.dp_numpy import solve_sg
from mia.ops.kmer import KmerPosArray, new_kmer_filter
from mia.ops.pssm import init_flatsubmat, revcom_submat
from mia.utils.encoding import revcom

pytestmark = pytest.mark.skipif(
    BatchHost is None or __import__("mia.io.native", fromlist=["_load"])._load() is None
    or not hasattr(__import__("mia.io.native", fromlist=["_load"])._load(), "mia_p1_create"),
    reason="native hostbatch not built",
)


def _mk_ref(rng, n=2000, lower_frac=0.0):
    bases = rng.choice(list("ACGT"), n)
    if lower_frac:
        low = rng.random(n) < lower_frac
        bases = np.where(low, np.char.lower(bases), bases)
    return "".join(bases)


def _mk_reads(rng, ref, count, minlen=20, maxlen=80, mut=0.05):
    reads = []
    up = ref.upper()
    for _ in range(count):
        ln = int(rng.integers(minlen, maxlen))
        p = int(rng.integers(0, len(ref) - ln))
        s = list(up[p : p + ln])
        for i in range(ln):
            if rng.random() < mut:
                s[i] = rng.choice(list("ACGT"))
        seq = "".join(s)
        if rng.random() < 0.5:
            seq = revcom(seq)
        reads.append(seq)
    # some junk reads that should be filtered out
    for _ in range(count // 4):
        reads.append("".join(rng.choice(list("ACGT"), int(rng.integers(20, 60)))))
    rng.shuffle(reads)
    return reads


@pytest.mark.parametrize("soft_mask,lower_frac", [(False, 0.0), (True, 0.3), (False, 0.3)])
def test_prepare_matches_python(soft_mask, lower_frac):
    rng = np.random.default_rng(11)
    ref = _mk_ref(rng, 3000, lower_frac)
    rc_ref = revcom(ref)
    k = 12
    len1 = len(ref)
    fkpa = KmerPosArray(ref, k, soft_mask)
    rkpa = KmerPosArray(rc_ref, k, soft_mask)
    reads = _mk_reads(rng, ref, 120)

    bh = BatchHost.create(
        ref, rc_ref, len1, init_flatsubmat(), None, k, soft_mask, WIN_W, MAX_INTERVALS
    )
    arena, off, lens = BatchHost.pack_reads(reads)
    L = 128
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = bh.prepare(arena, off, lens, L, MAX_INTERVALS)

    fw_mask = np.zeros(len1, np.uint8)
    rc_mask = np.zeros(len1, np.uint8)
    from mia.utils.encoding import encode_seq

    for b, seq in enumerate(reads):
        hits = new_kmer_filter(seq, len(seq), fkpa, rkpa, k, fw_mask, rc_mask, len1, len1)
        if hits == 0:
            assert flags[b] == FLAG_SKIP, (b, seq)
            continue
        fiv = mask_intervals(fw_mask[:len1])
        riv = mask_intervals(rc_mask[:len1])
        if fiv is None or riv is None:
            assert flags[b] == FLAG_HOST_ONLY
            continue
        assert flags[b] & FLAG_SKIP == 0 and flags[b] & FLAG_HOST_ONLY == 0
        np.testing.assert_array_equal(fw_ivg[b], fiv, err_msg=f"fw iv read {b}")
        np.testing.assert_array_equal(rc_ivg[b], riv, err_msg=f"rc iv read {b}")
        # wide determination + window starts
        wide = False
        ws = {}
        for key, iv in (("f", fiv), ("r", riv)):
            used = iv[:, 1] > 0
            if not used.any():
                ws[key] = 0
                continue
            lo = int(iv[used, 0].min())
            hi = int(iv[used, 1].max())
            w0 = max(0, lo - 2)
            if hi - w0 > WIN_W:
                wide = True
            ws[key] = w0
        assert bool(flags[b] & FLAG_WIDE) == wide, f"wide mismatch read {b}"
        if not wide:
            assert fw_ws[b] == ws["f"] and rc_ws[b] == ws["r"], f"ws mismatch read {b}"
        # encoded read row
        exp = np.full(L, 4, np.int32)
        exp[: len(seq)] = encode_seq(seq)
        np.testing.assert_array_equal(s2c[b], exp)
    bh.close()


def test_finish_matches_windowed_exact_dp():
    rng = np.random.default_rng(5)
    ref = _mk_ref(rng, 2500)
    rc_ref = revcom(ref)
    k = 12
    len1 = len(ref)
    fkpa = KmerPosArray(ref, k, False)
    rkpa = KmerPosArray(rc_ref, k, False)
    reads = [r for r in _mk_reads(rng, ref, 100)]

    submat = init_flatsubmat()
    bh = BatchHost.create(ref, rc_ref, len1, submat, revcom_submat(submat), k, False, WIN_W, MAX_INTERVALS)
    arena, off, lens = BatchHost.pack_reads(reads)
    s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = bh.prepare(arena, off, lens, 128, MAX_INTERVALS)

    size2 = len1 + 2 * INIT_ALN_SEQ_LEN
    fw_a = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=False, hp_special=False)
    rc_a = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=True, hp_special=False)
    set_seq1(fw_a, ref, len1)
    set_seq1(rc_a, rc_ref, len1)
    fw_a.submat = rc_a.submat = submat
    fw_a.sg5 = fw_a.sg3 = rc_a.sg5 = rc_a.sg3 = True

    fw_mask = np.zeros(len1, np.uint8)
    rc_mask = np.zeros(len1, np.uint8)

    sel = []  # (b, strand, best, aec, ivg row)
    expected = []
    from mia.core.jax_engine import windowed_exact_dp

    for b, seq in enumerate(reads):
        if flags[b] != 0:
            continue
        hits = new_kmer_filter(seq, len(seq), fkpa, rkpa, k, fw_mask, rc_mask, len1, len1)
        assert hits
        # host full solve per strand provides the oracle (best, aec)
        results = {}
        for a, m in ((fw_a, fw_mask), (rc_a, rc_mask)):
            a.align_mask[:len1] = m
            set_seq2(a, seq)
            solve_sg(a, do_trace=False)
            results[a.rc] = (a.best_score, a.aec)
        strand = 1 if results[True][0] > results[False][0] else 0
        best, aec = results[bool(strand)]
        a = rc_a if strand else fw_a
        a.align_mask[:len1] = rc_mask if strand else fw_mask
        set_seq2(a, seq)
        windowed_exact_dp(a, best, aec)
        expected.append((a.best_score, a.abc, a.aec, a.pw))
        sel.append((b, strand, best, aec))

    n = len(sel)
    assert n > 30
    idx = np.array([s[0] for s in sel])
    sub_reads = [reads[i] for i in idx]
    arena2, off2, lens2 = BatchHost.pack_reads(sub_reads)
    strand = np.array([s[1] for s in sel], np.uint8)
    dev_best = np.array([s[2] for s in sel], np.int32)
    dev_aec = np.array([s[3] for s in sel], np.int32)
    ivg = np.where(strand[:, None, None] == 1, rc_ivg[idx], fw_ivg[idx])
    meta, ref_arena, frag_arena = bh.finish(
        arena2, off2, lens2, strand, np.zeros(n, np.uint8), dev_best, dev_aec, ivg
    )
    cap = BatchHost.TRACE_CAP
    for i, (ebest, eabc, eaec, epw) in enumerate(expected):
        assert meta[i, 0] == ebest, f"best mismatch read {idx[i]}"
        assert meta[i, 1] == eabc, f"abc mismatch read {idx[i]}"
        assert meta[i, 2] == eaec, f"aec mismatch read {idx[i]}"
        nlen = meta[i, 3]
        prs = ref_arena[i * cap : i * cap + nlen].decode("latin-1")
        pfs = frag_arena[i * cap : i * cap + nlen].decode("latin-1")
        assert (prs, pfs) == epw, f"pw mismatch read {idx[i]}"
    bh.close()


def test_solve_pass1_hp_matches_python():
    """mia_p1_solve with -h homopolymer discounting must reproduce the exact
    per-read Python hp path (scores, coords, traceback strings)."""
    from mia.core.driver import sg_align
    from mia.core.hostbatch import STATUS_GATED, STATUS_NO_KMER, STATUS_OK
    from mia.core.types import FSDB as TFSDB, FragSeq, MapAlignment, RefSeq

    rng = np.random.default_rng(23)
    # homopolymer-rich reference: expand random bases into short runs
    parts = []
    while sum(len(p) for p in parts) < 1500:
        parts.append(rng.choice(list("ACGT")) * int(rng.integers(1, 6)))
    ref = "".join(parts)
    rc_ref = revcom(ref)
    len1 = len(ref)
    k = 12
    sm = init_flatsubmat()

    bh = BatchHost.create(
        ref, rc_ref, len1, sm, None, k, False, WIN_W, MAX_INTERVALS, hp=True
    )
    reads = _mk_reads(rng, ref, 60, mut=0.08)
    # inject indels so hp gap jumps actually fire
    mutated = []
    for r in reads:
        s = list(r)
        for _ in range(int(rng.integers(0, 3))):
            p = int(rng.integers(1, len(s)))
            if rng.random() < 0.5 and len(s) > 25:
                del s[p]
            else:
                s.insert(p, str(rng.choice(list("ACGT"))))
        mutated.append("".join(s))
    arena, off, lens = BatchHost.pack_reads(mutated)
    meta, ra, fa = bh.solve_pass1(arena, off[:-1], lens, False)
    cap = bh.TRACE_CAP

    fkpa = KmerPosArray(ref, k, False)
    rkpa = KmerPosArray(rc_ref, k, False)
    size2 = len1 + 2 * INIT_ALN_SEQ_LEN
    from mia.core.driver import set_hp_cols, set_hp_rows

    fw_a = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=False, hp_special=True)
    rc_a = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=True, hp_special=True)
    fw_a.submat = sm
    rc_a.submat = sm
    set_seq1(fw_a, ref, len1)
    set_seq1(rc_a, rc_ref, len1)
    set_hp_cols(fw_a)
    set_hp_cols(rc_a)

    checked = 0
    for b, seq in enumerate(mutated):
        maln = MapAlignment()
        maln.ref = RefSeq(id="r", seq=ref, rcseq=rc_ref, seq_len=len1)
        maln.ref.wrap_seq_len = len1
        maln.ref.gaps = np.zeros(len1 + 1, np.int64)
        fsdb = TFSDB()
        fs = FragSeq(id=f"t{b}", seq=seq, seq_len=len(seq))
        fs.trimmed = False
        hits = new_kmer_filter(
            seq, len(seq), fkpa, rkpa, k,
            fw_a.align_mask, rc_a.align_mask, len1, len1,
        )
        if hits == 0:
            assert meta[b, 0] == STATUS_NO_KMER
            continue
        sg_align(maln, fs, fsdb, fw_a, rc_a)
        if meta[b, 0] == STATUS_GATED:
            assert fs.score == meta[b, 2], b
            assert fs.front_asp is None
            continue
        assert meta[b, 0] == STATUS_OK, (b, meta[b, 0])
        assert fs.score == meta[b, 2], b
        assert bool(fs.rc) == bool(meta[b, 1]), b
        n = int(meta[b, 5])
        if fs.front_asp is not None:
            checked += 1
    assert checked >= 20  # the workload must actually exercise alignments
