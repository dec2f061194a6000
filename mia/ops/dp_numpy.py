"""Exact semi-global DP engine (host/NumPy path) with trace recovery.

Re-derivation of the reference recurrence (dyn_prog, src/mia.c:740-981) in a
row-parallel form.  Key observation: every quantity needed at row ``r``
depends only on rows ``<= r-1``:

* the column-gap option is a running argmax over the *previous* row with
  per-position normalisation m[j] = score[r-1][j] + GEP*j
  (src/mia.c:838-847),
* the row-gap option is a per-column running argmax over rows ``<= r-2`` with
  n[i] = score[i][c] + GEP*i (src/mia.c:856-865),
* diagonal reads row r-1; homopolymer jumps read rows <= r-2.

Hence each row is computed with a handful of vector ops — no wavefront — and
the same formulation drives the batched device scorer
(:mod:`mia.ops.dp_jax`).  Tie-breaking and
trace encoding replicate the reference exactly (priority chain
src/mia.c:907-965; earliest-index argmax wins ties because updates use strict
'>'), which is what makes byte-identical maln output possible.

Trace encoding (src/types.h:164-172): 0 = diagonal, +j = jump back to column
j (gap in fragment), -i = jump up to row i (gap in reference); trace == col
or trace == -row marks the alignment start.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..constants import GEP, GOP, HIM, TRIM_SCORE_CUT, FLAT_MATCH
from .pssm import depth_vector

_LOW = np.int64(-(2**62))  # gating sentinel well below any reachable score

# Homopolymer gap-open discount table: 1/x fractions of GOP, truncated the
# same way C's int += int*double does (hp_discount_penalty,
# src/map_align.c:1096-1135).
_HP_FRac = [1.0, 0.5, 0.33, 0.25, 0.2, 0.17, 0.14, 0.13, 0.11, 0.10]


def hp_discount_penalty(gap_len: int, hplen1: int, hplen2: int) -> int:
    frac = _HP_FRac[hplen2 - 1] if 1 <= hplen2 <= 10 else 0.10
    return int(GEP * gap_len + GOP * frac)


def _hp_penalty_vec(gap_len: np.ndarray, hplen2: np.ndarray) -> np.ndarray:
    fr = np.array(_HP_FRac + [0.10])
    idx = np.clip(hplen2 - 1, 0, 10)
    return (GEP * gap_len + GOP * fr[idx]).astype(np.int64)


_NATIVE = None
_NATIVE_TRIED = False


def _load_native():
    """The C++ fill bakes the reference's GOP/GEP; only use it while the
    runtime constants match (else fall back to the numpy path, which reads
    them dynamically)."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    import os

    if GOP != 1000 or GEP != 200 or os.environ.get("MIA_NO_NATIVE") == "1":
        return None

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "native",
        "libmiaio.so",
    )
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.mia_dp_fill.restype = None
        if hasattr(lib, "mia_sg_window"):
            lib.mia_sg_window.restype = ctypes.c_int32
    except (OSError, AttributeError):
        return None
    _NATIVE = lib
    return lib


def _native_fill(a, s1c, s2c, mask, len1, len2, win_lo) -> bool:
    lib = _load_native()
    if lib is None or len1 == 0 or len2 == 0:
        return False
    import ctypes

    score = np.empty((len2, len1), dtype=np.int32)
    trace = np.empty((len2, len1), dtype=np.int32)
    s1c_c = np.ascontiguousarray(s1c, dtype=np.int8)
    s2c_c = np.ascontiguousarray(s2c, dtype=np.int8)
    mask_c = np.ascontiguousarray(mask, dtype=np.uint8)
    sm_c = np.ascontiguousarray(a.submat, dtype=np.int32)

    if a.hp:
        hpcl = np.ascontiguousarray(a.hpcl[win_lo : win_lo + len1], dtype=np.int32)
        hpcs = np.ascontiguousarray(a.hpcs[win_lo : win_lo + len1], dtype=np.int32)
        hprl = np.ascontiguousarray(a.hprl[:len2], dtype=np.int32)
        hprs = np.ascontiguousarray(a.hprs[:len2], dtype=np.int32)
        seq1 = a.seq1[win_lo : win_lo + len1].encode("latin-1")
        seq2 = a.seq2[:len2].encode("latin-1")
        hp_args = (
            hpcl.ctypes.data_as(ctypes.c_void_p),
            hpcs.ctypes.data_as(ctypes.c_void_p),
            hprl.ctypes.data_as(ctypes.c_void_p),
            hprs.ctypes.data_as(ctypes.c_void_p),
        )
    else:
        seq1 = b"\0" * len1
        seq2 = b"\0" * len2
        hp_args = (None, None, None, None)

    lib.mia_dp_fill(
        s1c_c.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len1),
        s2c_c.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len2),
        sm_c.ctypes.data_as(ctypes.c_void_p),
        mask_c.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(1 if a.sg5 else 0),
        ctypes.c_char_p(seq1),
        ctypes.c_char_p(seq2),
        *hp_args,
        ctypes.c_int(win_lo),
        score.ctypes.data_as(ctypes.c_void_p),
        trace.ctypes.data_as(ctypes.c_void_p),
    )
    a.score = score
    a.trace = trace
    return True


@dataclass
class Alignment:
    """DP workspace + result (mirror of src/types.h:214-254)."""

    seq1: str = ""            # reference
    seq2: str = ""            # fragment
    s1c: Optional[np.ndarray] = None
    s2c: Optional[np.ndarray] = None
    len1: int = 0
    len2: int = 0
    align_mask: Optional[np.ndarray] = None  # uint8 over columns
    submat: Optional[np.ndarray] = None       # [31,5,5] int32
    hp: bool = False
    hpcl: Optional[np.ndarray] = None
    hpcs: Optional[np.ndarray] = None
    hprl: Optional[np.ndarray] = None
    hprs: Optional[np.ndarray] = None
    sg5: bool = False
    sg3: bool = False
    rc: bool = False
    # results; score/trace cover columns [col_off, col_off + width)
    score: Optional[np.ndarray] = None  # [len2, width] int64
    trace: Optional[np.ndarray] = None  # [len2, width] int32
    col_off: int = 0
    abc: int = 0
    abr: int = 0
    aec: int = 0
    aer: int = 0
    best_score: int = 0
    # gapped (ref, frag) strings from the fused native path (solve_sg)
    pw: Optional[tuple] = None


def dyn_prog(a: Alignment) -> None:
    """Fill a.score / a.trace for the current sequences (exact semantics of
    src/mia.c:740-981, row-vectorised).

    Band reduction: columns outside the open region of align_mask hold HIM
    and can never win against the ever-present restart option, so computing
    the window [lo-2 .. hi] (lo/hi = first/last open column, two masked
    columns kept as stand-ins for the entire masked left context) reproduces
    the full matrix exactly over every reachable cell.  ``a.col_off`` maps
    window-local columns back to reference columns.
    """
    full_len1, len2 = a.len1, a.len2
    full_mask = (
        a.align_mask[:full_len1].astype(bool)
        if a.align_mask is not None
        else np.ones(full_len1, dtype=bool)
    )
    open_cols = np.flatnonzero(full_mask)
    if len(open_cols) == 0:
        # fully masked: every cell is HIM; a single column reproduces the
        # observable behaviour (argmax -> col 0, immediate trace stop)
        a.col_off = 0
        a.score = np.full((len2, min(full_len1, 1)), HIM, dtype=np.int64)
        a.trace = np.zeros((len2, min(full_len1, 1)), dtype=np.int32)
        return
    win_lo = max(int(open_cols[0]) - 2, 0)
    win_hi = int(open_cols[-1])
    a.col_off = win_lo
    len1 = win_hi - win_lo + 1
    s1c = a.s1c[win_lo : win_lo + len1]
    s2c = a.s2c[:len2]
    mask = full_mask[win_lo : win_lo + len1]
    # (when win_lo > 0 the window's local column 0 is masked by construction,
    # so the real column-0 special case below only ever fires at win_lo == 0)

    # native fill (same recurrence, scalar C++): the winner for narrow bands
    # where numpy dispatch overhead dominates
    if _native_fill(a, s1c, s2c, mask, len1, len2, win_lo):
        return
    sm = a.submat  # [31,5,5]
    depths = depth_vector(len2)

    score = np.empty((len2, len1), dtype=np.int64)
    trace = np.zeros((len2, len1), dtype=np.int32)

    cols = np.arange(len1, dtype=np.int64)

    # -- row 0 (src/mia.c:769-785)
    row_sm = sm[0][:, s2c[0]].astype(np.int64)  # [5] scores vs read base
    score[0] = np.where(mask, row_sm[s1c], HIM)
    # trace row 0 stays 0

    if len2 == 1:
        a.score, a.trace = score, trace
        return

    # running row-gap bests per column c (normalised value, arg row)
    rbest_val = score[0] + 0  # n[0] = score[0][c] + GEP*0
    rbest_arg = np.zeros(len1, dtype=np.int64)
    # columns whose best_gap_row entry is actually maintained: c such that
    # mask[c+1] is set (the update happens while processing col=c+1,
    # src/mia.c:856-865)
    upd_mask = np.zeros(len1, dtype=bool)
    upd_mask[: len1 - 1] = mask[1:]

    if a.hp:
        # homopolymer arrays are global-indexed; slice to the window and keep
        # global column values for the start/length comparisons
        hpcl = a.hpcl[win_lo : win_lo + len1].astype(np.int64)
        hpcs = a.hpcs[win_lo : win_lo + len1].astype(np.int64)
        hprl = a.hprl[:len2].astype(np.int64)
        hprs = a.hprs[:len2].astype(np.int64)
        seq1b = np.frombuffer(
            a.seq1[win_lo : win_lo + len1].encode("latin-1"), dtype=np.uint8
        )
        seq2b = np.frombuffer(a.seq2[:len2].encode("latin-1"), dtype=np.uint8)
        gcols = cols + win_lo  # global column index per window position

    for row in range(1, len2):
        prev = score[row - 1]
        row_sm = sm[depths[row]][:, s2c[row]].astype(np.int64)
        cell_sub = row_sm[s1c]

        # column 0 (src/mia.c:799-822)
        c0 = cell_sub[0] - (GOP + GEP * (row + 1)) * (1 if a.sg5 else 0)
        score[row, 0] = c0 if mask[0] else HIM
        trace[row, 0] = 0

        # ---- column-gap option: running argmax over previous row ----
        # candidate j = col-2 admitted only when mask[col] (src/mia.c:838-841)
        m = prev + GEP * cols
        cand = np.full(len1, _LOW, dtype=np.int64)
        if len1 > 2:
            cand[: len1 - 2] = np.where(mask[2:], m[: len1 - 2], _LOW)
        cand[0] = m[0]  # initial best_gap_col = 0 (src/mia.c:825)
        run_max = np.maximum.accumulate(cand)
        # earliest argmax: indices where a new strict maximum appears
        is_new = np.empty(len1, dtype=bool)
        is_new[0] = True
        is_new[1:] = cand[1:] > run_max[:-1]
        run_arg = np.maximum.accumulate(np.where(is_new, cols, 0))

        gap_col = np.full(len1, HIM, dtype=np.int64)
        if len1 > 2:
            gap_col[2:] = run_max[: len1 - 2] - GOP - GEP * (cols[2:] - 1)
            bgc = run_arg[: len1 - 2]  # best_gap_col per col>=2

        # ---- row-gap option ----
        if row >= 2:
            cand_r = score[row - 2] + GEP * (row - 2)
            take = upd_mask & (cand_r > rbest_val)
            rbest_val = np.where(take, cand_r, rbest_val)
            rbest_arg = np.where(take, row - 2, rbest_arg)
            gap_row = np.full(len1, HIM, dtype=np.int64)
            gap_row[1:] = rbest_val[:-1] - GOP - GEP * (row - 1)
            bgr = rbest_arg[:-1]  # per col>=1 : best_gap_row[col-1]
        else:
            gap_row = np.full(len1, HIM, dtype=np.int64)
            bgr = np.zeros(max(len1 - 1, 0), dtype=np.int64)

        # ---- diagonal / restart ----
        diag = np.empty(len1, dtype=np.int64)
        diag[1:] = prev[:-1]
        diag[0] = _LOW
        start_new = np.int64(-(GOP + GEP * (row + 1)) if a.sg5 else 0)

        # ---- homopolymer discounted gaps (src/mia.c:883-905) ----
        if a.hp:
            same = seq1b == seq2b[row]
            # hp jump targets left of the window are masked-HIM cells in the
            # full matrix and can never win; drop them
            in_win = (hpcs - 1) >= win_lo
            ok_c = same & (hprs[row] == row) & (hpcs != gcols) & (hpcs > 0) & in_win
            pen = _hp_penalty_vec(gcols - hpcs, np.full(len1, hprl[row]))
            hp_col = np.where(
                ok_c, prev[np.maximum(hpcs - 1 - win_lo, 0)] - pen, HIM
            )
            ok_r = same & (hpcs == gcols) & (hprs[row] != row) & (hprs[row] > 0)
            if hprs[row] > 0:
                srcrow = score[hprs[row] - 1]
                hp_row = np.full(len1, HIM, dtype=np.int64)
                hp_row[1:] = np.where(ok_r[1:], srcrow[:-1] - pen[1:], HIM)
            else:
                hp_row = np.full(len1, HIM, dtype=np.int64)
        else:
            hp_col = np.full(len1, HIM, dtype=np.int64)
            hp_row = np.full(len1, HIM, dtype=np.int64)

        # ---- pick the best option, reference priority chain ----
        # (src/mia.c:907-965)
        is_start = (
            (start_new > diag)
            & (start_new > gap_col)
            & (start_new > gap_row)
            & (start_new > hp_col)
            & (start_new > hp_row)
        )
        is_diag = (
            (diag >= gap_col) & (diag >= gap_row) & (diag >= hp_col) & (diag >= hp_row)
        )
        is_gc = (gap_col >= gap_row) & (gap_col >= hp_col) & (gap_col >= hp_row)
        is_gr = (gap_row >= hp_col) & (gap_row >= hp_row)
        is_hc = hp_col >= hp_row

        base = np.where(
            is_diag,
            diag,
            np.where(is_gc, gap_col, np.where(is_gr, gap_row, np.where(is_hc, hp_col, hp_row))),
        )
        new_score = np.where(is_start, start_new, cell_sub + base)

        tr_gc = np.zeros(len1, dtype=np.int64)
        if len1 > 2:
            tr_gc[2:] = bgc
        tr_gr = np.zeros(len1, dtype=np.int64)
        tr_gr[1:] = -bgr
        tr_hc = (
            np.maximum(hpcs - 1 - win_lo, 0) if a.hp else np.zeros(len1, dtype=np.int64)
        )
        tr_hr = np.int64(-(hprs[row] - 1)) if a.hp else np.int64(0)
        new_trace = np.where(
            is_start,
            cols,
            np.where(
                is_diag,
                0,
                np.where(is_gc, tr_gc, np.where(is_gr, tr_gr, np.where(is_hc, tr_hc, tr_hr))),
            ),
        )

        score[row, 1:] = np.where(mask[1:], new_score[1:], HIM)
        trace[row, 1:] = np.where(mask[1:], new_trace[1:], 0)

        # NOTE on sg3: the reference's end-of-row penalty (src/mia.c:975-979)
        # runs after the column loop, when col == len1, so it writes one
        # column PAST the used matrix region — a cell no later computation
        # ever reads.  It is dead code in practice, so the semiglobal-3'
        # behaviour comes solely from max_sg_score scanning the last row.
        # We deliberately do not apply any end penalty here.

    a.score, a.trace = score, trace


def max_sg_score(a: Alignment) -> int:
    """Last-row argmax; earliest column wins ties (src/mia.c:1278-1302).

    Columns outside the computed window hold HIM in the full matrix; any open
    column beats HIM (the restart option bounds every open cell well above
    it), so the window argmax maps directly to the full-matrix argmax."""
    row = a.len2 - 1
    if row < 0:
        return -(2**31)
    last = a.score[row]
    col = int(np.argmax(last))  # first occurrence == earliest tie
    if int(last[col]) == HIM and a.col_off == 0:
        col = 0  # all-HIM row: the reference picks global column 0
    a.aec = col + a.col_off
    a.aer = row
    a.best_score = int(last[col])
    return a.best_score


def find_align_begin(a: Alignment) -> None:
    """Walk the trace back from (aer, aec) to the alignment start
    (src/mia.c:605-637).  The walk runs in window-local columns (trace values
    are local) and converts at the end."""
    row, col = a.aer, a.aec - a.col_off
    tr = a.trace
    while tr[row, col] != col and tr[row, col] != -row:
        t = tr[row, col]
        if t == 0:
            row -= 1
            col -= 1
        elif t < 0:
            row = -t
            col -= 1
        else:
            col = t
            row -= 1
    a.abc = col + a.col_off
    a.abr = row


def populate_pwaln_to_begin(a: Alignment) -> tuple[str, str]:
    """Emit gapped (ref, frag) alignment strings walking the trace
    (src/map_align.c:1440-1497)."""
    lib = _load_native()
    if (
        lib is not None
        and a.trace.dtype == np.int32
        and a.trace.flags["C_CONTIGUOUS"]
    ):
        import ctypes

        len2, len1 = a.trace.shape
        off = a.col_off
        seq1 = a.seq1[off : off + len1].encode("latin-1")
        seq2 = a.seq2[: a.len2].encode("latin-1")
        cap = 2 * (len1 + len2) + 16
        out_ref = ctypes.create_string_buffer(cap)
        out_frag = ctypes.create_string_buffer(cap)
        abr = ctypes.c_int32()
        abc = ctypes.c_int32()
        lib.mia_dp_traceback.restype = ctypes.c_int32
        n = lib.mia_dp_traceback(
            a.trace.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(len1),
            ctypes.c_int(len2),
            ctypes.c_int(a.aer),
            ctypes.c_int(a.aec - off),
            ctypes.c_char_p(seq1),
            ctypes.c_char_p(seq2),
            out_ref,
            out_frag,
            ctypes.c_int(cap),
            ctypes.byref(abr),
            ctypes.byref(abc),
        )
        if n >= 0:  # n == -1: cap overflow -> python walk below
            return (
                out_ref.raw[:n].decode("latin-1"),
                out_frag.raw[:n].decode("latin-1"),
            )

    ras: list[str] = []
    fas: list[str] = []
    off = a.col_off
    row, col = a.aer, a.aec - off
    tr = a.trace
    s1, s2 = a.seq1, a.seq2
    while tr[row, col] != col and tr[row, col] != -row:
        ras.append(s1[col + off])
        fas.append(s2[row])
        t = tr[row, col]
        if t == 0:
            row -= 1
            col -= 1
        elif t < 0:
            next_row = -t
            row -= 1
            col -= 1
            while row > next_row:
                fas.append(s2[row])
                ras.append("-")
                row -= 1
        else:
            next_col = t
            row -= 1
            col -= 1
            while col > next_col:
                fas.append("-")
                ras.append(s1[col + off])
                col -= 1
    ras.append(s1[col + off])
    fas.append(s2[row])
    return "".join(reversed(ras)), "".join(reversed(fas))


_SG_BUFS = None


def _sg_bufs():
    global _SG_BUFS
    if _SG_BUFS is None:
        import ctypes

        cap = 4 * (INITIAL_SG_CAP := 2 * (256 + 20000) + 16)
        _SG_BUFS = (
            ctypes.create_string_buffer(cap),
            ctypes.create_string_buffer(cap),
            np.zeros(4, dtype=np.int32),
            cap,
        )
    return _SG_BUFS


def _native_sg_window(a: Alignment, do_trace: bool) -> bool:
    """One-FFI-call fill + argmax + begin walk (+ traceback strings) via
    mia_sg_window; sets best_score/aec/aer/abc/abr (+ a.pw).  Returns False
    when the native library or the band is unusable (caller falls back)."""
    lib = _load_native()
    full_len1, len2 = a.len1, a.len2
    if lib is None or not hasattr(lib, "mia_sg_window") or len2 == 0 or full_len1 == 0:
        return False
    full_mask = (
        a.align_mask[:full_len1].astype(bool)
        if a.align_mask is not None
        else np.ones(full_len1, dtype=bool)
    )
    open_cols = np.flatnonzero(full_mask)
    if len(open_cols) == 0:
        return False  # degenerate all-masked case: classic path handles it
    import ctypes

    win_lo = max(int(open_cols[0]) - 2, 0)
    win_hi = int(open_cols[-1])
    len1 = win_hi - win_lo + 1
    a.col_off = win_lo

    s1c_c = np.ascontiguousarray(a.s1c[win_lo : win_lo + len1], dtype=np.int8)
    s2c_c = np.ascontiguousarray(a.s2c[:len2], dtype=np.int8)
    mask_c = np.ascontiguousarray(full_mask[win_lo : win_lo + len1], dtype=np.uint8)
    sm_c = np.ascontiguousarray(a.submat, dtype=np.int32)

    if a.hp:
        hpcl = np.ascontiguousarray(a.hpcl[win_lo : win_lo + len1], dtype=np.int32)
        hpcs = np.ascontiguousarray(a.hpcs[win_lo : win_lo + len1], dtype=np.int32)
        hprl = np.ascontiguousarray(a.hprl[:len2], dtype=np.int32)
        hprs = np.ascontiguousarray(a.hprs[:len2], dtype=np.int32)
        hp_args = (
            hpcl.ctypes.data_as(ctypes.c_void_p),
            hpcs.ctypes.data_as(ctypes.c_void_p),
            hprl.ctypes.data_as(ctypes.c_void_p),
            hprs.ctypes.data_as(ctypes.c_void_p),
        )
    else:
        hp_args = (None, None, None, None)
    seq1 = a.seq1[win_lo : win_lo + len1].encode("latin-1")
    seq2 = a.seq2[:len2].encode("latin-1")

    out_ref, out_frag, meta, cap = _sg_bufs()
    if 2 * (len1 + len2) + 16 > cap:
        return False
    best = lib.mia_sg_window(
        s1c_c.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len1),
        s2c_c.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(len2),
        sm_c.ctypes.data_as(ctypes.c_void_p),
        mask_c.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(1 if a.sg5 else 0),
        ctypes.c_char_p(seq1),
        ctypes.c_char_p(seq2),
        *hp_args,
        ctypes.c_int(win_lo),
        ctypes.c_int(1 if do_trace else 0),
        out_ref,
        out_frag,
        ctypes.c_int(cap),
        meta.ctypes.data_as(ctypes.c_void_p),
    )
    a.best_score = int(best)
    a.aec = int(meta[0]) + win_lo
    a.aer = len2 - 1
    a.abr = int(meta[1])
    a.abc = int(meta[2]) + win_lo
    if do_trace:
        n = int(meta[3])
        if n < 0:  # traceback cap overflow: let the classic path redo it
            return False
        a.pw = (
            out_ref.raw[:n].decode("latin-1"),
            out_frag.raw[:n].decode("latin-1"),
        )
    else:
        a.pw = None
    return True


def solve_sg(a: Alignment, do_trace: bool = True) -> None:
    """Fill + last-row argmax + begin walk (+ traceback strings) with the
    fastest available engine.  Sets a.best_score/aec/aer/abc/abr; when
    ``do_trace``, a.pw holds the gapped (ref, frag) strings."""
    if _native_sg_window(a, do_trace):
        return
    dyn_prog(a)
    max_sg_score(a)
    find_align_begin(a)
    a.pw = populate_pwaln_to_begin(a) if do_trace else None


def trim_argmax_last_col(a: Alignment) -> int:
    """Best score in the last column, earliest row wins ties
    (trim_frag, src/map_align.c:1340-1353)."""
    col = a.len1 - 1 - a.col_off
    colvals = a.score[: a.len2, col]
    row = int(np.argmax(colvals))
    a.aec = col + a.col_off
    a.aer = row
    return int(colvals[row])
