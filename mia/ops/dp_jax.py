"""Batched DP scorer, plain ``jax.numpy``/``lax`` compiled by XLA.

Same row-parallel formulation as :mod:`mia.ops.dp_numpy`, expressed as a
loop over read rows with every column of every read in the batch computed
per step: [batch, ref_cols] int32 slabs, a cummax for the column-gap prefix
argmax and elementwise selects for the priority chain.  Integer arithmetic matches C
exactly (int32, HIM sentinel), so scores agree bit-for-bit with the host
engine; traceback for the winning strand is recovered on host over an
exact right-truncated window (cells left of a column never depend on cells to
its right).

Semi-global scoring summary (matches dyn_prog, src/mia.c:740-981):
row 0 free; col 0 carries the sg5 penalty; gap options are running argmaxes
with GOP+GEP*len cost; restart pays the sg5 prefix penalty; the last row's
maximum (earliest column) is the alignment score.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import GEP, GOP, HIM

# np scalar, not jnp: a module-level jnp.int32 is a concrete device array
# that gets hoisted as an executable parameter under some program orderings
_LOW = np.int32(-(2**30) - 2**29)  # below any reachable value, no overflow


@functools.partial(jax.jit, static_argnames=("sg5",))
def batch_last_row(
    s1c: jax.Array,      # [W] shared or [B, W] per-read reference codes 0..4
    mask: jax.Array,     # [B, W] bool open columns per read
    s2c: jax.Array,      # [B, L] int32 read codes (padded with 4)
    lengths: jax.Array,  # [B] int32 read lengths (>=1)
    depths: jax.Array,   # [B, L] int32 PSSM depth per row (clipped)
    submat: jax.Array,   # [31, 5, 5] int32
    sg5: bool = True,
) -> jax.Array:
    """Return the DP matrix row at each read's last row: [B, W] int32.

    All rows run to L with per-read snapshots at row == length-1; masked
    columns hold HIM exactly like the scalar engine.
    """
    B, W = mask.shape
    L = s2c.shape[1]
    cols = jax.lax.iota(jnp.int32, W)  # symbolic: no hoisted consts
    s1c2d = s1c if s1c.ndim == 2 else jnp.broadcast_to(s1c[None, :], (B, W))

    # row 0: plain substitution scores on open columns (depth 0 always,
    # src/mia.c:763-766)
    sub0 = jnp.take_along_axis(
        submat[jnp.zeros((B,), jnp.int32)],  # depth 0 at row 0 always
        s2c[:, 0][:, None, None],
        axis=2,
    )[:, :, 0]  # [B, 5]
    cell0 = jnp.take_along_axis(sub0, s1c2d, axis=1)
    row0 = jnp.where(mask, cell0, jnp.int32(HIM))

    snap0 = row0  # snapshot if length == 1
    rbest_val0 = row0  # n[0] = row0 + GEP*0
    init = (row0, jnp.full_like(row0, _LOW), rbest_val0, snap0)

    # columns whose best_gap_row entry is maintained: mask shifted left
    upd_mask = jnp.concatenate([mask[:, 1:], jnp.zeros((B, 1), bool)], axis=1)

    def step(carry, row):
        prev, prev2, rbest_val, snap = carry

        depth = depths[:, row]  # [B]
        subm = submat[depth]  # [B,5,5]
        row_sm = jnp.take_along_axis(subm, s2c[:, row][:, None, None], axis=2)[:, :, 0]
        cell_sub = jnp.take_along_axis(row_sm, s1c2d, axis=1)

        sg5_pen = jnp.int32(GOP + GEP * (row + 1)) if sg5 else jnp.int32(0)

        # column gaps: prefix max over normalised previous row
        m = prev + GEP * cols[None, :]
        cand = jnp.full((B, W), _LOW, dtype=jnp.int32)
        cand = cand.at[:, : W - 2].set(jnp.where(mask[:, 2:], m[:, : W - 2], _LOW))
        cand = cand.at[:, 0].set(m[:, 0])
        run_max = jax.lax.cummax(cand, axis=1)
        gap_col = jnp.full((B, W), jnp.int32(HIM))
        gap_col = gap_col.at[:, 2:].set(
            run_max[:, : W - 2] - GOP - GEP * (cols[None, 2:] - 1)
        )

        # row gaps: running per-column argmax over rows <= row-2
        def upd(rv):
            cand_r = prev2 + GEP * (row - 2)
            return jnp.where(upd_mask & (cand_r > rv), cand_r, rv)

        rbest_val = jax.lax.cond(row >= 2, upd, lambda rv: rv, rbest_val)
        gap_row = jnp.full((B, W), jnp.int32(HIM))
        gap_row = jnp.where(
            row >= 2,
            gap_row.at[:, 1:].set(rbest_val[:, :-1] - GOP - GEP * (row - 1)),
            gap_row,
        )

        diag = jnp.concatenate([jnp.full((B, 1), _LOW), prev[:, :-1]], axis=1)
        start_new = -sg5_pen if sg5 else jnp.int32(0)

        is_start = (
            (start_new > diag) & (start_new > gap_col) & (start_new > gap_row)
        )
        is_diag = (diag >= gap_col) & (diag >= gap_row)
        is_gc = gap_col >= gap_row
        base = jnp.where(is_diag, diag, jnp.where(is_gc, gap_col, gap_row))
        new_row = jnp.where(is_start, start_new, cell_sub + base)

        # column 0 special case
        c0 = cell_sub[:, 0] - sg5_pen
        new_row = new_row.at[:, 0].set(c0)
        new_row = jnp.where(mask, new_row, jnp.int32(HIM))

        snap = jnp.where((lengths - 1 == row)[:, None], new_row, snap)
        return (new_row, prev, rbest_val, snap), None

    (prev, prev2, rbest, snap), _ = jax.lax.scan(
        step, init, jax.lax.iota(jnp.int32, L - 1) + 1
    )
    return snap


def batch_last_row_rowsm(
    s1c: jax.Array,      # [B, W] per-read reference codes 0..4
    mask: jax.Array,     # [B, W] bool open columns per read
    row_sm: jax.Array,   # [B, L, 5] int32 per-row substitution score vectors
    lengths: jax.Array,  # [B] int32 read lengths (>=1)
    sg5: bool = True,
    n_rows: jax.Array | int | None = None,  # row bound; None = all L rows
) -> jax.Array:
    """:func:`batch_last_row` with the per-row substitution scores
    precomputed (``row_sm[b, r, i] = submat[depth(b,r), i, s2c[b,r]]``) —
    the form the entry-based device engine uses so per-entry PSSM selection
    (fw vs rc matrix) costs one gather instead of a second program.

    Rows 1..n_rows-1 run in a ``lax.fori_loop``; the bound must be at least
    ``max(lengths)`` (rows past every entry's last row change no snapshot).
    A traced bound skips those rows; None (all L rows) or a Python int is a
    fixed trip count, which JAX lowers to a ``lax.scan``.  Called inside the
    caller's jitted program (not jitted itself, so an int bound stays
    static)."""
    B, W = mask.shape
    L = row_sm.shape[1]
    cols = jax.lax.iota(jnp.int32, W)  # symbolic: no hoisted consts
    s1c2d = s1c

    cell0 = jnp.take_along_axis(row_sm[:, 0, :], s1c2d, axis=1)
    row0 = jnp.where(mask, cell0, jnp.int32(HIM))

    snap0 = row0  # snapshot if length == 1
    init = (row0, jnp.full_like(row0, _LOW), row0, snap0)

    upd_mask = jnp.concatenate([mask[:, 1:], jnp.zeros((B, 1), bool)], axis=1)

    def step(carry, row):
        prev, prev2, rbest_val, snap = carry

        row_sm_r = jax.lax.dynamic_index_in_dim(
            row_sm, row, axis=1, keepdims=False
        )  # [B, 5]
        cell_sub = jnp.take_along_axis(row_sm_r, s1c2d, axis=1)

        sg5_pen = jnp.int32(GOP) + jnp.int32(GEP) * (row + 1) if sg5 else jnp.int32(0)

        m = prev + GEP * cols[None, :]
        cand = jnp.full((B, W), _LOW, dtype=jnp.int32)
        cand = cand.at[:, : W - 2].set(jnp.where(mask[:, 2:], m[:, : W - 2], _LOW))
        cand = cand.at[:, 0].set(m[:, 0])
        run_max = jax.lax.cummax(cand, axis=1)
        gap_col = jnp.full((B, W), jnp.int32(HIM))
        gap_col = gap_col.at[:, 2:].set(
            run_max[:, : W - 2] - GOP - GEP * (cols[None, 2:] - 1)
        )

        def upd(rv):
            cand_r = prev2 + GEP * (row - 2)
            return jnp.where(upd_mask & (cand_r > rv), cand_r, rv)

        rbest_val = jax.lax.cond(row >= 2, upd, lambda rv: rv, rbest_val)
        gap_row = jnp.full((B, W), jnp.int32(HIM))
        gap_row = jnp.where(
            row >= 2,
            gap_row.at[:, 1:].set(rbest_val[:, :-1] - GOP - GEP * (row - 1)),
            gap_row,
        )

        diag = jnp.concatenate([jnp.full((B, 1), _LOW), prev[:, :-1]], axis=1)
        start_new = -sg5_pen if sg5 else jnp.int32(0)

        is_start = (
            (start_new > diag) & (start_new > gap_col) & (start_new > gap_row)
        )
        is_diag = (diag >= gap_col) & (diag >= gap_row)
        is_gc = gap_col >= gap_row
        base = jnp.where(is_diag, diag, jnp.where(is_gc, gap_col, gap_row))
        new_row = jnp.where(is_start, start_new, cell_sub + base)

        c0 = cell_sub[:, 0] - sg5_pen
        new_row = new_row.at[:, 0].set(c0)
        new_row = jnp.where(mask, new_row, jnp.int32(HIM))

        snap = jnp.where((lengths - 1 == row)[:, None], new_row, snap)
        return new_row, prev, rbest_val, snap

    if n_rows is None:
        n_rows = L
    if isinstance(n_rows, jax.Array):
        hi = jnp.minimum(n_rows, L).astype(jnp.int32)
    else:
        hi = min(n_rows, L)
    _, _, _, snap = jax.lax.fori_loop(1, hi, lambda r, c: step(c, r), init)
    return snap


# homopolymer ring-buffer depth: the hp row-gap candidate reads the score
# row where the read's current homopolymer run started (src/mia.c:895-905),
# so the device keeps the last HPW rows; reads containing a run of >= HPW
# bases are routed to the host engine by the caller (a work partition, not
# an approximation — such runs are vanishingly rare in real reads).  Single
# source of truth lives in core.jax_engine (importable without jax).
from ..core.jax_engine import HPW_ROUTE as HPW  # noqa: E402


@functools.partial(jax.jit, static_argnames=("sg5",))
def batch_last_row_hp(
    s1c: jax.Array,      # [B, W] int32 window reference codes 0..4
    s1chr: jax.Array,    # [B, W] int32 window reference CHARS (raw bytes)
    mask: jax.Array,     # [B, W] bool open columns per read
    row_sm: jax.Array,   # [B, L, 5] int32 per-row substitution score vectors
    lengths: jax.Array,  # [B] int32 read lengths (>=1)
    s2chr: jax.Array,    # [B, L] int32 read CHARS (pad 0)
    hpcs_w: jax.Array,   # [B, W] int32 GLOBAL homopolymer start col per window pos
    ws: jax.Array,       # [B] int32 window start (global col of window pos 0)
    pengop: jax.Array,   # [11] int32 truncated GOP*frac discount table
    sg5: bool = True,
) -> jax.Array:
    """:func:`batch_last_row_rowsm` plus the -h homopolymer-discounted gap
    options (src/mia.c:883-905, penalties src/map_align.c:1096-1135).

    The candidates need (a) char equality seq1[col]==seq2[row], (b) the
    previous row at the REFERENCE run start (a lane gather with a
    loop-invariant index), and (c) the score row where the READ's run
    started — served from an HPW-deep ring buffer of previous rows.
    Score-only (value semantics): the 6-way priority chain collapses to one
    max exactly as in the non-hp kernels.
    """
    B, W = mask.shape
    L = row_sm.shape[1]
    cols = jax.lax.iota(jnp.int32, W)
    gcols = ws[:, None] + cols[None, :]

    # read homopolymer runs from chars (pop_hpl_and_hps semantics; the 0-pad
    # byte differs from every base so runs never cross the read boundary)
    iotaL = jax.lax.iota(jnp.int32, L)
    changed = jnp.concatenate(
        [jnp.ones((B, 1), bool), s2chr[:, 1:] != s2chr[:, :-1]], axis=1
    )
    hprs = jax.lax.cummax(jnp.where(changed, iotaL[None, :], 0), axis=1)
    ends = jnp.concatenate(
        [s2chr[:, 1:] != s2chr[:, :-1], jnp.ones((B, 1), bool)], axis=1
    )
    hpre = jax.lax.cummin(
        jnp.where(ends, iotaL[None, :], jnp.int32(L)), axis=1, reverse=True
    )
    hprl = hpre - hprs + 1

    cell0 = jnp.take_along_axis(row_sm[:, 0, :], s1c, axis=1)
    row0 = jnp.where(mask, cell0, jnp.int32(HIM))

    hist0 = jnp.zeros((HPW, B, W), jnp.int32).at[0].set(row0)
    init = (row0, jnp.full_like(row0, _LOW), row0, row0, hist0)
    upd_mask = jnp.concatenate([mask[:, 1:], jnp.zeros((B, 1), bool)], axis=1)

    # loop-invariant hp_col gather index: prev[hpcs[col]-1-win_lo]
    hc_idx = jnp.clip(hpcs_w - 1 - ws[:, None], 0, W - 1)
    hc_ok_static = (hpcs_w != gcols) & (hpcs_w > 0) & (hpcs_w - 1 >= ws[:, None])
    hr_ok_static = hpcs_w == gcols
    gap_len = gcols - hpcs_w  # used only where the ok masks hold (> 0 there)

    def step(carry, row):
        prev, prev2, rbest_val, snap, hist = carry

        row_sm_r = jax.lax.dynamic_index_in_dim(row_sm, row, axis=1, keepdims=False)
        cell_sub = jnp.take_along_axis(row_sm_r, s1c, axis=1)
        sg5_pen = jnp.int32(GOP) + jnp.int32(GEP) * (row + 1) if sg5 else jnp.int32(0)

        m = prev + GEP * cols[None, :]
        cand = jnp.full((B, W), _LOW, dtype=jnp.int32)
        cand = cand.at[:, : W - 2].set(jnp.where(mask[:, 2:], m[:, : W - 2], _LOW))
        cand = cand.at[:, 0].set(m[:, 0])
        run_max = jax.lax.cummax(cand, axis=1)
        gap_col = jnp.full((B, W), jnp.int32(HIM))
        gap_col = gap_col.at[:, 2:].set(
            run_max[:, : W - 2] - GOP - GEP * (cols[None, 2:] - 1)
        )

        def upd(rv):
            cand_r = prev2 + GEP * (row - 2)
            return jnp.where(upd_mask & (cand_r > rv), cand_r, rv)

        rbest_val = jax.lax.cond(row >= 2, upd, lambda rv: rv, rbest_val)
        gap_row = jnp.full((B, W), jnp.int32(HIM))
        gap_row = jnp.where(
            row >= 2,
            gap_row.at[:, 1:].set(rbest_val[:, :-1] - GOP - GEP * (row - 1)),
            gap_row,
        )

        diag = jnp.concatenate([jnp.full((B, 1), _LOW), prev[:, :-1]], axis=1)
        start_new = -sg5_pen if sg5 else jnp.int32(0)

        # ---- homopolymer discounted gaps ----
        ch2 = s2chr[:, row][:, None]  # [B,1] read char this row
        same = s1chr == ch2
        hprs_r = hprs[:, row][:, None]  # [B,1]
        hprl_r = hprl[:, row]           # [B]
        pen = GEP * gap_len + pengop[jnp.clip(hprl_r - 1, 0, 10)][:, None]
        hp_col = jnp.where(
            same & (hprs_r == row) & hc_ok_static,
            jnp.take_along_axis(prev, hc_idx, axis=1) - pen,
            jnp.int32(HIM),
        )
        # read-run start row from the ring (guard: distance < HPW — callers
        # exclude longer runs)
        slot = jnp.clip(hprs_r[:, 0] - 1, 0, L) % HPW  # [B]
        src = jnp.take_along_axis(
            hist, jnp.broadcast_to(slot[None, :, None], (1, B, W)), axis=0
        )[0]
        src1 = jnp.concatenate([jnp.full((B, 1), jnp.int32(HIM)), src[:, :-1]], axis=1)
        hr_ok = (
            same
            & hr_ok_static
            & (hprs_r != row)
            & (hprs_r > 0)
            & (row - hprs_r < HPW)
            & (cols[None, :] >= 1)
        )
        hp_row = jnp.where(hr_ok, src1 - pen, jnp.int32(HIM))

        base = jnp.maximum(
            jnp.maximum(jnp.maximum(gap_col, gap_row), jnp.maximum(hp_col, hp_row)),
            diag,
        )
        new_row = jnp.where(start_new > base, start_new, cell_sub + base)
        c0 = cell_sub[:, 0] - sg5_pen
        new_row = new_row.at[:, 0].set(c0)
        new_row = jnp.where(mask, new_row, jnp.int32(HIM))

        snap = jnp.where((lengths - 1 == row)[:, None], new_row, snap)
        hist = jax.lax.dynamic_update_index_in_dim(hist, new_row, row % HPW, axis=0)
        return (new_row, prev, rbest_val, snap, hist), None

    (_, _, _, snap, _), _ = jax.lax.scan(
        step, init, jax.lax.iota(jnp.int32, L - 1) + 1
    )
    return snap


def depths_for(lengths: np.ndarray, L: int) -> np.ndarray:
    """Depth slot per (read, row), clipped for padded rows."""
    from ..constants import PSSM_DEPTH

    rows = np.arange(L)[None, :]
    ln = lengths[:, None]
    from_back = ln - (rows + 1)
    d = np.where(
        rows < PSSM_DEPTH,
        rows,
        np.where(from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back, PSSM_DEPTH),
    )
    return np.clip(d, 0, 2 * PSSM_DEPTH).astype(np.int32)


def batch_best_and_aec(last_rows: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-read (best_score, earliest argmax column) of the last DP row."""
    aec = jnp.argmax(last_rows, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(last_rows, aec[:, None], axis=1)[:, 0]
    return best, aec
