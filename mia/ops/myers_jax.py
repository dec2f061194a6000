"""Myers O(ND) diff aligner as a jitted device wavefront.

Reference: myers_diff (/root/reference/src/myers_align.c:10-99), used by
ccheck for the one big global alignment of the assembly consensus against
the contaminant panel (~16.5 kb vs ~16.5 kb, maxd = len/10).

Device formulation: the D-wave loop is a ``lax.while_loop`` whose carry is
the furthest-reaching x per diagonal (V, one lane per diagonal), so every
diagonal of a wave extends simultaneously.  The data-dependent "snake"
(match-run extension) is replaced by one gather into a precomputed
run-length table R[k, x] = length of the IUPAC-matching run starting at
(x, y = x - k) — built once as a reversed cummin over the diagonal match
matrix.  Wave history lands in a [maxd+1, n_diag] buffer; the backtrace
walks it on host with EXACTLY the host aligner's rules, so (distance,
bt_a, bt_b) are string-identical to :func:`mia.ops.myers.myers_diff`.

The found wave stops at the same (d, smallest k) the host's ascending k scan
would report, because the accept condition depends only on that diagonal's
own (x, y).
"""
from __future__ import annotations

import functools

import numpy as np

from ..utils.encoding import bitmap_seq
from .myers import Mode, UINT_MAX, _backtrace

_NEG = np.int32(-(2**30))


@functools.partial(
    __import__("jax").jit, static_argnames=("maxd", "mode_is_prefix", "mode_has_prefix")
)
def _waves(bm_a, bm_b, len_a, len_b, *, maxd: int, mode_is_prefix: bool,
           mode_has_prefix: bool):
    """Run up to ``maxd`` waves; returns (found_d, found_k, V_history).

    V_history[d, k + maxd] = furthest x on diagonal k after wave d (the same
    values the host's vee list holds); found_d == maxd means no alignment.
    """
    import jax
    import jax.numpy as jnp

    n_diag = 2 * maxd + 1
    ks = jnp.arange(-maxd, maxd + 1, dtype=jnp.int32)  # diagonal of lane i

    # R[k_idx, x]: matching-run length starting at (x, y = x - k); 0 where
    # out of range or mismatch.  match[k,x] = bm_b[x] & bm_a[x-k] != 0.
    LB = bm_b.shape[0]
    xs = jnp.arange(LB, dtype=jnp.int32)[None, :]
    ys = xs - ks[:, None]
    in_rng = (xs < len_b) & (ys >= 0) & (ys < len_a)
    ys_c = jnp.clip(ys, 0, bm_a.shape[0] - 1)
    match = in_rng & ((bm_b[None, :] & bm_a[ys_c]) != 0)
    # next mismatch at or after x, per diagonal: reversed cummin of masked x
    nxt = jnp.where(~match, xs, jnp.int32(LB))
    next0 = jnp.flip(jax.lax.cummin(jnp.flip(nxt, axis=1), axis=1), axis=1)
    R = (next0 - xs).astype(jnp.int32)  # [n_diag, LB]

    def snake(x):
        # extend each diagonal's x by its match run (one gather per lane)
        xc = jnp.clip(x, 0, LB - 1)
        run = jnp.take_along_axis(R, xc[:, None].astype(jnp.int32), axis=1)[:, 0]
        ok = (x >= 0) & (x < LB)
        return jnp.where(ok, x + run, x)

    def accept(x, d):
        # reference accept rule + the y <= len_a guard (see ops.myers:
        # IS_PREFIX accepts with y > len_a are reference UB, skipped)
        y = x - ks
        valid = (ks >= jnp.maximum(-d, -len_a)) & (ks <= jnp.minimum(d, len_b))
        ok_a = jnp.bool_(mode_is_prefix) | (y == len_a)
        ok_b = jnp.bool_(mode_has_prefix) | (x == len_b)
        return valid & ok_a & ok_b & (y <= len_a)

    hist0 = jnp.full((maxd + 1, n_diag), _NEG, jnp.int32)

    # wave 0: x = snake from 0 on diagonal 0
    x0 = jnp.where(ks == 0, 0, _NEG)
    x0 = jnp.where(ks == 0, snake(x0), x0)
    hist0 = hist0.at[0].set(x0)
    acc0 = accept(x0, 0)
    k0 = jnp.where(acc0.any(), jnp.argmax(acc0) - maxd, jnp.int32(maxd + 1))
    d0 = jnp.where(acc0.any(), jnp.int32(0), jnp.int32(maxd))

    def cond(state):
        d, found_d, _, _, _ = state
        return (found_d >= maxd) & (d < maxd)

    def body(state):
        d, found_d, found_k, v, hist = state
        # candidates from the previous wave (reference index juggling,
        # src/myers_align.c:20-38): down = v[k+1], right = v[k-1]+1,
        # straight = v[k]+1 (the d==1,k==0 special case folds into these
        # because out-of-range lanes hold -inf)
        up = jnp.concatenate([v[1:], jnp.full((1,), _NEG, jnp.int32)])
        down = jnp.concatenate([jnp.full((1,), _NEG, jnp.int32), v[:-1]])
        inner = (ks > -d) & (ks < d)
        x = jnp.maximum(
            jnp.where(ks > -d, down + 1, _NEG),
            jnp.maximum(jnp.where(ks < d, up, _NEG),
                        jnp.where(inner, v + 1, _NEG)),
        )
        valid = (ks >= jnp.maximum(-d, -len_a)) & (ks <= jnp.minimum(d, len_b))
        x = jnp.where(valid, x, _NEG)
        x = snake(x)
        hist = hist.at[d].set(x)
        acc = accept(x, d)
        hit = acc.any()
        found_d = jnp.where(hit, d, found_d)
        found_k = jnp.where(hit, jnp.argmax(acc) - maxd, found_k)
        return d + 1, found_d, found_k, x, hist

    _, found_d, found_k, _, hist = jax.lax.while_loop(
        cond, body, (jnp.int32(1), d0, k0, x0, hist0)
    )
    return found_d, found_k, hist


def myers_diff_jax(seq_a: str, mode: Mode, seq_b: str, maxd: int):
    """Drop-in replacement for :func:`mia.ops.myers.myers_diff` with the
    wave computation on the device; identical return values."""
    len_a, len_b = len(seq_a), len(seq_b)
    maxd = min(maxd, len_a + len_b)
    if maxd <= 0:
        return UINT_MAX, "", ""
    bm_a = np.asarray(bitmap_seq(seq_a), np.int32)
    bm_b = np.asarray(bitmap_seq(seq_b), np.int32)
    if len(bm_b) == 0:
        bm_b = np.zeros(1, np.int32)
    if len(bm_a) == 0:
        bm_a = np.zeros(1, np.int32)
    found_d, found_k, hist = _waves(
        bm_a, bm_b, np.int32(len_a), np.int32(len_b),
        maxd=int(maxd),
        mode_is_prefix=(mode == Mode.IS_PREFIX),
        mode_has_prefix=(mode == Mode.HAS_PREFIX),
    )
    d = int(found_d)
    if d >= maxd and not (d < maxd):
        # re-check wave maxd-1 acceptance encoding: found_d==maxd => none
        if int(found_d) == maxd:
            return UINT_MAX, "", ""
    k = int(found_k)
    hist = np.asarray(hist)
    # vee[d] layout on host: index k+d over 2d+1 entries
    vee = [hist[dd, maxd - dd : maxd + dd + 1] for dd in range(d + 1)]
    x = int(hist[d, k + maxd])
    y = x - k
    bt_a, bt_b = _backtrace(seq_a, seq_b, vee, d, k, x, y)
    return d, bt_a, bt_b
