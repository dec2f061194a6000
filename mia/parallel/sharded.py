"""Multi-chip execution: data-parallel read scoring + psum-merged consensus.

Mapping (SURVEY §2/§5): the reference's per-read loop is embarrassingly
parallel, so reads shard across chips on a ``dp`` mesh axis while the
reference codes, PSSMs and consensus state replicate; per-column BaseCounts
accumulate locally and merge with one ``psum`` over ``dp``; the consensus
decision then runs sequence-parallel over an ``sp`` axis (columns sharded),
and the called consensus gathers back to every chip — collectives run
between devices, only read batches stream from host.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import GEP, GOP, HIM, MIN_SCORE_CONS, PERC4GAP
from ..ops.dp_jax import batch_last_row


def make_mesh(n_dp: int | None = None, n_sp: int = 1, devices=None) -> Mesh:
    """1- or 2-axis device mesh: ``dp`` shards read batches, ``sp`` shards
    consensus columns."""
    devices = np.array(jax.devices() if devices is None else devices)
    if n_dp is None:
        n_dp = len(devices) // n_sp
    devices = devices[: n_dp * n_sp].reshape(n_dp, n_sp)
    return Mesh(devices, axis_names=("dp", "sp"))


def consensus_from_counts(counts: jax.Array, scores: jax.Array) -> jax.Array:
    """Device-side find_consensus (cons_code 1) over columns: counts [W,5]
    (A,C,G,T,gap), scores [W,4]; returns uint8 consensus chars
    (semantics of src/map_align.c:294-391)."""
    cov = counts.sum(axis=1)
    gap_frac_ok = counts[:, 4] * 100 >= PERC4GAP * cov
    top0 = scores[:, 0]
    max_base = jnp.full(cov.shape, ord("A"), jnp.int32)
    for b, ch in ((1, ord("C")), (2, ord("G")), (3, ord("T"))):
        promote = scores[:, b] >= top0
        top0 = jnp.where(promote, scores[:, b], top0)
        max_base = jnp.where(promote, ch, max_base)
    base = jnp.where(top0 >= MIN_SCORE_CONS, max_base, ord("N"))
    out = jnp.where(cov == 0, ord("N"), jnp.where(gap_frac_ok, ord("-"), base))
    return out.astype(jnp.uint8)


def _pileup_counts(
    s2c: jax.Array,      # [B, L]
    lengths: jax.Array,  # [B]
    starts: jax.Array,   # [B] alignment start column per read
    depths: jax.Array,   # [B, L]
    strands: jax.Array,  # [B] bool
    fpsm: jax.Array,
    rpsm: jax.Array,
    W: int,
):
    """Scatter-add ungapped pileup contributions into per-column counts and
    PSSM-weighted scores — the device half of add_base
    (src/map_align.c:229-263)."""
    B, L = s2c.shape
    rows = jnp.arange(L)[None, :]
    cols = starts[:, None] + rows  # [B, L]
    valid = (rows < lengths[:, None]) & (cols >= 0) & (cols < W)
    cols_c = jnp.clip(cols, 0, W - 1)

    base = s2c  # 0..4 codes; 4 = N/other
    onehot = jax.nn.one_hot(base, 5, dtype=jnp.int32) * valid[:, :, None]
    counts = jnp.zeros((W, 5), jnp.int32).at[cols_c.reshape(-1)].add(
        onehot.reshape(-1, 5)
    )

    # score contributions: psm[depth, x, base] for x in 0..3, strand-selected
    contrib_f = jnp.take_along_axis(
        fpsm[depths], base[:, :, None, None], axis=3
    )[:, :, :4, 0]
    contrib_r = jnp.take_along_axis(
        rpsm[depths], base[:, :, None, None], axis=3
    )[:, :, :4, 0]
    contrib = jnp.where(strands[:, None, None], contrib_r, contrib_f)
    contrib = contrib * valid[:, :, None]
    scores = jnp.zeros((W, 4), jnp.int32).at[cols_c.reshape(-1)].add(
        contrib.reshape(-1, 4)
    )
    return counts, scores


def make_assembly_step(mesh: Mesh, sg5: bool = True):
    """Build the sharded one-iteration assembly step.

    Per step: (1) every dp shard scores its read batch against the replicated
    reference with the batched DP kernel; (2) reads pile into per-column
    counts/score sums; (3) counts psum-merge over ``dp``; (4) the consensus
    call runs on ``sp``-sharded column blocks; (5) the consensus string
    all-gathers so every chip holds the next reference.  Returns a jitted
    function."""

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(),            # s1c [W]
            P("dp", None),  # mask [B, W]
            P("dp", None),  # s2c [B, L]
            P("dp"),        # lengths [B]
            P("dp", None),  # depths [B, L]
            P(),            # fpsm
            P(),            # rpsm
        ),
        out_specs=(P("dp"), P("dp"), P()),
        check_vma=False,
    )
    def step(s1c, mask, s2c, lengths, depths, fpsm, rpsm):
        W = s1c.shape[0]
        last = batch_last_row(s1c, mask, s2c, lengths, depths, fpsm, sg5=sg5)
        aec = jnp.argmax(last, axis=1).astype(jnp.int32)
        best = jnp.take_along_axis(last, aec[:, None], axis=1)[:, 0]

        # ungapped placement ending at aec; strand fixed fw for the device
        # pileup (host pipeline refines via traceback)
        starts = aec - lengths + 1
        strands = jnp.zeros_like(lengths, dtype=bool)
        counts, scores = _pileup_counts(
            s2c, lengths, starts, depths, strands, fpsm, rpsm, W
        )
        counts = jax.lax.psum(counts, "dp")
        scores = jax.lax.psum(scores, "dp")

        # sequence-parallel consensus: each sp shard handles a column block
        sp = jax.lax.axis_size("sp")
        idx = jax.lax.axis_index("sp")
        blk = W // sp
        c_blk = jax.lax.dynamic_slice_in_dim(counts, idx * blk, blk, 0)
        s_blk = jax.lax.dynamic_slice_in_dim(scores, idx * blk, blk, 0)
        cons_blk = consensus_from_counts(c_blk, s_blk)
        tail = consensus_from_counts(counts[sp * blk :], scores[sp * blk :])
        cons = jnp.concatenate(
            [jax.lax.all_gather(cons_blk, "sp", tiled=True), tail]
        )
        return best, aec, cons

    return jax.jit(step)


def shard_batch(mesh: Mesh, arr: np.ndarray, spec: P) -> jax.Array:
    return jax.device_put(arr, NamedSharding(mesh, spec))
