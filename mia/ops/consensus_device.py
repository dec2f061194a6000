"""Device-side consensus accumulation (the production psum path).

The reference's consensus hotspot is ``add_base`` — every aligned base
contributes one-hot counts, a coverage tick and four PSSM-weighted score
terms to its column (src/map_align.c:229-263; the O(ref_len x num_reads)
rescan loop src/mia.c:551-599).  Here the whole accumulation is ONE jitted
scatter-add over the flattened observation stream, fed directly from the
per-record arena layout the host assembly state already keeps:

    record r, offset k  ->  column starts[r]+k, char seq[seq_off[r]+k],
                            depth smp[smp_off[r]+k]-'A', strand revs[r]

Integer-exact and order-independent, so device counts equal the host
accumulators bit-for-bit; the O(ref_len) consensus decision stays on host
(find_consensus semantics live in ops/consensus.py).

Under a mesh the observation stream shards across ``dp`` and the
accumulators merge with one ``jax.lax.psum`` — the BaseCounts merge SURVEY
§5 names, shared with :mod:`mia.parallel.sharded`.

int32 bounds: score terms are |s| <= ~1200 per base and <= 1 observation
per read per column, so sums stay below 2^31 for any read set up to ~1M
reads (BASELINE config 5); callers guard larger inputs to the host path.
"""
from __future__ import annotations

import functools

import numpy as np

# observation-stream capacity buckets (static jit shapes)
_BUCKETS = (1 << 18, 1 << 20, 1 << 22, 1 << 23, 1 << 24)


def fits(total: int, ndev: int = 1) -> bool:
    """True when ``total`` observations over ``ndev`` shards fit the largest
    stream bucket (larger streams accumulate on the host)."""
    return total + ndev * 256 <= _BUCKETS[-1]


def bucket(total: int) -> int:
    for b in _BUCKETS:
        if total <= b:
            return b
    raise ValueError(f"observation stream too large for device path: {total}")


# shapes whose jitted program has completed at least one real call in this
# process — callers can steal to the host path instead of blocking on a
# cold compile (serve.py's nowait consensus op)
_WARM: set = set()


def shape_key(total: int, R: int, n: int, ndev: int = 1) -> tuple:
    """The static-shape bucket (TCs, RCg, n, ndev) a call with this input
    size resolves to (must mirror device_column_counts's padding)."""
    TC = bucket(max(total + ndev * 256, 1))
    if TC % ndev:
        TC += ndev - TC % ndev
    RCg = 1
    while RCg < R + 1:
        RCg *= 2
    return (TC // ndev, RCg, int(n), ndev)


def is_warm(total: int, R: int, n: int, ndev: int = 1) -> bool:
    return shape_key(total, R, n, ndev) in _WARM


@functools.lru_cache(maxsize=None)
def _accum_fn(TC: int, RC: int, n: int, mesh_key=None):
    """Jitted accumulator for a (stream cap, record cap, columns) bucket.

    Returns fn(seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm)
    -> (counts [n,5] i32, cov [n] i32, scores [n,4] i32).
    ``mesh_key`` (an optional jax Mesh) shards the stream over its ``dp``
    axis and psums the accumulators.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    from .consensus import _BASE_IDX, _SUB_IDX

    base_idx = jnp.asarray(_BASE_IDX.astype(np.int32))
    sub_idx = jnp.asarray(_SUB_IDX.astype(np.int32))

    def core(seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm):
        RCl = spans.shape[0]
        ridx = jnp.repeat(
            lax.iota(jnp.int32, RCl), spans, total_repeat_length=TC
        )
        run0 = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(spans)[:-1].astype(jnp.int32)]
        )
        within = lax.iota(jnp.int32, TC) - run0[ridx]
        cols = starts[ridx] + within
        # out-of-range columns (and the trailing capacity-filler record)
        # scatter into trash column n
        valid = (cols >= 0) & (cols < n)
        colc = jnp.where(valid, cols, n)
        # explicit clamp: the capacity-filler record walks past the arena
        # end (its contributions land in the trash column regardless)
        si = jnp.minimum(seq_off[ridx] + within, seq.shape[0] - 1)
        mi = jnp.minimum(smp_off[ridx] + within, smp.shape[0] - 1)
        ch = seq[si].astype(jnp.int32)
        d = jnp.clip(smp[mi].astype(jnp.int32) - ord("A"), 0, 30)
        s = revs[ridx].astype(jnp.int32)

        cls = base_idx[ch]  # A,C,G,T,- -> 0..4; other -> -1 (not counted)
        counts = (
            jnp.zeros((n + 1) * 5, jnp.int32)
            .at[colc * 5 + jnp.clip(cls, 0, 4)]
            .add(jnp.where(cls >= 0, 1, 0))
            .reshape(n + 1, 5)
        )
        cov = jnp.zeros(n + 1, jnp.int32).at[colc].add(1)

        # lut[strand, depth, read_sub, cand] per add_base's strand-specific
        # matrix choice (src/map_align.c:240-254)
        lut = jnp.stack(
            [
                jnp.transpose(fpsm[:, :4, :], (0, 2, 1)),
                jnp.transpose(rpsm[:, :4, :], (0, 2, 1)),
            ]
        ).astype(jnp.int32)
        sub = sub_idx[ch]
        nongap = (ch != ord("-")).astype(jnp.int32)
        contrib = lut[s, d, sub] * nongap[:, None]  # [TC, 4]
        scores = jnp.zeros((n + 1, 4), jnp.int32).at[colc].add(contrib)
        if mesh_key is not None:
            counts = lax.psum(counts, "dp")
            cov = lax.psum(cov, "dp")
            scores = lax.psum(scores, "dp")
        return counts[:n], cov[:n], scores[:n]

    if mesh_key is None:
        return jax.jit(core)

    from jax.sharding import PartitionSpec as P

    sharded = jax.shard_map(
        core,
        mesh=mesh_key,
        in_specs=(
            P(), P(),            # arenas replicated (offsets are global)
            P("dp"), P("dp"), P("dp"), P("dp"), P("dp"),  # per-record
            P(), P(),            # PSSMs replicated
        ),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def device_column_counts(
    seq_arena: np.ndarray,
    smp_arena: np.ndarray,
    starts: np.ndarray,
    spans: np.ndarray,
    seq_off: np.ndarray,
    smp_off: np.ndarray,
    revs: np.ndarray,
    fpsm: np.ndarray,
    rpsm: np.ndarray,
    n: int,
    mesh=None,
):
    """Pad the record set to bucketed static shapes and run the jitted
    accumulator in-process.  Returns (counts, cov, scores) int64 ndarrays —
    bit-equal to ColumnCounts.add_bases over the same observations.

    With a mesh the records are grouped into one contiguous block per
    ``dp`` shard, each block padded (capacity-filler record -> trash
    column) so its spans sum to exactly the per-shard stream capacity —
    the shard_map P("dp") split then lines up with the per-shard
    ``jnp.repeat`` totals."""
    total = int(spans.sum())
    R = len(spans)
    ndev = 1 if mesh is None else int(mesh.devices.size)
    # greedy per-shard packing wastes < 256 obs per shard boundary
    TC = bucket(max(total + ndev * 256, 1))
    if TC % ndev:
        TC += ndev - TC % ndev
    TCs = TC // ndev

    # assign records to shards: contiguous greedy fill up to TCs each
    groups: list[list[int]] = [[] for _ in range(ndev)]
    sums = [0] * ndev
    g = 0
    for r in range(R):
        if sums[g] + int(spans[r]) > TCs:
            g += 1
            assert g < ndev, "greedy shard packing overflow"
        groups[g].append(r)
        sums[g] += int(spans[r])
    RCg = 1
    while RCg < max(len(gr) for gr in groups) + 1:
        RCg *= 2
    RC = ndev * RCg

    spans_p = np.zeros(RC, np.int32)
    starts_p = np.full(RC, n, np.int32)
    seq_off_p = np.zeros(RC, np.int32)
    smp_off_p = np.zeros(RC, np.int32)
    revs_p = np.zeros(RC, np.int8)
    for g, gr in enumerate(groups):
        base = g * RCg
        idx = np.asarray(gr, np.int64)
        m = len(gr)
        if m:
            spans_p[base : base + m] = spans[idx]
            starts_p[base : base + m] = starts[idx]
            seq_off_p[base : base + m] = seq_off[idx]
            smp_off_p[base : base + m] = smp_off[idx]
            revs_p[base : base + m] = np.asarray(revs, np.int8)[idx]
        # per-group capacity filler -> trash column (starts stay at n)
        spans_p[base + m] = TCs - sums[g]
    seq_p = np.ascontiguousarray(seq_arena, np.uint8)
    smp_p = np.ascontiguousarray(smp_arena, np.uint8)
    if len(seq_p) == 0:
        seq_p = np.zeros(1, np.uint8)
    if len(smp_p) == 0:
        smp_p = np.full(1, ord("A"), np.uint8)

    # static-shape key: per-SHARD stream/record capacities (the shard_map
    # split hands each device one contiguous group)
    fn = _accum_fn(TCs, RCg, int(n), mesh)
    counts, cov, scores = fn(
        seq_p,
        smp_p,
        starts_p,
        spans_p,
        seq_off_p,
        smp_off_p,
        revs_p,
        np.asarray(fpsm, np.int32),
        np.asarray(rpsm, np.int32),
    )
    out = (
        np.asarray(counts).astype(np.int64),
        np.asarray(cov).astype(np.int64),
        np.asarray(scores).astype(np.int64),
    )
    # warm means "one real call COMPLETED" — marked only after the device
    # results materialise, so nowait callers never block behind an
    # in-flight (or failed) first compile
    _WARM.add((TCs, RCg, int(n), ndev))
    return out
