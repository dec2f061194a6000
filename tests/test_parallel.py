"""Sharded assembly step on the virtual 8-device CPU mesh: psum-merged
consensus must equal the single-device computation."""
import numpy as np

import jax
import jax.numpy as jnp

from mia.ops.dp_jax import batch_best_and_aec, batch_last_row, depths_for
from mia.ops.pssm import init_flatsubmat, revcom_submat
from mia.parallel.sharded import (
    consensus_from_counts,
    make_assembly_step,
    make_mesh,
)
from mia.utils.encoding import encode_seq


def _mk_inputs(B=16, W=384, L=32, seed=0):
    rng = np.random.default_rng(seed)
    ref = "".join(rng.choice(list("ACGT")) for _ in range(W))
    reads = []
    for _ in range(B):
        n = int(rng.integers(8, L))
        s = int(rng.integers(0, W - n))
        reads.append(
            "".join(
                c if rng.random() > 0.05 else rng.choice(list("ACGT"))
                for c in ref[s : s + n]
            )
        )
    lengths = np.array([len(r) for r in reads], np.int32)
    s2c = np.full((B, L), 4, np.int32)
    for b, r in enumerate(reads):
        s2c[b, : len(r)] = encode_seq(r)
    s1c = encode_seq(ref).astype(np.int32)
    return s1c, s2c, lengths


def test_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_step_matches_single_device():
    B, W, L = 16, 384, 32
    s1c, s2c, lengths = _mk_inputs(B, W, L)
    depths = depths_for(lengths, L)
    fpsm = init_flatsubmat()
    rpsm = revcom_submat(fpsm)
    mask = np.ones((B, W), bool)

    mesh = make_mesh(n_dp=4, n_sp=2)
    step = make_assembly_step(mesh)
    best_s, aec_s, cons_s = step(
        jnp.asarray(s1c),
        jnp.asarray(mask),
        jnp.asarray(s2c),
        jnp.asarray(lengths),
        jnp.asarray(depths),
        jnp.asarray(fpsm.astype(np.int32)),
        jnp.asarray(rpsm.astype(np.int32)),
    )

    # single-device reference
    last = batch_last_row(
        jnp.asarray(s1c),
        jnp.asarray(mask),
        jnp.asarray(s2c),
        jnp.asarray(lengths),
        jnp.asarray(depths),
        jnp.asarray(fpsm.astype(np.int32)),
        sg5=True,
    )
    best1, aec1 = batch_best_and_aec(last)
    np.testing.assert_array_equal(np.asarray(best_s), np.asarray(best1))
    np.testing.assert_array_equal(np.asarray(aec_s), np.asarray(aec1))

    # rebuild the consensus with plain numpy scatter-adds
    starts = np.asarray(aec1) - lengths + 1
    counts = np.zeros((W, 5), np.int64)
    scores = np.zeros((W, 4), np.int64)
    for b in range(B):
        for r in range(int(lengths[b])):
            c = starts[b] + r
            if 0 <= c < W:
                base = s2c[b, r]
                counts[c, base] += 1
                scores[c] += fpsm[depths[b, r], :4, base]
    cons1 = np.asarray(
        consensus_from_counts(jnp.asarray(counts.astype(np.int32)),
                              jnp.asarray(scores.astype(np.int32)))
    )
    np.testing.assert_array_equal(np.asarray(cons_s), cons1)


def test_mesh_uses_all_devices():
    mesh = make_mesh(n_dp=8, n_sp=1)
    assert mesh.shape == {"dp": 8, "sp": 1}


def test_mesh_scorer_matches_single_device():
    """The PRODUCTION dp-sharded entry scorer (jax_engine._mesh_fn) must
    return exactly the single-device results."""
    import jax
    from jax.sharding import Mesh

    import mia.core.jax_engine as je
    from mia.ops.pssm import init_flatsubmat, revcom_submat

    rng = np.random.default_rng(5)
    len1 = 700
    fw = rng.integers(0, 4, len1).astype(np.int8)
    rc = rng.integers(0, 4, len1).astype(np.int8)
    fpsm = init_flatsubmat().astype(np.int32)
    rpsm = revcom_submat(fpsm).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))

    single = je.Pass1Scorer(fw, rc, len1, fpsm, rpsm, batch=32, warm=False)
    sharded = je.Pass1Scorer(
        fw, rc, len1, fpsm, rpsm, batch=32, mesh=mesh, warm=False
    )

    n = 48
    ref_sel = rng.integers(0, 2, n).astype(np.int8)
    smidx = rng.integers(0, 2, n).astype(np.int8)
    lens = rng.integers(8, 60, n).astype(np.int32)
    starts = rng.integers(0, len1 - je.WIN_W + 1, n).astype(np.int32)
    ivl = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
    ivl[:, 0, 0] = 2
    ivl[:, 0, 1] = rng.integers(80, je.WIN_W, n)
    s2c = rng.integers(0, 5, (n, je.L_MAX)).astype(np.int8)

    b1, a1 = single.collect_entries(
        single.dispatch_entries(ref_sel, starts, ivl, s2c, lens, smidx)
    )
    b2, a2 = sharded.collect_entries(
        sharded.dispatch_entries(ref_sel, starts, ivl, s2c, lens, smidx)
    )
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(a1, a2)


def test_mesh_scorer_after_warm_plain_scorer():
    """Regression: dispatching a single-device program twice (warming jit's
    C++ fastpath) and THEN dispatching a dp-mesh scorer used to crash inside
    jax arg sharding (AssertionError (1, 3) / "supplied 8 buffers but
    compiled program expected 9") — trace-time concrete constants were being
    hoisted as executable parameters.  This is the exact ordering
    bench._mesh_scaling runs."""
    import jax
    from jax.sharding import Mesh

    import mia.core.jax_engine as je
    from mia.ops.pssm import init_flatsubmat

    rng = np.random.default_rng(11)
    len1 = 700
    fw = rng.integers(0, 4, len1).astype(np.int8)
    sm = init_flatsubmat().astype(np.int32)

    def mkargs(n):
        ref_sel = rng.integers(0, 2, n).astype(np.int8)
        smidx = np.zeros(n, np.int8)
        lens = rng.integers(8, 60, n).astype(np.int32)
        starts = rng.integers(0, len1 - je.WIN_W + 1, n).astype(np.int32)
        ivl = np.zeros((n, je.MAX_INTERVALS, 2), np.int32)
        ivl[:, 0, 0] = 2
        ivl[:, 0, 1] = rng.integers(80, je.WIN_W, n)
        s2c = rng.integers(0, 5, (n, je.L_MAX)).astype(np.int8)
        return ref_sel, starts, ivl, s2c, lens, smidx

    plain = je.Pass1Scorer(fw, fw, len1, sm, batch=32, warm=False)
    args = mkargs(48)
    for _ in range(2):  # second call engages the C++ fastpath
        plain.collect_entries(plain.dispatch_entries(*args))

    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    sharded = je.Pass1Scorer(fw, fw, len1, sm, batch=32, mesh=mesh, warm=False)
    for _ in range(2):
        b2, a2 = sharded.collect_entries(sharded.dispatch_entries(*args))
    b1, a1 = plain.collect_entries(plain.dispatch_entries(*args))
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(a1, a2)


def test_device_consensus_counts_bit_equal_host():
    """ops/consensus_device accumulation == host ColumnCounts.add_bases over
    the same record set, single-device and dp-mesh (psum) variants."""
    import jax
    from jax.sharding import Mesh

    from mia.core.columns import _record_arrays, main_column_counts
    from mia.core.types import AlnSeq, MapAlignment
    from mia.ops.consensus_device import device_column_counts
    from mia.ops.pssm import init_flatsubmat, revcom_submat

    rng = np.random.default_rng(5)
    n = 300
    maln = MapAlignment()
    maln.ref.seq_len = n
    maln.fpsm = init_flatsubmat().astype(np.int64)
    maln.rpsm = revcom_submat(maln.fpsm)
    recs = []
    for i in range(400):
        ln = int(rng.integers(5, 60))
        start = int(rng.integers(-5, n - 5))  # some out-of-range columns
        seq = "".join(rng.choice(list("ACGT-N"), ln))
        smp = "".join(chr(ord("A") + int(d)) for d in rng.integers(0, 31, ln))
        recs.append(
            AlnSeq(
                id=f"r{i}", seq=seq, smp=smp, start=start,
                end=start + ln - 1, revcom=bool(rng.integers(0, 2)),
                dropped=bool(rng.random() < 0.1),
            )
        )
    maln.set_aln_seqs(recs)

    host = main_column_counts(maln, exclude_dropped=True)
    arrays = _record_arrays(maln, exclude_dropped=True)
    _, spans, starts, revs, seq_a, smp_a, seq_off, smp_off = arrays

    for mesh in (None, Mesh(np.array(jax.devices()[:4]), ("dp",))):
        counts, cov, scores = device_column_counts(
            seq_a, smp_a, starts, spans, seq_off, smp_off, revs,
            maln.fpsm, maln.rpsm, n, mesh=mesh,
        )
        np.testing.assert_array_equal(counts, host.counts)
        np.testing.assert_array_equal(cov, host.cov)
        np.testing.assert_array_equal(scores, host.scores)
