"""Batched JAX scorer must reproduce the exact host engine's last DP row,
best score and end column, bit for bit."""
import numpy as np
import pytest

from mia.core.driver import init_alignment, set_seq1, set_seq2
from mia.ops import dp_numpy as dpn
from mia.ops.pssm import init_flatsubmat


def _host_last_row(ref, read, sm, mask, sg5=True):
    a = init_alignment(256, len(ref) + 16, False, False)
    a.submat = sm
    set_seq1(a, ref)
    set_seq2(a, read)
    a.sg5 = sg5
    a.sg3 = True
    if mask is not None:
        a.align_mask[: len(ref)] = mask
    dpn.dyn_prog(a)
    full = np.full(len(ref), dpn.HIM if hasattr(dpn, "HIM") else -(2**31) // 2, np.int64)
    from mia.constants import HIM

    full[:] = HIM
    w = a.score.shape[1]
    full[a.col_off : a.col_off + w] = a.score[a.len2 - 1]
    best = dpn.max_sg_score(a)
    return full, best, a.aec


@pytest.mark.parametrize("seed", range(4))
def test_batch_matches_host(seed):
    import jax.numpy as jnp

    from mia.ops.dp_jax import batch_best_and_aec, batch_last_row, depths_for
    from mia.utils.encoding import encode_seq

    rng = np.random.default_rng(seed)
    W = 300
    L = 96
    ref = "".join(rng.choice(list("ACGT")) for _ in range(W))
    sm = init_flatsubmat() + rng.integers(-40, 40, (31, 5, 5)).astype(np.int32)

    B = 6
    reads = []
    masks = []
    for b in range(B):
        n = int(rng.integers(8, L))
        start = int(rng.integers(0, W - n))
        read = ref[start : start + n]
        # sprinkle mutations
        read = "".join(
            c if rng.random() > 0.08 else rng.choice(list("ACGT")) for c in read
        )
        reads.append(read)
        if b % 2 == 0:
            masks.append(np.ones(W, dtype=bool))
        else:
            m = np.zeros(W, dtype=bool)
            m[max(start - 20, 0) : start + n + 20] = True
            masks.append(m)

    lengths = np.array([len(r) for r in reads], dtype=np.int32)
    s2c = np.full((B, L), 4, dtype=np.int32)
    for b, r in enumerate(reads):
        s2c[b, : len(r)] = encode_seq(r)
    s1c = encode_seq(ref).astype(np.int32)
    depths = depths_for(lengths, L)

    last = np.asarray(
        batch_last_row(
            jnp.asarray(s1c),
            jnp.asarray(np.stack(masks)),
            jnp.asarray(s2c),
            jnp.asarray(lengths),
            jnp.asarray(depths),
            jnp.asarray(sm),
            sg5=True,
        )
    )
    best, aec = (np.asarray(x) for x in batch_best_and_aec(jnp.asarray(last)))

    for b in range(B):
        full, hbest, haec = _host_last_row(ref, reads[b], sm, masks[b])
        np.testing.assert_array_equal(last[b], full, err_msg=f"read {b} last row")
        assert best[b] == hbest
        assert aec[b] == haec
