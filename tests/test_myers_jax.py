"""The jitted Myers wavefront must reproduce the host aligner exactly:
distance AND backtrace strings, across modes, IUPAC ambiguity and
no-alignment-within-maxd cases (ccheck's aligner, src/myers_align.c:10-99)."""
import numpy as np
import pytest

from mia.ops.myers import Mode, UINT_MAX, myers_diff
from mia.ops.myers_jax import myers_diff_jax

_ALPHA = list("ACGT")
_IUPAC = list("ACGTRYSWKMN")


def _mutate(rng, s, sub=0.05, indel=0.03, alpha=_ALPHA):
    out = []
    for ch in s:
        r = rng.random()
        if r < indel / 2:
            continue
        if r < indel:
            out.append(str(rng.choice(alpha)))
        if rng.random() < sub:
            out.append(str(rng.choice(alpha)))
        else:
            out.append(ch)
    return "".join(out)


@pytest.mark.parametrize("mode", list(Mode))
def test_myers_jax_matches_host(mode):
    """All three modes; both implementations share the y <= len_a accept
    guard (the reference's y > len_a IS_PREFIX accepts are UB its own ccheck
    never exercises — it only uses GLOBAL, src/ccheck.cc:480)."""
    rng = np.random.default_rng(17)
    compared = 0
    for trial in range(14):
        n = int(rng.integers(20, 200))
        a = "".join(rng.choice(_ALPHA, n))
        b = _mutate(rng, a)
        if mode == Mode.IS_PREFIX:
            b = b + "".join(rng.choice(_ALPHA, int(rng.integers(0, 10))))
        elif mode == Mode.HAS_PREFIX:
            a = a + "".join(rng.choice(_ALPHA, int(rng.integers(0, 10))))
        maxd = max(8, (len(a) + len(b)) // 8)
        want = myers_diff(a, mode, b, maxd)
        got = myers_diff_jax(a, mode, b, maxd)
        assert got == want, (mode, trial, a[:20], b[:20])
        compared += 1
    assert compared >= 8


def test_myers_jax_iupac_and_failure():
    rng = np.random.default_rng(3)
    # IUPAC-ambiguous panel sequence vs concrete reads
    a = "".join(rng.choice(_IUPAC, 120))
    b = "".join(rng.choice(_ALPHA, 118))
    for maxd in (4, 30, 120):
        want = myers_diff(a, Mode.GLOBAL, b, maxd)
        got = myers_diff_jax(a, Mode.GLOBAL, b, maxd)
        assert got == want
    # guaranteed failure inside tiny maxd
    a = "A" * 60
    b = "C" * 60
    assert myers_diff_jax(a, Mode.GLOBAL, b, 10)[0] == UINT_MAX
    assert myers_diff(a, Mode.GLOBAL, b, 10)[0] == UINT_MAX


def test_myers_jax_identical_sequences():
    s = "ACGTACGTAA"
    assert myers_diff_jax(s, Mode.GLOBAL, s, 5) == myers_diff(s, Mode.GLOBAL, s, 5)
    assert myers_diff_jax("", Mode.GLOBAL, "", 3) == myers_diff("", Mode.GLOBAL, "", 3)
