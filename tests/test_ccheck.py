"""ccheck golden tests + Myers aligner differentials."""
import os
import subprocess
import sys

import numpy as np
import pytest

from mia.ops.myers import Mode, myers_diff

from .conftest import GOLDEN


def _run_ccheck(args, cwd):
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "mia.cli.ccheck", *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
    )
    return r.stdout


def test_ccheck_prose_golden():
    d = os.path.join(GOLDEN, "ccheck")
    out = _run_ccheck(["cc.maln.1"], d)
    with open(os.path.join(d, "prose.txt")) as fh:
        assert out == fh.read()


def test_ccheck_table_ancient_golden():
    d = os.path.join(GOLDEN, "ccheck")
    out = _run_ccheck(["-T", "-a", "cc.maln.1"], d)
    with open(os.path.join(d, "table_a.txt")) as fh:
        assert out == fh.read()


# ---- Myers O(ND) aligner ----

def _edit_distance(a, b):
    n, m = len(a), len(b)
    d = np.zeros((n + 1, m + 1), dtype=int)
    d[:, 0] = np.arange(n + 1)
    d[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d[i, j] = min(
                d[i - 1, j] + 1,
                d[i, j - 1] + 1,
                d[i - 1, j - 1] + (a[i - 1] != b[j - 1]),
            )
    return int(d[n, m])


@pytest.mark.parametrize("seed", range(8))
def test_myers_distance_matches_dp(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 60))
    a = "".join(rng.choice(list("ACGT")) for _ in range(n))
    b = list(a)
    for _ in range(int(rng.integers(0, 6))):
        op = rng.integers(3)
        p = int(rng.integers(0, max(len(b), 1)))
        if op == 0 and b:
            b[p] = rng.choice(list("ACGT"))
        elif op == 1:
            b.insert(p, rng.choice(list("ACGT")))
        elif b:
            del b[p % len(b)]
    b = "".join(b)
    d, bt_a, bt_b = myers_diff(a, Mode.GLOBAL, b, len(a) + len(b) + 1)
    assert d == _edit_distance(a, b)
    # backtraces reproduce the inputs when gaps are stripped
    assert bt_a.replace("-", "") == a
    assert bt_b.replace("-", "") == b
    assert len(bt_a) == len(bt_b)


def test_myers_iupac_matching():
    d, _, _ = myers_diff("ACGT", Mode.GLOBAL, "RCGW", 5)
    assert d == 0  # R~A, W~T via bitmap overlap


def test_myers_maxd_limit():
    d, _, _ = myers_diff("AAAA", Mode.GLOBAL, "TTTT", 3)
    assert d == 2**32 - 1


@pytest.mark.parametrize("engine", ["numpy", "native", "jax"])
def test_ccheck_engines_identical(engine):
    """The batched native and device realignment paths must reproduce the
    per-read python path's ccheck output byte-exactly."""
    d = os.path.join(GOLDEN, "ccheck")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["MIA_SCORE_BATCH"] = "64"
    r = subprocess.run(
        [sys.executable, "-m", "mia.cli.ccheck", "--engine", engine,
         "-T", "-a", "cc.maln.1"],
        cwd=d, env=env, capture_output=True, text=True,
    )
    with open(os.path.join(d, "table_a.txt")) as fh:
        assert r.stdout == fh.read(), engine


def _walk_loop(aln_ass, n_aln, start):
    """The reference's walk to a read's start column (src/ccheck.cc)."""
    p = ass_pos = 0
    while ass_pos != start and p < n_aln:
        if aln_ass[p] != "-":
            ass_pos += 1
        p += 1
    return p, ass_pos


def _lift_loop(aln1, aln2, s, e):
    """The reference's lift_over loop (src/ccheck.cc:166-176)."""
    out = []
    p = 0
    for c1, c2 in zip(aln1, aln2):
        if p >= e:
            break
        if c1 != "-" and p >= s:
            out.append(c1)
        if c2 != "-":
            p += 1
    return "".join(out)


@pytest.mark.parametrize("seed", range(6))
def test_indexed_walk_matches_loops(seed):
    """walk_to / lift_over give what the per-column loops give, for every
    start and end including negative ones and ones past the alignment."""
    from mia.core.contamination import lift_over, walk_to

    rng = np.random.default_rng(seed)
    n1, n2 = rng.integers(0, 60, 2)
    aln1 = "".join(rng.choice(list("ACGT-"), n1))
    aln2 = "".join(rng.choice(list("ACGT--"), n2))
    n_aln = min(len(aln1), len(aln2))
    span = range(-3, n2 + 4)
    for start in span:
        assert walk_to(aln2, n_aln, start) == _walk_loop(aln2, n_aln, start)
        for end in span:
            assert lift_over(aln1, aln2, start, end) == _lift_loop(
                aln1, aln2, start, end)
