"""maln round-trips, easy-consensus semantics, legacy align reader, and the
device-engine golden run."""
import os
import subprocess
import sys

import numpy as np
import pytest

from mia.cli.easy_consensus import call_cons, consensus, to_ambicode, to_nucleotide
from mia.io.align_reader import iter_align_aln
from mia.io.maln import read_ma, write_ma

from .conftest import FIXTURES, GOLDEN


def _assert_roundtrip(src, out):
    """read_ma -> write_ma must preserve every line except the asctime header
    and MALN_SIZ, which the reference also rewrites to its grown in-memory
    array size on a round trip (read_ma grows from 16000 by doubling,
    src/map_alignment.c:415-419; verified against `ma -m`)."""
    with open(src) as a, open(out) as b:
        la = a.read().split("\n")[1:]
        lb = b.read().split("\n")[1:]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if x.startswith("MALN_SIZ"):
            assert int(y.split()[1]) >= int(x.split()[1])
            assert int(y.split()[1]) % 16000 == 0 or x == y
        elif x.startswith("DESC"):
            # the reference reader keeps only the first token of the
            # reference DESC (sscanf %s); `ma -m` writes it back truncated
            assert x.startswith(y) or x == y
        else:
            assert x == y


def test_maln_roundtrip(tmp_path):
    src = os.path.join(GOLDEN, "default", "out.maln.4")
    write_ma(str(tmp_path / "rt.maln"), read_ma(src))
    _assert_roundtrip(src, tmp_path / "rt.maln")


def test_maln_roundtrip_with_inserts(tmp_path):
    src = os.path.join(GOLDEN, "sim200", "out.maln.2")
    write_ma(str(tmp_path / "rt.maln"), read_ma(src))
    _assert_roundtrip(src, tmp_path / "rt.maln")


def test_easy_consensus_calls():
    assert call_cons("AAAA", 1.0, to_ambicode) == "A"
    assert call_cons("AAAT", 1.0, to_ambicode) == "W"
    assert call_cons("AAAT", 0.5, to_ambicode) == "A"
    assert call_cons("AA--", 1.0, to_ambicode) == "a"  # optional gap
    assert call_cons("NNNN", 1.0, to_ambicode) == "A"  # all-uncounted quirk
    assert call_cons("ACGT", 1.0, to_nucleotide) == "N"
    assert consensus(["AC-T", "ACGT"], 1.0, to_ambicode) == "ACgT"


def test_align_reader(tmp_path):
    p = tmp_path / "t.aln"
    p.write_text(
        ">ref + 11-16 score=1200\n"
        "--ACGTAC\n"
        ">frag1 something\n"
        "--ACGTA-\n"
        ">ref - 21-24 score=-500\n"
        "ACGT\n"
        ">frag2 with adapter cut off\n"
        "AGGT\n"
    )
    recs = list(iter_align_aln(str(p)))
    assert len(recs) == 2
    a = recs[0]
    # leading 2-gap context strips; trailing 1-gap strips
    assert (a.start, a.end) == (12, 14)
    assert a.ref_seq == "ACGTA" and a.frag_seq == "ACGTA"
    assert a.score == 1200 and not a.revcom and not a.trimmed
    b = recs[1]
    assert b.revcom and b.trimmed and b.score == -500
    assert b.ref_seq == "GTACGT"[2:]  # revcom of ACGT
    assert b.frag_seq == "ACCT"


def test_jax_engine_golden(tmp_path):
    """Full assembly with --engine jax (CPU backend) must reproduce the
    golden maln files.  MIA_SCORE_BATCH keeps the padded batch small so the
    CPU-backend kernel compiles and runs in seconds."""
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["MIA_SCORE_BATCH"] = "64"
    subprocess.run(
        [
            sys.executable, "-m", "mia.cli.mia",
            "-r", os.path.join(FIXTURES, "tr1.fna"),
            "-f", os.path.join(FIXTURES, "tf.fna"),
            "-m", "out.maln", "--engine", "jax",
        ],
        cwd=tmp_path,
        env=env,
        check=True,
        capture_output=True,
    )
    for i in (1, 2, 3, 4):
        with open(tmp_path / f"out.maln.{i}", "rb") as a, open(
            os.path.join(GOLDEN, "default", f"out.maln.{i}"), "rb"
        ) as b:
            assert a.read().split(b"\n")[1:] == b.read().split(b"\n")[1:]
