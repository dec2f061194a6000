"""Two-process jax.distributed test (SURVEY §4 item 4): the psum-merged
per-column consensus accumulators must equal the single-host accumulators.

Spawns two REAL processes that initialize a jax.distributed CPU cluster,
each accumulates ColumnCounts over its host_read_shard of a shared
observation set, all-reduces, calls the consensus, and writes it out; the
parent compares both against the single-process result.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = r"""
import os, sys
import numpy as np
from mia.parallel.distributed import (
    allreduce_column_counts, converged_everywhere, host_read_shard,
    initialize_if_needed,
)
from mia.ops.consensus import ColumnCounts, find_consensus_cols
from mia.ops.pssm import init_flatsubmat, revcom_submat

assert initialize_if_needed()
import jax
assert jax.process_count() == 2

N_COLS, N_OBS = 64, 4000
rng = np.random.default_rng(11)
cols = rng.integers(0, N_COLS, N_OBS)
chars = np.frombuffer(b"ACGT-", np.uint8)[rng.integers(0, 5, N_OBS)]
depths = rng.integers(0, 31, N_OBS)
strands = rng.random(N_OBS) < 0.5
fpsm = init_flatsubmat().astype(np.int64)
rpsm = revcom_submat(fpsm).astype(np.int64)

shard = host_read_shard(N_OBS)
sl = slice(shard.start, shard.start + shard.count)
cc = ColumnCounts(N_COLS)
cc.add_bases(cols[sl], chars[sl], depths[sl], strands[sl], fpsm, rpsm)
allreduce_column_counts(cc)
cons, _ = find_consensus_cols(cc, 1)
assert converged_everywhere(True)
assert not converged_everywhere(jax.process_index() == 0)
with open(sys.argv[1], "wb") as f:
    f.write(cons.tobytes())
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_consensus_psum(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(i)
        env.pop("XLA_FLAGS", None)  # no virtual mesh in the workers
        procs.append(
            subprocess.Popen(
                [sys.executable, str(script), str(tmp_path / f"cons.{i}")],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        )
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]

    # single-process oracle
    from mia.ops.consensus import ColumnCounts, find_consensus_cols
    from mia.ops.pssm import init_flatsubmat, revcom_submat

    N_COLS, N_OBS = 64, 4000
    rng = np.random.default_rng(11)
    cols = rng.integers(0, N_COLS, N_OBS)
    chars = np.frombuffer(b"ACGT-", np.uint8)[rng.integers(0, 5, N_OBS)]
    depths = rng.integers(0, 31, N_OBS)
    strands = rng.random(N_OBS) < 0.5
    fpsm = init_flatsubmat().astype(np.int64)
    rpsm = revcom_submat(fpsm).astype(np.int64)
    cc = ColumnCounts(N_COLS)
    cc.add_bases(cols, chars, depths, strands, fpsm, rpsm)
    expect, _ = find_consensus_cols(cc, 1)

    for i in range(2):
        got = np.frombuffer((tmp_path / f"cons.{i}").read_bytes(), np.uint8)
        assert np.array_equal(got, expect), f"process {i} consensus differs"


@pytest.mark.parametrize(
    "flags",
    [
        ["-c", "-k", "12"],
        # -C collapse + -q fastq export: duplicate groups spanning hosts
        # and the global fastq write (round-5: previously RuntimeError'd)
        ["-U", "-C2", "-q", "out.fastq"],
    ],
    ids=["circular_kmer", "collapse_fastq"],
)
def test_two_process_assembly_byte_identical(tmp_path, flags):
    """END-TO-END: a 2-process sharded assembly must write the SAME files
    (host 0) as a single-process run — global repeat filters, global
    score-cut fit, global collapse, all-reduced consensus, global
    convergence vote, the merged maln writer and the global fastq export
    all engaged (BASELINE config 5's flow at fixture scale)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fixtures = os.path.join(repo, "tests", "fixtures")

    def run(workdir, extra_env):
        env = dict(os.environ)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["MIA_SERVER"] = "0"
        env.pop("XLA_FLAGS", None)
        env.update(extra_env)
        return subprocess.Popen(
            [
                sys.executable, "-m", "mia.cli.mia",
                "-r", os.path.join(fixtures, "tr1.fna"),
                "-f", os.path.join(fixtures, "tf.fastq"),
                *flags,
                "-m", os.path.join(workdir, "out.maln"),
                "--engine", "native",
            ],
            env=env,
            cwd=workdir,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
        )

    single_dir = tmp_path / "single"
    single_dir.mkdir()
    p = run(str(single_dir), {})
    _, se = p.communicate(timeout=300)
    assert p.returncode == 0, se.decode()[-2000:]

    port = _free_port()
    dirs = []
    procs = []
    for i in range(2):
        d = tmp_path / f"host{i}"
        d.mkdir()
        dirs.append(d)
        procs.append(
            run(
                str(d),
                {
                    "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                    "JAX_NUM_PROCESSES": "2",
                    "JAX_PROCESS_ID": str(i),
                },
            )
        )
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]

    def norm(d):
        files = {}
        for fn in sorted(os.listdir(d)):
            with open(os.path.join(d, fn), "rb") as fh:
                data = fh.read()
            if fn.startswith("out.maln"):  # drop the asctime header line
                data = b"\n".join(data.split(b"\n")[1:])
            files[fn] = data
        return files

    want = norm(single_dir)
    got = norm(dirs[0])
    assert sorted(got) == sorted(want)
    for fn in want:
        assert got[fn] == want[fn], f"{fn} differs between 2-proc and 1-proc"
    assert norm(dirs[1]) == {}, "only host 0 writes the maln"
