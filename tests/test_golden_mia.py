"""Golden-output tests: our mia must be byte-identical to the reference C
binary (modulo the timestamp header line) across flag configurations.

Golden files were produced by the reference implementation built from
/root/reference (see scripts/make_goldens.sh); they are committed so the
suite runs without a C toolchain.
"""
import os
import subprocess
import sys

import pytest

from .conftest import FIXTURES, GOLDEN

CONFIGS = {
    "default": ["-r", "tr1.fna", "-f", "tf.fna"],
    "circular": ["-r", "tr1.fna", "-f", "tf.fna", "-c"],
    "hp": ["-r", "tr1.fna", "-f", "tf.fna", "-h"],
    "trim": ["-r", "tr1.fna", "-f", "tf.fna", "-T"],
    "kmer": ["-r", "tr1.fna", "-f", "tf.fna", "-k", "12"],
    "p2": ["-r", "tr1.fna", "-f", "tf.fna", "-p", "2"],
    "fastq_UC": ["-r", "tr1.fna", "-f", "tf.fastq", "-U", "-C2"],
    "distant": ["-r", "tr1_distant.fna", "-f", "tf.fna", "-D"],
    "hp_k": ["-r", "tr1.fna", "-f", "tf.fna", "-h", "-k", "12"],
    "A454": ["-r", "tr1.fna", "-f", "tf.fna", "-T", "-u", "-A"],
    "softmask_k": ["-r", "tr1.fna", "-f", "tf.fna", "-M", "-k", "12"],
    "idlist": ["-r", "tr1.fna", "-f", "tf.fna", "-I", "ids.txt", "-u"],
    "scoreline": ["-r", "tr1.fna", "-f", "tf.fna", "-u", "-S", "8", "-N", "-300"],
    "adapter": ["-r", "tr1.fna", "-f", "tf.fna", "-T", "-a", "GGCCTTGGAA"],
    "sim200": [
        "-r", "mt_sim.fna", "-f", "sim200.fastq", "-c",
        "-s", "ancient.submat.txt", "-k", "12", "-u",
    ],
}


def _run_mia(args, workdir, engine=None):
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    extra = []
    if engine is not None:
        extra = ["--engine", engine]
        if engine == "jax":
            # force the device program (CPU backend here): without this the
            # work-stealing would route every batch to the native engine
            # and the device path would go untested
            env["MIA_STEAL"] = "0"
            env["MIA_SCORE_BATCH"] = "64"
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run(
        [sys.executable, "-m", "mia.cli.mia", *args, "-m", "out.maln", *extra],
        cwd=workdir,
        env=env,
        check=True,
        capture_output=True,
        timeout=900,
    )


def _norm(path):
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return b"\n".join(lines[1:])  # drop the asctime header line


@pytest.mark.parametrize("engine", ["native", "jax", "numpy"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_maln_byte_identical(name, engine, tmp_path):
    """Every golden config, byte-checked on every engine (the jax engine
    runs its real batched device program on the CPU backend here; the
    on-card gate is tests/test_gpu.py)."""
    golden = os.path.join(GOLDEN, name)
    if not os.path.isdir(golden):
        pytest.skip(f"no golden outputs for {name}")
    if engine == "numpy" and name == "sim200":
        pytest.skip("per-read exact path is minutes-slow on sim200")
    args = [
        os.path.join(FIXTURES, a)
        if (a.endswith((".fna", ".fastq")) or a == "ids.txt")
        else a
        for a in CONFIGS[name]
    ]
    _run_mia(args, tmp_path, engine=engine)
    produced = sorted(p for p in os.listdir(tmp_path) if p.startswith("out.maln."))
    expected = sorted(os.listdir(golden))
    assert produced == expected, f"iteration files differ: {produced} vs {expected}"
    for fn in expected:
        assert _norm(tmp_path / fn) == _norm(os.path.join(golden, fn)), (
            f"{name}/{fn} differs from reference output"
        )


def test_hp_device_program_engaged(tmp_path):
    """-h under --engine jax must actually score on the device program
    (not silently fall back to the native engine): assert the device
    counter in the profile output."""
    import json

    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["MIA_STEAL"] = "0"
    env["MIA_SCORE_BATCH"] = "64"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [
            sys.executable, "-m", "mia.cli.mia",
            "-r", os.path.join(FIXTURES, "tr1.fna"),
            "-f", os.path.join(FIXTURES, "tf.fna"),
            "-h", "-k", "12", "--engine", "jax", "--profile", "-m", "out.maln",
        ],
        cwd=tmp_path, env=env, capture_output=True, timeout=900, check=True,
    )
    line = [
        ln for ln in r.stderr.decode().splitlines() if ln.startswith("MIA_PROFILE")
    ][-1]
    prof = json.loads(line.split("MIA_PROFILE ", 1)[1])
    assert prof["counters"].get("pass1.device_scored_reads", 0) > 0, prof
    assert prof["counters"].get("pass1.batches_stolen_native", 0) == 0, prof


def test_gapped_alignments_byte_identical_across_engines(tmp_path):
    """Reads with REAL indels: the gap-free shortcut must decline and the
    exact native finish must produce byte-identical malns on the device
    engine (the simulator's default workloads are indel-free, so this
    guards the gapped path explicitly)."""
    import json

    from mia.models.simulate import SimConfig, random_reference, simulate_reads

    ref = random_reference(2000, seed=3)
    ref_fn = tmp_path / "ref.fna"
    ref_fn.write_text(">r\n" + ref + "\n")
    frag_fn = tmp_path / "reads.fastq"
    with open(frag_fn, "w") as f:
        for name, seq, qual in simulate_reads(
            ref, SimConfig(num_reads=400, mean_len=70, indel_rate=0.02, seed=9)
        ):
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")

    outs = {}
    prof = None
    for engine in ("native", "jax"):
        d = tmp_path / engine
        d.mkdir()
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        env["MIA_STEAL"] = "0"
        env["MIA_SCORE_BATCH"] = "64"
        r = subprocess.run(
            [
                sys.executable, "-m", "mia.cli.mia", "-r", str(ref_fn),
                "-f", str(frag_fn), "-c", "-k", "12", "--engine", engine,
                "--profile", "-m", str(d / "out.maln"),
            ],
            env=env, capture_output=True, timeout=900, check=True,
        )
        outs[engine] = sorted(
            (fn, _norm(d / fn)) for fn in os.listdir(d)
        )
        if engine == "jax":
            line = [
                ln for ln in r.stderr.decode().splitlines()
                if ln.startswith("MIA_PROFILE")
            ][-1]
            prof = json.loads(line.split("MIA_PROFILE ", 1)[1])["counters"]
    assert outs["native"] == outs["jax"]
    scored = prof.get("pass1.device_scored_reads", 0)
    shortcut = prof.get("pass1.gapfree_shortcut", 0)
    assert scored > 0, prof
    assert 0 < shortcut < scored, (
        f"want a MIX of gap-free and gapped winners, got {shortcut}/{scored}"
    )
