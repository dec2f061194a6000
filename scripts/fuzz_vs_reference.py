#!/usr/bin/env python
"""Differential fuzzing against the reference binary.

Generates random references/read sets (including nasty cases: Ns, short
reads, soft-masking, descriptions, duplicates, empty files) and random flag
combinations, runs both implementations, and compares every output file
byte-for-byte (modulo the timestamp header).

Usage: python scripts/fuzz_vs_reference.py [trials] [seed]
Requires the reference mia built at $MIA_REF (default /tmp/refsrc/src/mia).
"""
from __future__ import annotations

import os
import random
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIA_REF = os.environ.get("MIA_REF", "/tmp/refsrc/src/mia")
MATRICES = os.environ.get("MIA_REF_MATRICES", "/tmp/refsrc/share/matrices")


def rand_seq(rng, n, alpha="ACGT"):
    return "".join(rng.choice(alpha) for _ in range(n))


def make_inputs(rng, d):
    ref_len = rng.randint(40, 400)
    ref = list(rand_seq(rng, ref_len))
    # soft-mask a chunk sometimes
    if rng.random() < 0.5:
        a = rng.randrange(ref_len)
        b = min(ref_len, a + rng.randint(5, 40))
        for i in range(a, b):
            ref[i] = ref[i].lower()
    # sprinkle Ns
    for _ in range(rng.randint(0, 4)):
        ref[rng.randrange(ref_len)] = "N"
    ref = "".join(ref)
    ref_fn = os.path.join(d, "ref.fna")
    with open(ref_fn, "w") as f:
        desc = " some description" if rng.random() < 0.3 else ""
        f.write(f">fuzzref{desc}\n")
        for i in range(0, len(ref), 61):
            f.write(ref[i : i + 61] + "\n")

    n_reads = rng.randint(0, 40)
    fastq = rng.random() < 0.5
    reads_fn = os.path.join(d, "reads." + ("fastq" if fastq else "fna"))
    refu = ref.upper()
    names = []
    with open(reads_fn, "w") as f:
        for i in range(n_reads):
            kind = rng.random()
            if kind < 0.6:  # real fragment
                L = rng.randint(5, min(120, ref_len))
                s = rng.randrange(max(ref_len - L, 1))
                seq = list(refu[s : s + L])
                for _ in range(rng.randint(0, 3)):
                    seq[rng.randrange(len(seq))] = rng.choice("ACGTN")
                if rng.random() < 0.3:  # revcom
                    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
                    seq = [comp[c] for c in reversed(seq)]
                seq = "".join(seq)
            elif kind < 0.8:  # junk
                seq = rand_seq(rng, rng.randint(3, 80), "ACGTN")
            else:  # duplicate-prone fragment
                L = rng.randint(10, min(60, ref_len))
                s = rng.randrange(max(ref_len - L, 1))
                seq = refu[s : s + L]
            name = f"r{i}" + ("_dup" if kind >= 0.8 else "")
            names.append(name)
            desc = " a desc" if rng.random() < 0.15 else ""
            if fastq:
                qual = "".join(chr(33 + rng.randint(2, 40)) for _ in seq)
                f.write(f"@{name}{desc}\n{seq}\n+\n{qual}\n")
            else:
                f.write(f">{name}{desc}\n{seq}\n")
    ids_fn = None
    if names and rng.random() < 0.5:
        ids_fn = os.path.join(d, "ids.txt")
        subset = [n for n in names if rng.random() < 0.6]
        with open(ids_fn, "w") as f:
            f.write("\n".join(subset) + ("\n" if subset else ""))
    return ref_fn, reads_fn, ids_fn


def pick_flags(rng, ids_fn=None):
    flags = []
    if rng.random() < 0.4:
        flags.append("-c")
    if rng.random() < 0.3:
        flags += ["-k", str(rng.choice([6, 8, 10, 12]))]
        if rng.random() < 0.5:
            flags.append("-M")
    r = rng.random()
    if r < 0.3:
        flags.append("-u")
    elif r < 0.45:
        flags.append("-U")
    if rng.random() < 0.25:
        flags.append(f"-C{rng.choice(['', '1', '2'])}")
    if rng.random() < 0.25:
        flags.append("-T")
    if rng.random() < 0.2:
        flags.append("-h")
    if rng.random() < 0.2:
        flags.append("-D")
    if rng.random() < 0.2:
        flags += ["-p", "2"]
    if rng.random() < 0.15:
        flags += ["-H", str(rng.choice([1000, 3000]))]
    if rng.random() < 0.1:
        flags.append("-n")
    if rng.random() < 0.1:
        flags.append("-F")
    if rng.random() < 0.15:
        flags += ["-s", os.path.join(MATRICES, "ancient.submat.txt")]
    # dedup mode, id lists, explicit cutoff line, custom adapters, fastq
    # export (note -q falls through to -C in the reference's getopt —
    # replicated by our CLI)
    if rng.random() < 0.15:
        flags.append("-A")
    if ids_fn is not None and rng.random() < 0.3:
        flags += ["-I", ids_fn]
    if rng.random() < 0.12:
        flags += ["-S", str(rng.choice([5, 8, 12])), "-N",
                  str(rng.choice([-500, -300, 0]))]
    if rng.random() < 0.12:
        flags += ["-a", rand_seq(rng, rng.randint(8, 24))]
        if "-T" not in flags and rng.random() < 0.7:
            flags.append("-T")
    if rng.random() < 0.12:
        flags += ["-q", "out.fastq"]
    return flags


def run_one(rng, trial):
    with tempfile.TemporaryDirectory() as d:
        ref_fn, reads_fn, ids_fn = make_inputs(rng, d)
        flags = pick_flags(rng, ids_fn)
        cdir = os.path.join(d, "c")
        pdir = os.path.join(d, "p")
        os.makedirs(cdir)
        os.makedirs(pdir)
        args = ["-r", ref_fn, "-f", reads_fn, *flags, "-m", "out.maln"]
        rc = subprocess.run(
            [MIA_REF, *args], cwd=cdir, capture_output=True, timeout=120
        )
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        # hermetic: CPU backend, no resident server, no work-stealing — the
        # fuzz exercises the engines' logic
        env["JAX_PLATFORMS"] = "cpu"
        env["MIA_SERVER"] = "0"
        rp = subprocess.run(
            [sys.executable, "-m", "mia.cli.mia", *args],
            cwd=pdir,
            capture_output=True,
            timeout=600,
            env=env,
        )
        c_files = sorted(os.listdir(cdir))
        p_files = sorted(os.listdir(pdir))
        crashed_c = rc.returncode not in (0,)
        if crashed_c:
            return "ref-crash", flags  # reference segfaulted; nothing to compare
        if rp.returncode != 0:
            print(f"[{trial}] OURS CRASHED flags={flags}")
            print(rp.stderr.decode()[-2000:])
            return "fail", flags
        if c_files != p_files:
            print(f"[{trial}] FILE SET DIFF {c_files} vs {p_files} flags={flags}")
            return "fail", flags
        for fn in c_files:
            with open(os.path.join(cdir, fn), "rb") as a, open(
                os.path.join(pdir, fn), "rb"
            ) as b:
                ca = a.read().split(b"\n")
                cb = b.read().split(b"\n")
            if fn.startswith("out.maln"):
                ca, cb = ca[1:], cb[1:]
            if fn == "out.fastq" and reads_fn.endswith(".fna"):
                # FASTA input has no quality strings; the reference's
                # collapse (-q implies -C) emits stale-memory bytes on the
                # qual lines of collapsed reads (uninitialised FragSeq.qual,
                # src/mia.c:140-233 + src/fsdb.c:392-419) — compare
                # everything except the qual line of each record
                ca = [ln for i, ln in enumerate(ca) if i % 4 != 3]
                cb = [ln for i, ln in enumerate(cb) if i % 4 != 3]
            if ca != cb:
                print(f"[{trial}] DIFF in {fn} flags={flags}")
                keep = os.path.join("/tmp", f"fuzzfail_{trial}")
                import shutil

                shutil.copytree(d, keep)
                print(f"  inputs kept at {keep}")
                return "fail", flags
        return "ok", flags


def main():
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    seed = int(sys.argv[2]) if len(sys.argv) > 2 else 1234
    rng = random.Random(seed)
    stats = {"ok": 0, "fail": 0, "ref-crash": 0}
    for t in range(trials):
        try:
            res, flags = run_one(rng, t)
        except subprocess.TimeoutExpired:
            print(f"[{t}] TIMEOUT")
            res = "fail"
        stats[res] = stats.get(res, 0) + 1
        if res == "fail":
            print(f"  stats so far: {stats}")
    print("fuzz done:", stats)
    return 0 if stats["fail"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
