#!/usr/bin/env python3
"""End-to-end proof that MIA runs on an NVIDIA GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --cards 4    # four cards: dp-sharded run vs native

It builds the native library from the tracked sources, simulates a full
16,569-bp circular mtDNA reference and 100k damaged reads from a fixed seed,
and runs each phase in a child process, one after another, so that only one
process holds the card at a time:

1. ``mia --engine native`` on the CPU: the reference outputs.
2. The device entry program against the scalar oracle on random banded
   entries at the real shapes (one full batch), compared exactly; then the
   scorer's two row loops timed per batch: (a) ``lax.scan`` over every row,
   (b) ``lax.fori_loop`` bounded by the batch's longest entry.
3. The served route: ``mia.cli.serve`` holds the card, a cold and a warm
   ``mia --engine jax`` run are its clients.  The warm run must score pass 1,
   the realignment and the consensus on the device, and both runs must write
   the native run's maln files byte for byte (timestamp line aside).  While
   the server lives, ``ccheck --engine jax`` runs through it, and an
   in-process ``mia --engine jax`` must refuse to open the card.
4. The in-process route (``MIA_SERVER=0 MIA_STEAL=0``), byte-identical too.
5. The ``-h`` and ``kmer`` goldens with ``--engine jax``.
6. ``ccheck --engine jax`` in-process; both ccheck runs against
   ``ccheck --engine native``.

With ``--cards 4`` it runs only ``mia --engine jax --dp-devices 4`` and the
native run it is compared with, and checks that the mesh spans 4 distinct
devices.  Any failure exits non-zero without the result line.  The last
line of a passing run is one JSON object naming the device as JAX reports it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGS = ["-c", "-u", "-k", "12", "-s", "ancient.submat.solexa.pe.txt"]
REF_LEN = 16569
T0 = time.time()
BUDGET_S = 1150.0


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def child_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k, v in extra.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    return env


def run(phase: str, cmd: list, env: dict, cwd: str | None = None,
        timeout: float = 600.0) -> subprocess.CompletedProcess:
    timeout = min(timeout, BUDGET_S - (time.time() - T0))
    if timeout <= 0:
        raise SmokeFailure(f"{phase}: out of time")
    try:
        r = subprocess.run(cmd, env=env, cwd=cwd, capture_output=True,
                           text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{phase}: timed out after {timeout:.0f}s")
    if r.returncode != 0:
        raise SmokeFailure(
            f"{phase}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}"
        )
    return r


def profile_of(r: subprocess.CompletedProcess) -> dict:
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("MIA_PROFILE ")]
    if not lines:
        raise SmokeFailure("no MIA_PROFILE line in the run's stderr")
    return json.loads(lines[-1].split(" ", 1)[1])


def malns(d: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith("out.maln."):
            with open(os.path.join(d, fn), "rb") as fh:
                out[fn] = fh.read().split(b"\n", 1)[1]
    if not out:
        raise SmokeFailure(f"no maln output in {d}")
    return out


def same_malns(phase: str, got: dict, want: dict) -> None:
    if sorted(got) != sorted(want):
        raise SmokeFailure(f"{phase}: iterations {sorted(got)} != {sorted(want)}")
    bad = [fn for fn in want if got[fn] != want[fn]]
    if bad:
        raise SmokeFailure(f"{phase}: maln bytes differ from native: {bad}")


def need(phase: str, counters: dict, name: str, ok) -> None:
    v = counters.get(name, 0)
    if not ok(v):
        raise SmokeFailure(f"{phase}: counter {name} = {v}")


PROBE = """
import json, jax
d = jax.devices()
print(json.dumps({"platform": d[0].platform, "kind": d[0].device_kind,
                  "count": len(d), "distinct": len({x.id for x in d})}))
"""

SIMULATE = """
import sys
import numpy as np
from mia.models.simulate import SimConfig, random_reference, simulate_reads
d, n, seed, ref_len = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
ref = random_reference(ref_len, seed=seed)
def fasta(fn, name, s):
    with open(fn, "w") as f:
        f.write(">" + name + "\\n")
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\\n")
fasta(d + "/ref.fna", "mt_sim", ref)
# a contaminant that differs from the reference at 1 % of its positions
rng = np.random.default_rng(seed + 2)
acgt = np.frombuffer(b"ACGT", np.uint8)
c = np.frombuffer(ref.encode(), np.uint8).copy()
pos = rng.choice(len(c), len(c) // 100, replace=False)
c[pos] = acgt[(np.searchsorted(acgt, c[pos]) + rng.integers(1, 4, len(pos))) % 4]
fasta(d + "/contam.fna", "contaminant", c.tobytes().decode())
with open(d + "/reads.fastq", "w") as f:
    for name, seq, qual in simulate_reads(
        ref, SimConfig(num_reads=n, mean_len=60, seed=seed + 1)
    ):
        f.write("@" + name + "\\n" + seq + "\\n+\\n" + qual + "\\n")
"""

ENTRY_CHECK = """
import functools, json, sys, time
import numpy as np
import jax, jax.numpy as jnp
import mia.core.jax_engine as je
from mia.core.entry_check import oracle_scores, random_entries
assert jax.devices()[0].platform == "gpu", jax.devices()
seed, len1 = int(sys.argv[1]), int(sys.argv[2])
E = 2 * je.default_batch()
res = {"E": E, "W": je.WIN_W, "L": je.L_MAX}
for sort in (False, True):
    ent = random_entries(E, seed=seed + sort, len1=len1, sort_lengths=sort)
    sc = je.Pass1Scorer(ent.fw, ent.rc, len1, ent.sms[0], ent.sms[1],
                        warm=False)
    best, aec = sc.collect_entries(sc.dispatch_entries(*ent.args()))
    want_best, want_aec = oracle_scores(ent)
    bad = np.flatnonzero((best != want_best) | (aec != want_aec))
    if len(bad):
        print(json.dumps({"mismatch": int(len(bad)), "sorted": sort,
                          "first": int(bad[0])}))
        sys.exit(1)
    res["exact_sorted" if sort else "exact_unsorted"] = int(E)

# per-batch times of the two row loops on the simulator's length mix
ent = random_entries(E, seed=seed + 7, len1=len1, full_height=False)
sc = je.Pass1Scorer(ent.fw, ent.rc, len1, ent.sms[0], ent.sms[1], warm=False)
res["max_len"] = int(ent.lens.max())
ref_sel, starts, ivl, s2c, lens, smidx = ent.args()
s2c4 = np.full((E, je.L_MAX), 4, np.uint8)
s2c4[:, : s2c.shape[1]] = s2c
s2c4 = s2c4[:, 0::2] | (s2c4[:, 1::2] << 4)
args = [jnp.asarray(a) for a in (
    ref_sel, starts, ivl.astype(np.int16), s2c4, lens, smidx)]
args = [sc._refs] + args + [sc._sms]
def timed(fn, reps=20):
    fn(*args).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(min(ts))
outs = {}
# (a): the static bound L_MAX, a fixed trip count that lowers to lax.scan;
# (b): the production program, bounded by the batch's longest entry
for name, n_rows in (("a_scan", je.L_MAX), ("b_fori_bounded", None)):
    fn = jax.jit(functools.partial(je._entries_core, n_rows=n_rows))
    t0 = time.perf_counter()
    outs[name] = np.asarray(fn(*args))
    res[name + "_first_call_s"] = time.perf_counter() - t0
    res[name + "_median_s"], res[name + "_min_s"] = timed(fn)
    ma = fn.lower(*args).compile().memory_analysis()
    res[name + "_temp_bytes"] = int(getattr(ma, "temp_size_in_bytes", -1))
if not np.array_equal(outs["a_scan"], outs["b_fori_bounded"]):
    print(json.dumps({"variants_differ": True}))
    sys.exit(1)
# the production path per batch: host padding + transfer + program + fetch
h = sc.dispatch_entries(*ent.args()); sc.collect_entries(h)
ts = []
for _ in range(10):
    t0 = time.perf_counter()
    sc.collect_entries(sc.dispatch_entries(*ent.args()))
    ts.append(time.perf_counter() - t0)
res["dispatch_collect_median_s"] = float(np.median(ts))
print(json.dumps(res))
"""


def mia_cmd(work: str, out: str, engine: str, extra=()) -> list:
    return [sys.executable, "-m", "mia.cli.mia", "-r", f"{work}/ref.fna",
            "-f", f"{work}/reads.fastq", *FLAGS, "-m", f"{out}/out.maln",
            "--engine", engine, "--profile", *extra]


def timed_mia(phase, work, tag, engine, env, extra=()):
    out = os.path.join(work, tag)
    os.makedirs(out)
    t0 = time.time()
    r = run(phase, mia_cmd(work, out, engine, extra), env)
    wall = time.time() - t0
    prof = profile_of(r)
    c = prof["counters"]
    ph = prof["phases_s"]
    log(f"{phase}: wall {wall:.2f}s; profile total {prof['total_s']}s; "
        f"pass1 {ph.get('pass1', 0)}s reiterate {ph.get('reiterate', 0)}s "
        f"consensus {ph.get('consensus', 0)}s")
    log(f"{phase}: counters {json.dumps(c, sort_keys=True)}")
    log(f"{phase}: consensus host_counts {ph.get('consensus.host_counts', 0)}s "
        f"device_counts {ph.get('consensus.device_counts', 0)}s")
    return out, wall, prof


def phase_native(work):
    out, wall, _ = timed_mia("native", work, "native", "native",
                             child_env(JAX_PLATFORMS="cpu", MIA_SERVER="0"))
    return malns(out)


def phase_entries(work, seed):
    r = run("entry program", [sys.executable, "-c", ENTRY_CHECK, str(seed),
                              str(REF_LEN + 256)], child_env(), timeout=600)
    res = json.loads(r.stdout.strip().splitlines()[-1])
    log(f"entry program: exact vs oracle on {res['exact_unsorted']} unsorted "
        f"and {res['exact_sorted']} sorted entries (E={res['E']} W={res['W']} "
        f"L={res['L']})")
    log(f"scorer per batch (E={res['E']}, lengths Poisson(60) max "
        f"{res['max_len']}): (a) scan all rows median "
        f"{res['a_scan_median_s'] * 1e3:.3f} ms (min "
        f"{res['a_scan_min_s'] * 1e3:.3f}); (b) fori bounded median "
        f"{res['b_fori_bounded_median_s'] * 1e3:.3f} ms (min "
        f"{res['b_fori_bounded_min_s'] * 1e3:.3f}); production dispatch+collect "
        f"median {res['dispatch_collect_median_s'] * 1e3:.3f} ms")
    log(f"entry program: {json.dumps(res, sort_keys=True)}")


def phase_served(work, want):
    sys.path.insert(0, REPO)
    from mia.serve import hello

    sock = os.path.join(work, "serve.sock")
    srv_log = open(os.path.join(work, "serve.log"), "w")
    srv = subprocess.Popen(
        [sys.executable, "-m", "mia.cli.serve", "--sock", sock],
        env=child_env(), stdout=srv_log, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.time() + 300
        info = None
        while info is None:
            if srv.poll() is not None:
                raise SmokeFailure("server exited during start-up")
            if time.time() > deadline:
                raise SmokeFailure("server never answered hello")
            try:
                info = hello(sock)
            except OSError:
                time.sleep(0.5)
        if info["platform"] != "gpu":
            raise SmokeFailure(f"server platform {info['platform']}, not gpu")
        log(f"server: platform {info['platform']} kind {info['device_kind']} "
            f"devices {info['devices']}")
        env = child_env(MIA_SERVER=sock)
        out_c, cold, _ = timed_mia("served cold", work, "served_cold", "jax", env)
        same_malns("served cold", malns(out_c), want)
        while hello(sock)["warming"]:
            if time.time() > deadline + 600:
                raise SmokeFailure("server programs never finished compiling")
            time.sleep(0.5)
        compile_s = hello(sock)["compile_s"]
        out_w, warm, prof = timed_mia("served warm", work, "served_warm", "jax",
                                      env)
        same_malns("served warm", malns(out_w), want)
        c = prof["counters"]
        need("served warm", c, "pass1.device_scored_reads", lambda v: v > 0)
        need("served warm", c, "pass1.batches_stolen_native", lambda v: v == 0)
        need("served warm", c, "reiterate.device_scored_reads", lambda v: v > 0)
        need("served warm", c, "consensus.device_calls", lambda v: v > 0)
        need("served warm", c, "consensus.host_cold", lambda v: v == 0)
        if prof["jax_imported"]:
            raise SmokeFailure("served warm: the client imported jax")
        log(f"served route: cold run {cold:.2f}s, warm run {warm:.2f}s, server "
            f"compile {compile_s['scorer']:.2f}s scorer + "
            f"{compile_s['consensus']:.2f}s consensus")
        maln = os.path.join(out_w, "out.maln.1")
        ops0 = hello(sock)["ops"]
        ccheck_out = timed_ccheck("ccheck served", work, maln, env)
        ops = {k: v - ops0.get(k, 0) for k, v in hello(sock)["ops"].items()}
        if ops.get("myers") != 1 or not ops.get("dispatch"):
            raise SmokeFailure(f"ccheck served: server ops {ops}")
        log(f"ccheck served: server ops {json.dumps(ops, sort_keys=True)}")
        # a second process must not open the card while the server holds it
        r = subprocess.run(
            mia_cmd(work, os.path.join(work, "refused"), "jax"),
            env=child_env(MIA_SERVER="0", MIA_SERVER_SOCK=sock),
            capture_output=True, text=True, timeout=300)
        if r.returncode == 0 or "holds the device" not in r.stderr:
            raise SmokeFailure(f"in-process run beside the server: exit "
                               f"{r.returncode}\n{r.stderr[-2000:]}")
        log("in-process run beside the server: refused")
    finally:
        srv.terminate()
        try:
            srv.wait(30)
        except subprocess.TimeoutExpired:
            srv.kill()
            srv.wait()
        srv_log.close()
    return maln, ccheck_out


def phase_inprocess(work, want, tag="in-process", extra=()):
    out, wall, prof = timed_mia(
        tag, work, tag.replace(" ", "_"), "jax",
        child_env(MIA_SERVER="0", MIA_STEAL="0"), extra)
    same_malns(tag, malns(out), want)
    c = prof["counters"]
    need(tag, c, "pass1.device_scored_reads", lambda v: v > 0)
    need(tag, c, "pass1.batches_stolen_native", lambda v: v == 0)
    need(tag, c, "reiterate.device_scored_reads", lambda v: v > 0)
    need(tag, c, "consensus.device_calls", lambda v: v > 0)
    return c


def phase_goldens(work):
    fixtures = os.path.join(REPO, "tests", "fixtures")
    for name, flags in (("hp", ["-h"]), ("kmer", ["-k", "12"])):
        out = os.path.join(work, "golden_" + name)
        os.makedirs(out)
        r = run(f"golden {name}", [
            sys.executable, "-m", "mia.cli.mia", "-r", f"{fixtures}/tr1.fna",
            "-f", f"{fixtures}/tf.fna", *flags, "-m", f"{out}/out.maln",
            "--engine", "jax", "--profile"],
            child_env(MIA_SERVER="0", MIA_STEAL="0"))
        c = profile_of(r)["counters"]
        # without -k every pass-1 band is wider than the device window, so
        # the hp golden reaches the device through the realignment
        scored = (c.get("pass1.device_scored_reads", 0),
                  c.get("reiterate.device_scored_reads", 0))
        if not sum(scored):
            raise SmokeFailure(f"golden {name}: no read scored on the device")
        same_malns(f"golden {name}", malns(out),
                   malns(os.path.join(REPO, "tests", "golden", name)))
        log(f"golden {name}: byte-identical; device-scored reads pass1 "
            f"{scored[0]}, reiterate {scored[1]}")


def timed_ccheck(phase, work, maln, env, engine="jax"):
    t0 = time.time()
    r = run(phase, [
        sys.executable, "-m", "mia.cli.ccheck", "--engine", engine, "-a",
        "-f", "-r", f"{work}/contam.fna", maln], env)
    log(f"{phase}: {time.time() - t0:.2f}s")
    return r.stdout


def phase_ccheck(work, maln, served_out):
    outs = {
        "native": timed_ccheck("ccheck native", work, maln,
                               child_env(JAX_PLATFORMS="cpu"), "native"),
        "served": served_out,
        "in-process": timed_ccheck("ccheck in-process", work, maln,
                                   child_env(MIA_SERVER="0")),
    }
    for k in ("served", "in-process"):
        if outs[k] != outs["native"]:
            raise SmokeFailure(f"ccheck: {k} jax output differs from native")
    summary = " | ".join(ln.strip() for ln in outs["native"].splitlines()
                         if "fragments" in ln or "distance" in ln)
    log(f"ccheck: served and in-process identical to native; {summary}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4))
    p.add_argument("--reads", type=int, default=100000)
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args()

    if not os.path.isdir(os.path.join(REPO, "mia")):
        raise SmokeFailure(f"no mia package beside {__file__}")
    probe = json.loads(run("device probe", [sys.executable, "-c", PROBE],
                           child_env()).stdout.strip().splitlines()[-1])
    if probe["platform"] != "gpu":
        raise SmokeFailure(f"JAX's platform is {probe['platform']}, not gpu")
    if probe["count"] < args.cards or probe["distinct"] < args.cards:
        raise SmokeFailure(f"{args.cards} cards asked, JAX sees {probe}")
    smi = run("nvidia-smi", ["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], child_env())
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}", flush=True)
    log(f"device: {probe}")

    run("native build", ["make", "-C", os.path.join(REPO, "native")],
        child_env(), timeout=300)
    with tempfile.TemporaryDirectory(prefix="mia-smoke-") as work:
        run("simulate", [sys.executable, "-c", SIMULATE, work, str(args.reads),
                         str(args.seed), str(REF_LEN)],
            child_env(JAX_PLATFORMS="cpu"))
        log(f"input: {REF_LEN}-bp circular reference, {args.reads} reads, "
            f"seed {args.seed}; flags {' '.join(FLAGS)}")
        want = phase_native(work)
        if args.cards == 4:
            c = phase_inprocess(work, want, "dp4", ["--dp-devices", "4"])
            need("dp4", c, "pass1.mesh_devices", lambda v: v == 4)
            need("dp4", c, "pass1.result_devices", lambda v: v == 4)
            log("dp4: byte-identical to native over 4 distinct devices")
        else:
            phase_entries(work, args.seed)
            served_maln, served_ccheck = phase_served(work, want)
            phase_inprocess(work, want)
            phase_goldens(work)
            phase_ccheck(work, served_maln, served_ccheck)

    # every child has exited: only now does this process open the card
    import jax

    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind, "count": len(d)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        print(f"chip_smoke: FAILED ({str(e).splitlines()[0]})", flush=True)
        sys.exit(1)
