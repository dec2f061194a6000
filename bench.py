"""Benchmark: end-to-end assembly throughput + kernel numbers on one chip.

Prints ONE JSON line:
  {"metric": "e2e_reads_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": N, "detail": {...}}

The workload is BASELINE config 3 shaped: 20k simulated damaged reads vs a
16.5 kb circular reference, k-mer filtered, iterated to convergence.  The
baseline is the reference C implementation BUILT AND TIMED BY THIS SCRIPT
on the same workload on this machine (single core, -O2); if no C toolchain
is available a stored measurement of the same recipe is used and labeled.

Correctness gate: the maln output of every timed engine must be
byte-identical (minus the timestamp header) to the C binary's (or, without
a C binary, engines must agree with each other).

detail carries: per-engine wall times (cold + warm for the device engine —
cold includes the one-time XLA compile), the banded-window kernel Gcells/s
(the shape production batches actually run, WIN_W=384), and a dp=1 vs dp=8
virtual-CPU-mesh scaling ratio (correctness stand-in only: the 8 "devices"
share this host's cores, so it measures sharding overhead, not scaling).

One process per card: the in-process device rows run while no server is
alive, and this process opens the card only after the server has exited.
"""
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# same recipe as this script's C build, measured on this box when no
# toolchain is available at bench time
STORED_C_SECONDS_20K = 66.5
N_READS = 20000


def _gen_workload(d: str) -> tuple[str, str]:
    from mia.models.simulate import SimConfig, random_reference, simulate_reads

    ref = random_reference(16569, seed=7)
    ref_fn = os.path.join(d, "mt.fna")
    with open(ref_fn, "w") as f:
        f.write(">mt_sim simulated\n")
        for i in range(0, len(ref), 70):
            f.write(ref[i : i + 70] + "\n")
    frag_fn = os.path.join(d, "r20k.fastq")
    with open(frag_fn, "w") as f:
        for name, seq, qual in simulate_reads(
            ref, SimConfig(num_reads=N_READS, mean_len=60, seed=3)
        ):
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    return ref_fn, frag_fn


def _build_c_reference() -> str | None:
    """Compile the reference C mia into a temp tree; None if not possible."""
    if os.path.exists("/tmp/refsrc/src/mia"):
        return "/tmp/refsrc/src/mia"
    src = "/root/reference"
    if not os.path.isdir(src) or shutil.which("gcc") is None:
        return None
    try:
        shutil.copytree(src, "/tmp/refsrc", dirs_exist_ok=True)
        sdir = "/tmp/refsrc/src"
        with open(os.path.join(sdir, "config.h"), "w") as f:
            f.write(
                '#define PACKAGE_NAME "MIA"\n#define PACKAGE_VERSION "1.0"\n'
                '#define PACKAGE_BUGREPORT "x"\n'
            )
        cfiles = (
            "myers_align.c fsdb.c io.c kmer.c map_align.c map_alignment.c "
            "mia.c pssm.c mia_main.c"
        ).split()
        subprocess.run(
            ["gcc", "-std=gnu89", "-O2", "-DDATA_PATH=\"/tmp/refsrc/share\"",
             "-include", "config.h", "-o", "mia", *cfiles, "-lm"],
            cwd=sdir, check=True, capture_output=True, timeout=300,
        )
        return os.path.join(sdir, "mia")
    except Exception:
        return None


def _norm_maln(path: str) -> bytes:
    with open(path, "rb") as fh:
        return b"\n".join(fh.read().split(b"\n")[1:])


def _run_ours(
    ref_fn, frag_fn, engine, tag, timeout=900, env_extra=None
) -> tuple[float, str] | None:
    d = tempfile.mkdtemp(prefix=f"bench_{tag}_")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("MIA_SERVER", "0")  # explicit server rows only
    if env_extra:
        env.update(env_extra)
    t0 = time.time()
    try:
        subprocess.run(
            [sys.executable, "-m", "mia.cli.mia", "-r", ref_fn, "-f",
             frag_fn, "-c", "-k", "12", "-m", os.path.join(d, "out.maln"),
             "--engine", engine],
            env=env, check=True, capture_output=True, timeout=timeout,
        )
    except Exception:
        return None
    return time.time() - t0, os.path.join(d, "out.maln.1")


def _median_runs(n, fn):
    """Median wall time over n runs of fn() -> (seconds, maln) | None."""
    runs = [r for r in (fn() for _ in range(n)) if r]
    if not runs:
        return None
    runs.sort(key=lambda r: r[0])
    return runs[len(runs) // 2]


def _start_server(sock: str):
    """Resident scoring server on its own socket; returns the Popen (kill
    THIS pid, never a pattern)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    log = open(sock + ".log", "wb")
    srv = subprocess.Popen(
        [sys.executable, "-m", "mia.cli.serve", "--sock", sock,
         "--idle-timeout", "3600"],
        env=env, stdout=log, stderr=log,
    )
    deadline = time.time() + 120
    while time.time() < deadline and not os.path.exists(sock):
        if srv.poll() is not None:
            return None
        time.sleep(0.3)
    return srv if os.path.exists(sock) else None


def _kernel_numbers(detail: dict) -> None:
    """Banded-window scoring-program Gcells/s on the local device."""
    import mia.core.jax_engine as je
    from mia.ops.pssm import init_flatsubmat

    rng = np.random.default_rng(0)
    len1 = 16825
    fw = rng.integers(0, 4, len1).astype(np.int8)
    sm = init_flatsubmat().astype(np.int32)
    sc = je.Pass1Scorer(fw, fw, len1, sm, warm=False)
    E, K, L, W = sc.E, je.MAX_INTERVALS, je.L_MAX, je.WIN_W
    s2c = rng.integers(0, 4, (E, L)).astype(np.int8)
    ln = rng.integers(30, 120, E).astype(np.int32)
    ws = rng.integers(0, len1 - W, E).astype(np.int32)
    ivl = np.zeros((E, K, 2), np.int32)
    ivl[:, 0, 0] = 2
    ivl[:, 0, 1] = W
    rsel = np.zeros(E, np.int8)
    smi = np.zeros(E, np.int8)

    # correctness gate: kernel (best, aec) vs the exact scalar-oracle engine
    from mia.core.driver import init_alignment, set_seq1, set_seq2
    from mia.ops import dp_numpy as dpn
    from mia.utils.encoding import encode_seq

    h = sc.dispatch_entries(rsel[:3], ws[:3], ivl[:3], s2c[:3], ln[:3], smi[:3])
    kb, ka = sc.collect_entries(h)
    ref_str = "ACGTN"
    chars = np.array(list("ACGTN"))
    for b in range(3):
        a = init_alignment(L, len1 + 16, False, False)
        a.submat = sm
        set_seq1(a, "".join(chars[np.asarray(sc._refs[0, :len1])]))
        set_seq2(a, "".join(chars[s2c[b, : ln[b]]]))
        a.sg5 = a.sg3 = True
        a.align_mask[: a.len1] = 0
        a.align_mask[ws[b] + 2 : ws[b] + W] = 1
        dpn.solve_sg(a, do_trace=False)
        if not (a.best_score == kb[b] and a.aec == ka[b] + ws[b]):
            detail["kernel_gate"] = "MISMATCH vs exact host engine"
            return
    detail["kernel_gate"] = "exact vs scalar oracle"

    t0 = time.time()
    h = sc.dispatch_entries(rsel, ws, ivl, s2c, ln, smi)
    sc.collect_entries(h)
    warm = time.time() - t0
    n_it = 4
    t0 = time.time()
    hs = [sc.dispatch_entries(rsel, ws, ivl, s2c, ln, smi) for _ in range(n_it)]
    for h in hs:
        sc.collect_entries(h)
    dt = time.time() - t0
    detail["banded_win384_gcells_per_s"] = round(n_it * E * W * L / dt / 1e9, 2)
    detail["banded_entries_per_s"] = round(n_it * E / dt, 1)

    # DEVICE-ONLY rate: the banded number above includes the per-batch
    # upload; the marginal rows-sweep cancels that fixed cost and measures
    # the program's own Gcells/s of COMPUTED cells
    try:
        times = {}
        for rows in (40, 250):
            lnr = np.full(E, rows, np.int32)
            h = sc.dispatch_entries(rsel, ws, ivl, s2c, lnr, smi)
            sc.collect_entries(h)
            t0 = time.time()
            hs = [sc.dispatch_entries(rsel, ws, ivl, s2c, lnr, smi)
                  for _ in range(n_it)]
            for h in hs:
                sc.collect_entries(h)
            times[rows] = (time.time() - t0) / n_it
        marginal = (times[250] - times[40]) / 210.0  # s per extra row
        if marginal > 0:
            detail["banded_device_gcells_per_s"] = round(
                E * W / marginal / 1e9, 2
            )
    except Exception as e:
        detail["banded_device_error"] = type(e).__name__


def _mesh_scaling(detail: dict) -> None:
    """dp=1..8 sweep on the virtual CPU mesh: fixed total work, per-dp wall
    time, entries/s and the host-side dispatch (pack/sort/shard-put)
    overhead split out — the sharding layer's overhead curve, measurable
    without real multi-device hardware."""
    script = r"""
import os, time, json
import numpy as np
import jax
from jax.sharding import Mesh
import mia.core.jax_engine as je
from mia.ops.pssm import init_flatsubmat
rng = np.random.default_rng(0)
len1 = 4096
fw = rng.integers(0,4,len1).astype(np.int8)
sm = init_flatsubmat().astype(np.int32)
out = {}
for nd in (1, 2, 4, 8):
    mesh = Mesh(np.array(jax.devices()[:nd]), ("dp",)) if nd > 1 else None
    sc = je.Pass1Scorer(fw, fw, len1, sm, batch=256, mesh=mesh, warm=False)
    E = sc.E
    s2c = rng.integers(0,4,(E,je.L_MAX)).astype(np.int8)
    ln = rng.integers(30,120,E).astype(np.int32)
    ws = rng.integers(0,len1-je.WIN_W,E).astype(np.int32)
    ivl = np.zeros((E,je.MAX_INTERVALS,2),np.int32); ivl[:,0,0]=2; ivl[:,0,1]=je.WIN_W
    z8 = np.zeros(E,np.int8)
    sc.collect_entries(sc.dispatch_entries(z8, ws, ivl, s2c, ln, z8))
    n_it = 2
    t0=time.time(); disp=0.0
    for _ in range(n_it):
        td=time.time()
        h = sc.dispatch_entries(z8, ws, ivl, s2c, ln, z8)
        disp += time.time()-td
        sc.collect_entries(h)
    dt = time.time()-t0
    out[nd] = {"s": dt, "entries_per_s": n_it*E/dt, "dispatch_s": disp}
print(json.dumps(out))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    try:
        r = subprocess.run(
            [sys.executable, "-c", script], env=env, capture_output=True,
            check=True, timeout=900,
        )
        t = json.loads(r.stdout.decode().strip().splitlines()[-1])
        sweep = {}
        for nd, row in t.items():
            sweep[f"dp{nd}"] = {
                "s": round(row["s"], 2),
                "entries_per_s": round(row["entries_per_s"], 1),
                "dispatch_s": round(row["dispatch_s"], 2),
            }
        detail["cpu_mesh_dp_sweep"] = sweep
        detail["cpu_mesh_dp8_speedup"] = round(t["1"]["s"] / t["8"]["s"], 2)
        detail["cpu_mesh_note"] = (
            "virtual devices share the host's cores: the sweep measures the "
            "sharding layer's dispatch/collect overhead curve, not device "
            "scaling"
        )
    except Exception as e:
        detail["cpu_mesh_error"] = type(e).__name__


def main() -> int:
    detail: dict = {}
    d = tempfile.mkdtemp(prefix="bench_wl_")
    sys.path.insert(0, REPO)
    ref_fn, frag_fn = _gen_workload(d)

    # --- C reference baseline (same script, same workload, same box) ------
    c_mia = _build_c_reference()
    c_seconds = None
    c_maln = None
    if c_mia:
        cd = tempfile.mkdtemp(prefix="bench_c_")
        t0 = time.time()
        try:
            subprocess.run(
                [c_mia, "-r", ref_fn, "-f", frag_fn, "-c", "-k", "12", "-m",
                 os.path.join(cd, "out.maln")],
                check=True, capture_output=True, timeout=1800,
            )
            c_seconds = time.time() - t0
            c_maln = os.path.join(cd, "out.maln.1")
        except Exception:
            c_seconds = None
    if c_seconds is None:
        c_seconds = STORED_C_SECONDS_20K
        detail["c_baseline"] = f"stored measurement ({c_seconds}s; build unavailable)"
    else:
        detail["c_baseline"] = "built and timed by this script"
    detail["c_seconds"] = round(c_seconds, 2)

    # --- our engines -------------------------------------------------------
    # native: threaded C++ engine, median of 3.
    # jax (no server): the production default path — work-steals to native
    #   while the device program compiles/loads, so it is never slower than
    #   native; cold (first-ever compile, writes the persistent cache) and
    #   warm are reported separately.
    # jax+server: the serving deployment — a resident process holds the
    #   initialized backend + warm programs; runs only ship batches.  This
    #   is where the chip's scoring latency actually shows up end-to-end.
    runs = {}
    detail["jax_note"] = (
        "jax rows run with MIA_SERVER=0 (in-process device runtime; "
        "pays backend init + executable load per process, work-stealing "
        "keeps it ~native). Production default auto-spawns the resident "
        "server = the jax_server rows, which run after the in-process "
        "rows (one process per card).  native and in-process jax rounds "
        "are INTERLEAVED so time-varying host load hits both medians "
        "equally."
    )
    samples = {"native": [], "jax": [], "jax_server": []}
    # in-process device rows first: they open the card themselves, so no
    # server may hold it while they run
    jx_cold = _run_ours(ref_fn, frag_fn, "jax", "jxc")
    if jx_cold:
        detail["jax_cold_seconds"] = round(jx_cold[0], 2)
    for _ in range(5):
        r = _run_ours(ref_fn, frag_fn, "native", "nat")
        if r:
            samples["native"].append(r)
        r = _run_ours(ref_fn, frag_fn, "jax", "jxw")
        if r:
            samples["jax"].append(r)

    sock = os.path.join(tempfile.mkdtemp(prefix="bench_srv_"), "serve.sock")
    srv = _start_server(sock)
    # the PRODUCTION configuration: resident server + work-stealing (steal
    # left at its default — forcing MIA_STEAL=0 makes every run block
    # on per-run scorer init instead of overlapping it, which is not how
    # the engine ships; device engagement with a warm server is immediate
    # for pass 1 and content-cached for realignment)
    senv = {"MIA_SERVER": sock}
    try:
        if srv is not None:
            sc = _run_ours(ref_fn, frag_fn, "jax", "jsc", env_extra=senv)
            if sc:
                detail["jax_server_cold_seconds"] = round(sc[0], 2)
            for _ in range(5):
                r = _run_ours(ref_fn, frag_fn, "jax", "jsw", env_extra=senv)
                if r:
                    samples["jax_server"].append(r)
        for name, key in (
            ("native", "native_seconds"),
            ("jax", "jax_warm_seconds"),
            ("jax_server", "jax_server_warm_seconds"),
        ):
            ss = sorted(samples[name], key=lambda r: r[0])
            if ss:
                runs[name] = ss[len(ss) // 2]
                detail[key] = round(runs[name][0], 2)

        # 100k-read pair (informational), native against the served engine
        try:
            from mia.models.simulate import SimConfig, simulate_reads
            frag100 = os.path.join(d, "r100k.fastq")
            if not os.path.exists(frag100):
                with open(ref_fn) as fh:
                    ref_seq = "".join(
                        ln.strip() for ln in fh if not ln.startswith(">")
                    )
                with open(frag100, "w") as f:
                    for name, seq, qual in simulate_reads(
                        ref_seq, SimConfig(num_reads=100000, mean_len=60, seed=3)
                    ):
                        f.write(f"@{name}\n{seq}\n+\n{qual}\n")
            # interleaved medians: pair the engines per round so load
            # windows hit both
            s100 = {"native": [], "jax": []}
            for _ in range(3):
                r = _run_ours(ref_fn, frag100, "native", "n100", timeout=1200)
                if r:
                    s100["native"].append(r)
                if srv is not None:
                    r = _run_ours(
                        ref_fn, frag100, "jax", "j100", timeout=1200,
                        env_extra=senv,
                    )
                    if r:
                        s100["jax"].append(r)
            n100 = sorted(s100["native"], key=lambda r: r[0])
            j100 = sorted(s100["jax"], key=lambda r: r[0])
            n100 = n100[len(n100) // 2] if n100 else None
            j100 = j100[len(j100) // 2] if j100 else None
            if n100:
                detail["native_100k_seconds"] = round(n100[0], 2)
            if j100:
                detail["jax_server_100k_seconds"] = round(j100[0], 2)
            if n100 and j100 and _norm_maln(n100[1]) != _norm_maln(j100[1]):
                detail["parity_100k"] = "MISMATCH"
        except Exception as e:
            detail["e2e_100k_error"] = type(e).__name__
    finally:
        if srv is not None:
            srv.terminate()
            try:
                srv.wait(timeout=30)
            except subprocess.TimeoutExpired:
                srv.kill()

    # correctness gate
    oracle = c_maln or (runs.get("native") and runs["native"][1])
    ok = True
    if oracle:
        want = _norm_maln(oracle)
        for name, (_, maln) in runs.items():
            if _norm_maln(maln) != want:
                ok = False
                detail[f"{name}_parity"] = "MALN MISMATCH"
    if not ok or not runs:
        print(json.dumps({
            "metric": "e2e_reads_per_s_per_chip", "value": 0.0,
            "unit": "reads/s", "vs_baseline": 0.0,
            "error": "no engine produced verified output", "detail": detail,
        }))
        return 1
    detail["parity"] = "all timed engines byte-identical to " + (
        "C reference" if c_maln else "each other (no C binary)"
    )

    best_engine = min(runs, key=lambda k: runs[k][0])
    best_s = runs[best_engine][0]
    detail["best_engine"] = best_engine
    detail["n_reads"] = N_READS
    try:
        import jax

        detail["device"] = str(jax.devices()[0])
    except Exception:
        pass

    _kernel_numbers(detail)
    _mesh_scaling(detail)

    reads_per_s = N_READS / best_s
    print(json.dumps({
        "metric": "e2e_reads_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / (N_READS / c_seconds), 1),
        "detail": detail,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
