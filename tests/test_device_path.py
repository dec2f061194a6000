"""The device scoring path on the CPU backend: the entry program against the
scalar oracle at production widths, its row-bound variants, device failures
that stop the run, the compile-cache location, the ``--dp-devices`` flag and
``chip_smoke.py``'s refusal to run without a GPU."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from .conftest import FIXTURES, REPO


def _cpu_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize("n_dev", [1, 4])
@pytest.mark.parametrize("sort_lengths", [True, False])
def test_entry_program_matches_oracle(n_dev, sort_lengths):
    """(best, aec) of the entry program == the exact host engine at W=384,
    L=256, on one device and on a 4-device ("dp",) mesh."""
    import mia.core.jax_engine as je
    from mia.core.entry_check import oracle_scores, random_entries

    ent = random_entries(120, seed=11 + n_dev, sort_lengths=sort_lengths)
    mesh = je.make_dp_mesh(n_dev) if n_dev > 1 else None
    assert (mesh.size if mesh is not None else 1) == n_dev
    sc = je.Pass1Scorer(ent.fw, ent.rc, len(ent.fw), ent.sms[0], ent.sms[1],
                        batch=64, mesh=mesh, warm=False)
    best, aec = sc.collect_entries(sc.dispatch_entries(*ent.args()))
    assert sc.result_devices == n_dev
    want_best, want_aec = oracle_scores(ent)
    np.testing.assert_array_equal(best, want_best)
    np.testing.assert_array_equal(aec, want_aec)


def test_row_bound_matches_full_scan():
    """The fori_loop bounded by the longest entry gives the same last rows
    as the lax.scan over every row."""
    import jax.numpy as jnp

    from mia.ops.dp_jax import batch_last_row_rowsm

    rng = np.random.default_rng(5)
    B, W, L = 16, 384, 256
    s1c = rng.integers(0, 5, (B, W)).astype(np.int32)
    mask = rng.random((B, W)) < 0.9
    row_sm = rng.integers(-600, 200, (B, L, 5)).astype(np.int32)
    lens = rng.integers(1, 120, B).astype(np.int32)
    full = batch_last_row_rowsm(s1c, mask, row_sm, lens)
    bounded = batch_last_row_rowsm(s1c, mask, row_sm, lens,
                                   n_rows=jnp.max(lens))
    np.testing.assert_array_equal(np.asarray(full), np.asarray(bounded))


def _failing_program(gate: threading.Event | None = None):
    def fn(*args):
        if gate is not None:
            gate.wait(60)
        raise RuntimeError("injected compile failure")

    return lambda: fn


def test_pass1_scorer_failure_is_not_ready(monkeypatch):
    """A failed warmup compile makes failed() true and raises from
    device_ready() and dispatch — it never reads as "still compiling"."""
    import mia.core.jax_engine as je
    from mia.core.entry_check import random_entries

    monkeypatch.setattr(je, "_plain_fn", _failing_program())
    ent = random_entries(4, seed=1)
    sc = je.Pass1Scorer(ent.fw, ent.rc, len(ent.fw), ent.sms[0], batch=8,
                        defer=True, warm=True)
    sc._init_thread.join(60)
    assert sc.failed()
    with pytest.raises(RuntimeError, match="injected compile failure"):
        sc.device_ready()
    with pytest.raises(RuntimeError, match="injected compile failure"):
        sc.dispatch_entries(*ent.args())


def test_server_scorer_failure_reaches_client(monkeypatch, tmp_path):
    """The same failure inside a CPU server: the client's failed() turns
    true and device_ready() raises the server's device error."""
    import mia.core.jax_engine as je
    from mia.core.entry_check import random_entries
    from mia.serve import Server, ServerScorer

    gate = threading.Event()
    monkeypatch.setattr(je, "_plain_fn", _failing_program(gate))
    sock = str(tmp_path / "s.sock")
    threading.Thread(
        target=Server(sock, idle_timeout=30).serve_forever, daemon=True
    ).start()
    deadline = time.time() + 60
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    ent = random_entries(4, seed=2)
    sc = ServerScorer(ent.fw, ent.rc, len(ent.fw), ent.sms[0], batch=8,
                      path=sock)
    assert not sc.failed()
    assert not sc.device_ready()  # compiling: the one case that may steal
    gate.set()
    while not sc.failed() and time.time() < deadline:
        time.sleep(0.05)
    assert sc.failed()
    with pytest.raises(RuntimeError, match="injected compile failure"):
        sc.device_ready()
    sc.close()


@pytest.mark.parametrize("cli", ["mia", "ccheck"])
def test_cli_stops_on_device_failure(cli, monkeypatch, tmp_path):
    """`mia --engine jax` and `ccheck --engine jax` raise (exit non-zero)
    when the device program fails."""
    import mia.core.jax_engine as je

    monkeypatch.setattr(je, "_plain_fn", _failing_program())
    monkeypatch.setenv("MIA_STEAL", "0")
    monkeypatch.setenv("MIA_SCORE_BATCH", "64")
    monkeypatch.chdir(tmp_path)
    if cli == "mia":
        from mia.cli.mia import main

        argv = ["-r", os.path.join(FIXTURES, "tr1.fna"), "-f",
                os.path.join(FIXTURES, "tf.fna"), "-k", "12", "-m",
                str(tmp_path / "out.maln"), "--engine", "jax"]
    else:
        from mia.cli.ccheck import main

        argv = ["--engine", "jax", "-T", "-a",
                os.path.join(REPO, "tests", "golden", "ccheck", "cc.maln.1")]
    with pytest.raises(RuntimeError, match="injected compile failure"):
        main(argv)


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_location(from_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR when set (and nothing set in code);
    otherwise the fixed in-checkout directory that .gitignore lists."""
    from mia.utils.jaxcfg import CACHE_DIR

    env = _cpu_env()
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = CACHE_DIR
    if from_env:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    code = (
        "import jax, jax.numpy as jnp\n"
        "from mia.utils.jaxcfg import setup_jax_cache, cache_dir_path\n"
        "setup_jax_cache()\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(11)).block_until_ready()\n"
        "print(jax.config.jax_compilation_cache_dir, cache_dir_path())\n"
    )
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300, check=True)
    assert r.stdout.split() == [want, want]
    assert os.listdir(want)
    if not from_env:
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert os.path.basename(CACHE_DIR) + "/" in fh.read().split()


@pytest.fixture
def cpu_server(monkeypatch):
    """A scoring server on the CPU backend in its own process; yields its
    socket path."""
    import tempfile

    from mia.serve import hello

    monkeypatch.setenv("MIA_SCORE_BATCH", "64")
    sock = os.path.join(tempfile.mkdtemp(prefix="mia"), "s.sock")
    srv = subprocess.Popen(
        [sys.executable, "-m", "mia.cli.serve", "--sock", sock,
         "--idle-timeout", "120"],
        env=_cpu_env(), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        deadline = time.time() + 120
        while True:
            try:
                hello(sock)
                break
            except OSError:
                assert srv.poll() is None, "server exited"
                assert time.time() < deadline, "server never answered"
                time.sleep(0.1)
        yield sock
    finally:
        srv.terminate()
        srv.wait(30)


def test_ccheck_runs_through_live_server(cpu_server, monkeypatch, capsys):
    """ccheck --engine jax with a server running sends the Myers alignment
    and the realignment to it, and writes the golden table."""
    from mia.cli.ccheck import main
    from mia.serve import hello

    monkeypatch.setenv("MIA_SERVER", cpu_server)
    monkeypatch.chdir(os.path.join(REPO, "tests", "golden", "ccheck"))
    assert main(["--engine", "jax", "-T", "-a", "cc.maln.1"]) == 0
    with open("table_a.txt") as fh:
        assert capsys.readouterr().out == fh.read()
    ops = hello(cpu_server)["ops"]
    assert ops.get("myers") == 1 and ops.get("dispatch", 0) >= 1


@pytest.mark.parametrize("via", ["MIA_SERVER", "MIA_SERVER_SOCK"])
def test_in_process_device_run_refused_while_served(cpu_server, monkeypatch,
                                                    via):
    """An in-process device run (a second process on the card) refuses
    while a server answers at the default socket or the MIA_SERVER one."""
    from mia.serve import live_server, refuse_if_served

    monkeypatch.setenv(via, cpu_server)
    if via == "MIA_SERVER_SOCK":
        monkeypatch.setenv("MIA_SERVER", "0")
        assert live_server() is None
    else:
        assert live_server() == cpu_server
    with pytest.raises(RuntimeError, match="holds the device"):
        refuse_if_served()


def test_no_server_no_refusal_and_no_spawn_without_stealing(monkeypatch,
                                                            tmp_path):
    """With no server answering nothing is refused; a run that waits for
    its own device program (MIA_STEAL=0) spawns no server."""
    from mia.serve import connect_scorer, live_server, refuse_if_served

    sock = str(tmp_path / "none.sock")
    monkeypatch.setenv("MIA_SERVER_SOCK", sock)
    monkeypatch.setenv("MIA_SERVER", "auto")
    monkeypatch.setenv("MIA_STEAL", "0")
    assert live_server() is None
    refuse_if_served()
    assert connect_scorer(np.zeros(8, np.int8), np.zeros(8, np.int8), 8,
                          np.zeros((31, 5, 5), np.int32)) is None
    assert not os.path.exists(sock + ".spawn")


@pytest.mark.parametrize("name,ok", [
    ("MIA_STEAL", True), ("MIA_SERVER_SOCK", True), ("MIA_REF", True),
    ("MIA_OLD_STEAL", False), ("MIA_OLD_SERVER", False),
    ("MIA_OLD_SERVER_SOCK", False), ("MIA_OLD_SCORE_BATCH", False),
])
def test_renamed_switch_is_refused(name, ok):
    """A switch set under an older prefix stops the CLI instead of being
    ignored; current switches and unrelated MIA_* variables pass."""
    from mia.config import check_switches

    if ok:
        check_switches({name: "0"})
    else:
        with pytest.raises(SystemExit, match=name):
            check_switches({name: "0"})


@pytest.mark.parametrize("flag", ["--dp-devices", "--dp"])
def test_dp_devices_flag(flag):
    from mia.cli.mia import parse_args

    cfg = parse_args(["-r", "ref.fna", "-f", "reads.fq", flag, "4"])
    assert cfg.dp_devices == 4


def test_chip_smoke_refuses_cpu(tmp_path):
    """Without a GPU the smoke exits non-zero and prints no result line."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        env=_cpu_env(), cwd=tmp_path, capture_output=True, text=True,
        timeout=300,
    )
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        try:
            assert not json.loads(line).get("ok")
        except (ValueError, AttributeError):
            pass
