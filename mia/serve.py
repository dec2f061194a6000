"""Resident device scoring server + client.

Every process that uses the device pays backend init and executable load
before its first batch can score; the reference is an AOT C binary with
zero startup.  This module keeps one resident process holding the
initialized backend and the compiled scoring programs, and serves batches
to short-lived CLI runs over a unix-domain socket — the standard
serving-daemon architecture, sized down to one file.  It is also the one
process that holds the card: clients never initialise a JAX backend.

Protocol: length-prefixed pickles over a unix socket (local, same-uid;
socket mode 0600).  Ops:

    hello    -> {platform, device_kind, devices, pid, ops, warming, compile_s}
    scorer   {fw, rc, len1, sms, batch}    -> {sid, ready, error}
    ready    {sid}                         -> {ready, error}
    dispatch {sid, ref_sel, starts, ivl, s2c, lengths, smidx} -> {hid}
    hready   {hid}                         -> {ready}
    collect  {hid}                         -> {best, aec}
    consensus {seq, smp, starts, ...}      -> {counts, cov, scores} | {cold}
    myers    {a, mode, b, maxd}            -> {result}
    free     {sid}                         -> {}

The server wraps :class:`mia.core.jax_engine.Pass1Scorer`; scorers are
cached by content hash so every iteration's consensus gets its own scorer
while the underlying jitted program (shape-keyed) stays warm.  The client
:class:`ServerScorer` mirrors the Pass1Scorer surface the assembler uses
(dispatch_entries/collect_entries/dispatch_packed/collect_arrays/
device_ready/failed), so `run_assembly` treats both identically.  A device
failure on the server reaches the client as an error, never as "not ready".

Reference analogue: none — the reference (single-shot C binary,
src/mia_main.c) has no serving mode.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import socket
import struct
import tempfile
import threading

import numpy as np

# under TMPDIR: a process with its own TMPDIR gets its own server
DEFAULT_SOCK = os.path.join(tempfile.gettempdir(), f"mia-serve-{os.getuid()}.sock")
_MAGIC = b"MIA1"


def sock_path() -> str:
    return os.environ.get("MIA_SERVER_SOCK", DEFAULT_SOCK)


_CONS_KEYS = ("seq", "smp", "starts", "spans", "seq_off", "smp_off", "revs",
              "fpsm", "rpsm")


def _send(conn: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(_MAGIC + struct.pack("<Q", len(data)) + data)


def _recv(conn: socket.socket):
    hdr = b""
    while len(hdr) < 12:
        chunk = conn.recv(12 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    if hdr[:4] != _MAGIC:
        raise ConnectionError("bad magic")
    (n,) = struct.unpack("<Q", hdr[4:12])
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], n - got)
        if not r:
            raise ConnectionError("peer closed mid-message")
        got += r
    return pickle.loads(bytes(buf))


# ---------------------------------------------------------------- warm shapes
def _warmlist_path() -> str:
    from .utils.jaxcfg import cache_dir_path

    return os.path.join(cache_dir_path(), "warm_shapes.json")


def record_warm_shape(entry: dict) -> None:
    """Append a program shape to the warm list (deduped, capped) so the next
    server start can prewarm it from the persistent compile cache."""
    import json

    try:
        path = _warmlist_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        shapes: list = []
        if os.path.exists(path):
            with open(path) as fh:
                shapes = json.load(fh)
        if entry in shapes:
            return
        shapes.append(entry)
        with open(path, "w") as fh:
            json.dump(shapes[-8:], fh)
    except Exception:
        pass  # warm list is an optimization only


def prewarm_recorded_shapes() -> int:
    """Compile/load every recorded program shape (dummy values, real
    shapes): with a populated persistent cache this deserializes instead of
    compiling on the first real batch.  A shape that fails is reported and
    skipped; the real request for it compiles again and raises.  Returns
    the number of shapes warmed."""
    import json

    import numpy as np

    try:
        with open(_warmlist_path()) as fh:
            shapes = json.load(fh)
    except Exception:
        return 0
    warmed = 0
    for e in shapes:
        try:
            if e.get("kind") == "scorer":
                from .core.jax_engine import Pass1Scorer

                len1 = int(e["len1"])
                dummy = np.zeros(len1, np.int8)
                sm = np.zeros((31, 5, 5), np.int32)
                hp_seqs = ("A" * len1, "A" * len1) if e.get("hp") else None
                sc = Pass1Scorer(
                    dummy, dummy, len1, sm, batch=int(e["batch"]), warm=True,
                    defer=False, hp_seqs=hp_seqs,
                )
                deadline = _now() + 600.0
                while (
                    not sc._warmed and not sc.failed() and _now() < deadline
                ):
                    _sleep(0.2)
                warmed += 1
            elif e.get("kind") == "consensus":
                from .ops.consensus_device import device_column_counts

                total, R, n = int(e["total"]), int(e["R"]), int(e["n"])
                spans = np.zeros(R, np.int32)
                spans[0] = total
                device_column_counts(
                    np.zeros(max(total, 1), np.uint8),
                    np.full(max(total, 1), 65, np.uint8),
                    np.zeros(R, np.int32), spans,
                    np.zeros(R, np.int32), np.zeros(R, np.int32),
                    np.zeros(R, np.int8),
                    np.zeros((31, 5, 5), np.int64),
                    np.zeros((31, 5, 5), np.int64),
                    n,
                )
                warmed += 1
        except Exception as err:
            print(f"mia-serve: prewarm of {e} failed: "
                  f"{type(err).__name__}: {err}", flush=True)
    return warmed


def _sleep(s: float) -> None:
    import time

    time.sleep(s)


# --------------------------------------------------------------------- server
class Server:
    """Single-process scoring server; one thread per client connection.

    Scorer/handle tables are shared across connections (a client may
    reconnect); dispatches run on the owning connection's thread — the jax
    dispatch itself is asynchronous, so interleaved clients still pipeline
    on the device.  Cold consensus shapes compile on one background thread
    of this same process.
    """

    def __init__(self, path: str | None = None, idle_timeout: float = 0.0):
        import concurrent.futures

        self.path = path or sock_path()
        self.idle_timeout = idle_timeout
        self._scorers: dict[str, object] = {}
        self._handles: dict[int, tuple] = {}
        self._hid = 0
        self._lock = threading.Lock()
        self._last_activity = _now()
        # consensus shapes compiling on the warm thread, and shapes whose
        # compile failed (the next request for them raises the error)
        self._warm_pool = concurrent.futures.ThreadPoolExecutor(1)
        self._pending_warm_keys: set = set()
        self._warm_errors: dict = {}
        self._consensus_compile_s = 0.0
        self._ops: dict[str, int] = {}  # requests served, per op

    def serve_forever(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # umask guard: the socket must never be group/other-connectable even
        # for an instant (the protocol is pickle = code execution on accept)
        old_umask = os.umask(0o177)
        try:
            srv.bind(self.path)
        finally:
            os.umask(old_umask)
        os.chmod(self.path, 0o600)
        self._sock_ino = os.stat(self.path).st_ino
        srv.listen(16)
        srv.settimeout(5.0)
        try:
            # initialize the backend (scorers warm on demand)
            import jax

            d = jax.devices()
            print(
                f"mia-serve: ready on {self.path} (platform={d[0].platform} "
                f"device_kind={d[0].device_kind} devices={len(d)})",
                flush=True,
            )

            # prewarm previously-seen program shapes from the persistent
            # compile cache so the first real batch finds them loaded
            def _prewarm():
                n = prewarm_recorded_shapes()
                if n:
                    print(f"mia-serve: prewarmed {n} shape(s)", flush=True)

            threading.Thread(target=_prewarm, daemon=True).start()
            while True:
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    if (
                        self.idle_timeout
                        and _now() - self._last_activity > self.idle_timeout
                    ):
                        print("mia-serve: idle timeout, exiting", flush=True)
                        return
                    continue
                t = threading.Thread(target=self._client, args=(conn,), daemon=True)
                t.start()
        finally:
            # leave no stale socket behind: a dead socket would make every
            # future connect_scorer fail AND suppress respawn forever.
            # Only unlink OUR socket — a racing newer server may have
            # re-bound the path (compare inodes before removing).
            try:
                if os.stat(self.path).st_ino == self._sock_ino:
                    os.unlink(self.path)
                    try:
                        os.unlink(self.path + ".spawn")
                    except OSError:
                        pass
            except OSError:
                pass

    def _warm_consensus(self, key, args) -> None:
        """Compile one consensus shape on the warm thread (at most one
        queued compile per shape)."""
        with self._lock:
            if key in self._pending_warm_keys:
                return
            self._pending_warm_keys.add(key)

        def _do():
            from .ops.consensus_device import device_column_counts

            t0 = _now()
            try:
                device_column_counts(*args)
                self._consensus_compile_s += _now() - t0
                print(f"mia-serve: warmed consensus shape {key}", flush=True)
            except Exception as e:
                self._warm_errors[key] = f"{type(e).__name__}: {e}"
            finally:
                with self._lock:
                    self._pending_warm_keys.discard(key)

        self._warm_pool.submit(_do)

    def _warming(self) -> int:
        """Programs still compiling: consensus shapes and scorer warmups."""
        with self._lock:
            n = len(self._pending_warm_keys)
            scorers = list(self._scorers.values())
        return n + sum(
            1 for sc in scorers
            if sc._init_thread is not None and sc._init_thread.is_alive()
        )

    @staticmethod
    def _scorer_status(sc) -> dict:
        # construction is quick here (the backend is up); wait for it so a
        # warm program reads as ready on the first ask
        sc._dev_ready.wait()
        err = sc._init_error
        if err is not None:
            return {"ready": False, "error": f"{type(err).__name__}: {err}"}
        return {"ready": sc.device_ready(), "error": None}

    def _client(self, conn: socket.socket) -> None:
        try:
            while True:
                req = _recv(conn)
                self._last_activity = _now()
                try:
                    resp = ("ok", self._handle(req))
                except Exception as e:  # report, keep serving
                    import traceback

                    resp = ("err", f"{type(e).__name__}: {e}\n"
                            + traceback.format_exc(limit=5))
                _send(conn, resp)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def _handle(self, req):
        op = req["op"]
        with self._lock:
            self._ops[op] = self._ops.get(op, 0) + 1
        if op == "hello":
            import jax

            d = jax.devices()
            with self._lock:
                scorers = list(self._scorers.values())
            return {"platform": d[0].platform, "device_kind": d[0].device_kind,
                    "devices": len(d), "pid": os.getpid(),
                    "ops": dict(self._ops), "warming": self._warming(),
                    "compile_s": {
                        "scorer": sum(sc.warmup_s for sc in scorers),
                        "consensus": self._consensus_compile_s,
                    }}
        if op == "scorer":
            from .core.jax_engine import Pass1Scorer

            hp_seqs = req.get("hp_seqs")
            key = hashlib.sha1(
                req["fw"].tobytes()
                + req["rc"].tobytes()
                + req["sms"].tobytes()
                + str((req["len1"], req["batch"])).encode()
                + (repr(hp_seqs).encode() if hp_seqs else b"")
            ).hexdigest()
            with self._lock:
                sc = self._scorers.get(key)
                if sc is None:
                    sc = Pass1Scorer(
                        req["fw"],
                        req["rc"],
                        req["len1"],
                        req["sms"][0],
                        req["sms"][1],
                        batch=req["batch"],
                        warm=True,
                        defer=True,
                        hp_seqs=hp_seqs,
                    )
                    self._scorers[key] = sc
                    record_warm_shape(
                        {"kind": "scorer", "len1": int(req["len1"]),
                         "batch": int(req["batch"]), "hp": bool(hp_seqs)}
                    )
            return {"sid": key, **self._scorer_status(sc)}
        if op == "ready":
            return self._scorer_status(self._scorers[req["sid"]])
        if op == "dispatch":
            sc = self._scorers[req["sid"]]
            h = sc.dispatch_entries(
                req["ref_sel"], req["starts"], req["ivl"], req["s2c"],
                req["lengths"], req["smidx"],
            )
            with self._lock:
                self._hid += 1
                hid = self._hid
                self._handles[hid] = (sc, h)
            return {"hid": hid}
        if op == "hready":
            sc, h = self._handles[req["hid"]]
            return {"ready": type(sc).ready(h)}
        if op == "collect":
            with self._lock:
                sc, h = self._handles.pop(req["hid"])
            best, aec = sc.collect_entries(h)
            return {"best": best, "aec": aec}
        if op == "consensus":
            # device consensus accumulation (ops/consensus_device.py): the
            # column-counts scatter-add runs on the device; bit-equal to the
            # host accumulators, so the client uses it as a drop-in.
            # nowait: a cold shape compiles on the warm thread while the
            # caller runs this one pass on host (the consensus analogue of
            # pass-1 work-stealing — a cold compile never stalls a run)
            from .ops.consensus_device import (
                device_column_counts,
                is_warm,
                shape_key,
            )

            args = tuple(req[k] for k in _CONS_KEYS) + (int(req["n"]),)
            dims = (int(req["spans"].sum()), len(req["spans"]), int(req["n"]))
            err = self._warm_errors.get(shape_key(*dims))
            if err is not None:
                raise RuntimeError(f"device consensus program failed: {err}")
            if req.get("nowait") and not is_warm(*dims):
                self._warm_consensus(shape_key(*dims), args)
                return {"cold": True}
            counts, cov, scores = device_column_counts(*args)
            record_warm_shape(
                {"kind": "consensus", "total": dims[0], "R": dims[1],
                 "n": dims[2]}
            )
            return {"counts": counts, "cov": cov, "scores": scores}
        if op == "myers":
            # ccheck's global alignment (ops/myers_jax.py)
            from .ops.myers_jax import myers_diff_jax

            return {"result": myers_diff_jax(
                req["a"], req["mode"], req["b"], int(req["maxd"]))}
        if op == "free":
            return {}
        raise ValueError(f"unknown op {op!r}")


def _now() -> float:
    import time

    return time.time()


# --------------------------------------------------------------------- client
def _call(path: str, req: dict, timeout: float = 5.0,
          reply_timeout: float = 60.0):
    """One request on its own connection."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    try:
        conn.connect(path)
        conn.settimeout(reply_timeout)
        _send(conn, req)
        status, payload = _recv(conn)
    finally:
        conn.close()
    if status != "ok":
        raise RuntimeError(f"server error: {payload}")
    return payload


def hello(path: str | None = None, timeout: float = 5.0) -> dict:
    """One ``hello`` round trip: the server's platform, device kind, device
    count, pid, requests served per op and programs still compiling."""
    return _call(path or sock_path(), {"op": "hello"}, timeout)


def served_myers(path: str):
    """:func:`mia.ops.myers_jax.myers_diff_jax`, run by the server at
    ``path``."""

    def differ(seq_a: str, mode, seq_b: str, maxd: int):
        return _call(path, {"op": "myers", "a": seq_a, "mode": mode,
                            "b": seq_b, "maxd": maxd},
                     reply_timeout=600.0)["result"]

    return differ


class ServerScorer:
    """Client-side scorer with the Pass1Scorer batch surface, backed by the
    resident server.  Construction never blocks on the device: the server
    warms the scorer in its own thread and `device_ready` polls it — the
    assembler's work-stealing logic applies unchanged.  A server-side device
    failure raises from `device_ready` and every other call."""

    def __init__(
        self,
        fw_s1c,
        rc_s1c,
        len1: int,
        submat,
        submat_b=None,
        batch: int | None = None,
        path: str | None = None,
        timeout: float = 5.0,
        hp_seqs: tuple[str, str] | None = None,
    ):
        from .core.jax_engine import default_batch

        self.len1 = len1
        self.batch = batch or default_batch()
        self.E = 2 * self.batch
        self.hp = hp_seqs is not None
        self._lock = threading.Lock()
        self._ready = False
        self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._conn.settimeout(timeout)
        self._conn.connect(path or sock_path())
        self._conn.settimeout(600.0)
        sms = np.stack(
            [
                np.asarray(submat, np.int32),
                np.asarray(submat_b if submat_b is not None else submat, np.int32),
            ]
        )
        fw = np.asarray(fw_s1c[:len1], np.int8)
        rc = np.asarray(rc_s1c[:len1], np.int8)
        r = self._rpc(
            {"op": "scorer", "fw": fw, "rc": rc, "len1": len1, "sms": sms,
             "batch": self.batch, "hp_seqs": hp_seqs}
        )
        self._sid = r["sid"]
        self._status(r)

    def _rpc(self, req):
        with self._lock:
            _send(self._conn, req)
            status, payload = _recv(self._conn)
        if status != "ok":
            raise RuntimeError(f"server error: {payload}")
        return payload

    def _status(self, r) -> bool:
        if r["error"] is not None:
            raise RuntimeError(
                f"device scoring program failed on the server: {r['error']}"
            )
        self._ready = bool(r["ready"])
        return self._ready

    # -- Pass1Scorer surface -------------------------------------------------
    def device_ready(self) -> bool:
        if self._ready:
            return True
        return self._status(self._rpc({"op": "ready", "sid": self._sid}))

    def failed(self) -> bool:
        return self._rpc({"op": "ready", "sid": self._sid})["error"] is not None

    def raise_if_failed(self) -> None:
        self._status(self._rpc({"op": "ready", "sid": self._sid}))

    def dispatch_entries(self, ref_sel, starts, ivl, s2c, lengths, smidx):
        n = len(ref_sel)
        if n == 0:
            return ("srv", None, 0)
        r = self._rpc(
            {
                "op": "dispatch",
                "sid": self._sid,
                "ref_sel": np.ascontiguousarray(ref_sel, np.int8),
                "starts": np.ascontiguousarray(starts, np.int32),
                "ivl": np.ascontiguousarray(ivl, np.int32),
                "s2c": np.ascontiguousarray(s2c, np.int8),
                "lengths": np.ascontiguousarray(lengths, np.int32),
                "smidx": np.ascontiguousarray(smidx, np.int8),
            }
        )
        return ("srv", self, r["hid"])

    def collect_entries(self, handle):
        _, owner, hid = handle[:3]
        if owner is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        r = self._rpc({"op": "collect", "hid": hid})
        return r["best"].astype(np.int64), r["aec"].astype(np.int64)

    def dispatch_packed(self, s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags):
        from .core.jax_engine import build_pass1_entries

        n = len(lens)
        if n == 0:
            return ("srv", None, 0, None, None)
        assert n <= self.batch
        entries = build_pass1_entries(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
        handle = self.dispatch_entries(*entries)
        return handle + (fw_ws.copy(), rc_ws.copy())

    def collect_arrays(self, handle):
        from .core.jax_engine import split_pass1_results

        best, aec = self.collect_entries(handle[:3])
        _, _, _, fw_ws, rc_ws = handle
        return split_pass1_results(best, aec, fw_ws, rc_ws)

    @staticmethod
    def ready(handle) -> bool:
        if handle[0] != "srv" or handle[1] is None:
            return True
        self, hid = handle[1], handle[2]
        return bool(self._rpc({"op": "hready", "hid": hid})["ready"])

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass


class _ConsensusClient:
    """One persistent connection shipping consensus accumulations to the
    resident server (columns.main_column_counts device_hook surface)."""

    def __init__(self, path: str):
        self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._conn.settimeout(5.0)
        self._conn.connect(path)
        self._conn.settimeout(600.0)
        self._lock = threading.Lock()

    def __call__(
        self, seq, smp, starts, spans, seq_off, smp_off, revs, fpsm, rpsm, n
    ):
        """(counts, cov, scores) from the device, or None when the server
        has no compiled program for this shape yet (it starts compiling
        one; the caller runs this pass on host)."""
        req = {
            "op": "consensus",
            "nowait": os.environ.get("MIA_STEAL", "1") != "0",
            "seq": np.ascontiguousarray(seq, np.uint8),
            "smp": np.ascontiguousarray(smp, np.uint8),
            "starts": np.ascontiguousarray(starts, np.int32),
            "spans": np.ascontiguousarray(spans, np.int32),
            "seq_off": np.ascontiguousarray(seq_off, np.int32),
            "smp_off": np.ascontiguousarray(smp_off, np.int32),
            "revs": np.ascontiguousarray(revs, np.int8),
            "fpsm": np.ascontiguousarray(fpsm, np.int32),
            "rpsm": np.ascontiguousarray(rpsm, np.int32),
            "n": int(n),
        }
        with self._lock:
            _send(self._conn, req)
            status, payload = _recv(self._conn)
        if status != "ok":
            raise RuntimeError(f"server error: {payload}")
        if payload.get("cold"):
            return None
        return (
            payload["counts"].astype(np.int64),
            payload["cov"].astype(np.int64),
            payload["scores"].astype(np.int64),
        )

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass


def _server_path() -> str | None:
    """Socket path the MIA_SERVER policy points at, None for "0" (never):
    a path = that socket; unset, "auto" or "spawn" = the default socket."""
    policy = os.environ.get("MIA_SERVER", "auto")
    if policy == "0":
        return None
    return policy if policy not in ("", "auto", "spawn") else sock_path()


def _answering(path: str) -> dict | None:
    """The hello of the server listening at ``path``, None when none does."""
    if not os.path.exists(path):
        return None
    try:
        return hello(path)
    except OSError:
        return None


def live_server() -> str | None:
    """Socket of the running server the MIA_SERVER policy points at (it is
    never spawned here), None when none answers."""
    path = _server_path()
    return path if path is not None and _answering(path) else None


def refuse_if_served() -> None:
    """Raise when a server holds the device.  The caller is about to open
    the device in its own process, and a second JAX process on one card
    fails for want of memory (each reserves most of it at start).  Checks
    the default socket and the one MIA_SERVER names."""
    for path in {sock_path(), _server_path()} - {None}:
        info = _answering(path)
        if info is not None:
            raise RuntimeError(
                f"a mia server (pid {info.get('pid')}, socket {path}) holds "
                "the device; run through it (MIA_SERVER unset or set to its "
                "socket, no --dp-devices) or stop it before an in-process "
                "device run"
            )


def connect_consensus(path: str | None = None) -> "_ConsensusClient | None":
    """Device-consensus hook bound to the server's socket; None when no
    socket exists (callers use the host accumulator).  Any other connection
    failure raises."""
    p = path or _server_path()
    if p is None or not os.path.exists(p):
        return None
    return _ConsensusClient(p)


def connect_scorer(*args, **kwargs) -> "ServerScorer | None":
    """ServerScorer when a server is running, else None.

    Policy via MIA_SERVER: "0" never; a path = that socket; unset or
    "auto" = the default socket, and when it does not exist yet a detached
    server is SPAWNED for subsequent runs (this run proceeds on the native
    engine — importing the device runtime in-process would fight the host
    cores for the GIL during the very work it is meant to speed up).
    "spawn" forces the spawn attempt too.  With MIA_STEAL=0 nothing is
    spawned: that run opens the device itself, and a server would be a
    second process on the card.

    None means "no server": no socket file, or a socket file that nobody
    listens on (a server that died without cleanup; it is removed).  Every
    other failure — including a device failure reported by the server —
    raises."""
    policy = os.environ.get("MIA_SERVER", "auto")
    path = _server_path()
    if path is None:
        return None
    spawn = (policy in ("", "auto", "spawn")
             and os.environ.get("MIA_STEAL", "1") != "0")
    if not os.path.exists(path):
        if spawn:
            spawn_server(path)
        return None
    try:
        return ServerScorer(*args, path=path, **kwargs)
    except (ConnectionRefusedError, FileNotFoundError):
        for p in (path, path + ".spawn"):
            try:
                os.unlink(p)
            except OSError:
                pass
        if spawn:
            spawn_server(path)
        return None


def spawn_server(path: str | None = None, idle_timeout: float = 3600.0) -> None:
    """Start a detached server process (for the NEXT run; returns at once).
    An O_EXCL lock file makes concurrent spawners race safely; the lock is
    left in place while the server lives (the server unlinks it on exit is
    not required — a dead socket plus stale lock is cleaned up here)."""
    import subprocess
    import sys

    path = path or sock_path()
    if os.path.exists(path):
        return
    lock = path + ".spawn"
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.close(fd)
    except FileExistsError:
        # someone spawned recently; clear a stale lock (no socket appeared
        # within 10 minutes) so the next run can retry
        try:
            import time as _t

            if _t.time() - os.path.getmtime(lock) > 600:
                os.unlink(lock)
        except OSError:
            pass
        return
    log = os.path.join(
        os.path.dirname(path) or tempfile.gettempdir(), "mia-serve.log"
    )
    with open(log, "ab") as lf:
        subprocess.Popen(
            [sys.executable, "-m", "mia.cli.serve", "--sock", path,
             "--idle-timeout", str(idle_timeout)],
            stdout=lf, stderr=lf, start_new_session=True,
        )
