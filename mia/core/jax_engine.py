"""Device-accelerated scoring engine (pass 1 + iteration realignment).

Phase split: the host streams/filters reads (trim + k-mer bands via the
native batch engine), the device scores whole batches with the batched DP
program, and the host then reconstructs the winning strand's traceback over a
score-verified window — so merge bookkeeping stays identical to the exact
engine while the O(W*L) scoring work runs on the accelerator.

Everything the device sees is an **entry**: a (reference-strand select,
window start, band intervals, read codes, PSSM select) tuple.  Pass 1 ships
each read as two entries (fw + rc strand); iteration realignment ships each
strand-known read as one entry against the new consensus with its strand's
PSSM.  One jitted module-level program — ``_score_entries`` — serves every
caller, so the whole assembly (all iterations included) compiles exactly ONE
device program per process.

Transfer discipline:

* FIXED shapes only — entries padded to E_BATCH, rows to L_MAX, windows to
  WIN_W, intervals to MAX_INTERVALS, and the reference to a REF_BUCKET
  multiple (so per-iteration consensus length drift never changes the traced
  shapes and never recompiles).
* The compile starts on a BACKGROUND thread at construction, overlapping the
  host's read streaming/packing phase.
* Per-batch inputs ship small: reads as nibble-packed codes and band masks
  as per-read interval lists; the [E, L, 5] per-row PSSM score table is
  computed ON DEVICE from (s2c, lengths, smidx) rather than shipped.
* Dispatch is fully asynchronous; only per-entry (best, aec) int32 scalars
  come back, one fused fetch per drained batch.
* Reads whose band exceeds WIN_W (saturated k-mers / no-filter runs) are NOT
  given a second full-width device program; they route to the threaded
  native solver, keeping the device program count at one.

Failure policy: work-stealing to the native engine covers only "the program
is not compiled yet".  A construction, compile or runtime failure of the
device program raises at the next readiness check or dispatch, with the
device error in the message.

Window verification: the host recomputes the winning strand's DP restricted
to [aec - margin, aec] (margin from the score bound: a gated alignment of
score >= s spans at most len2 + (len2*max_sub - s)/GEP extra columns) and
checks that (best, aec) and the alignment start reproduce exactly; any
disagreement falls back to the full-width exact computation
(native/src/hostbatch.cc: mia_p1_finish).
"""
from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np

from ..constants import GEP, INIT_ALN_SEQ_LEN, PSSM_DEPTH
from ..ops.dp_numpy import Alignment
from ..utils.encoding import encode_seq

# route-to-host threshold for the hp device program's ring depth (must
# match ops.dp_jax.HPW without importing jax at module load)
HPW_ROUTE = 32


def hp_routes_to_host(seq: str) -> bool:
    """True when the read's longest homopolymer run is >= HPW_ROUTE: the hp
    device ring cannot reach its run-start row, so the read stays on the
    exact host path (shared by pass 1 and the realigner)."""
    if len(seq) < HPW_ROUTE:
        return False
    b = np.frombuffer(seq.encode("latin-1"), np.uint8)
    brk = np.flatnonzero(np.diff(b) != 0)
    runs = np.diff(np.concatenate(([-1], brk, [len(b) - 1])))
    return int(runs.max()) >= HPW_ROUTE


SCORE_BATCH = 8192           # reads per pass-1 batch (2 entries each)


def default_batch() -> int:
    """Reads per batch; MIA_SCORE_BATCH overrides (smaller batches keep the
    CPU-backend tests and the virtual-mesh dry run fast — every dispatch
    pads to the full batch)."""
    import os

    return int(os.environ.get("MIA_SCORE_BATCH", SCORE_BATCH))

MAX_INTERVALS = 16
# per-read reference window for the banded scorer; strands whose band spans
# more than WIN_W columns are solved by the native engine instead
WIN_W = 384
L_MAX = INIT_ALN_SEQ_LEN     # 256: the reference's hard read-length cap
REF_BUCKET = 2048            # reference width pads to a multiple of this

# jitted programs that have completed at least one dispatch+collect in this
# process: their executable is compiled/loaded and further dispatches will
# not stall.  Work-stealing (assembler) and the reiterate device group use
# this to decide whether the device can be used without blocking.
_RUN_PROGRAMS: set = set()

# live deferred-init/warmup threads; a CLI must not let the interpreter tear
# down while one is inside an XLA compile (the daemon thread dies mid-C++ and
# the process aborts with "terminate called ..."), so mia.py checks
# background_work_pending() and uses os._exit to skip teardown when needed
_INIT_THREADS: list = []


def background_work_pending() -> bool:
    return any(t.is_alive() for t in _INIT_THREADS)


def any_program_warm() -> bool:
    """True once any entry-scoring program completed a dispatch+collect in
    this process — reiterate uses this to decide whether building a device
    scorer can possibly pay off without stalling (and without spawning
    another init thread)."""
    return bool(_RUN_PROGRAMS)


@dataclass
class StrandScore:
    best: int
    aec: int


def build_pass1_entries(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags):
    """(ref_sel, starts, ivl, s2c2, ln2, smidx) entry arrays for one pass-1
    read batch (each read = fw + rc entries); shared by the local scorer and
    the server client.  flags: FLAG_SKIP/HOST_ONLY/WIDE reads get empty
    intervals (their scores are garbage the caller ignores)."""
    from .hostbatch import FLAG_HOST_ONLY, FLAG_SKIP, FLAG_WIDE

    n = len(lens)
    inactive = (flags & (FLAG_SKIP | FLAG_HOST_ONLY | FLAG_WIDE)) != 0

    def local_iv(ivg, ws):
        used = (ivg[:, :, 1] > 0) & ~inactive[:n, None]
        return np.where(used[:, :, None], ivg - ws[:n, None, None], 0).astype(
            np.int32
        )

    ref_sel = np.repeat(np.array([0, 1], np.int8), n)
    starts = np.concatenate([fw_ws, rc_ws]).astype(np.int32)
    ivl = np.concatenate([local_iv(fw_ivg, fw_ws), local_iv(rc_ivg, rc_ws)])
    s2c2 = np.concatenate([s2c, s2c]).astype(np.int8)
    ln2 = np.concatenate([lens, lens]).astype(np.int32)
    smidx = np.zeros(2 * n, np.int8)
    return ref_sel, starts, ivl, s2c2, ln2, smidx


def split_pass1_results(best, aec, fw_ws, rc_ws):
    """(fb, fa, rb, ra) with aec in GLOBAL reference coordinates."""
    n = len(best) // 2
    fb = best[:n]
    fa = aec[:n] + fw_ws[:n]
    rb = best[n:]
    ra = aec[n:] + rc_ws[:n]
    return fb, fa, rb, ra


def mask_intervals(mask: np.ndarray) -> np.ndarray | None:
    """[K,2] (lo, hi-exclusive) intervals of the open columns, or None when
    the mask needs more than MAX_INTERVALS (caller falls back to host)."""
    m = mask.astype(bool)
    d = np.diff(m.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1) + 1)
    if m[0]:
        starts.insert(0, 0)
    if m[-1]:
        ends.append(len(m))
    if len(starts) > MAX_INTERVALS:
        return None
    out = np.zeros((MAX_INTERVALS, 2), np.int32)
    for k, (s, e) in enumerate(zip(starts, ends)):
        out[k] = (s, e)
    return out


def make_dp_mesh(n_dp: int):
    """("dp",) mesh over the first ``n_dp`` local devices (-1 = all local
    devices); None when a single device would result (0 and 1 without
    touching the backend).  The device count is rounded down to a divisor of
    E_BATCH so the entry axis shards evenly."""
    if n_dp in (0, 1):
        return None
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    n = len(devs) if n_dp < 0 else min(n_dp, len(devs))
    while n > 1 and (2 * default_batch()) % n:
        n -= 1
    if n <= 1:
        return None
    return Mesh(np.array(devs[:n]), ("dp",))


def pack_s2c(arena: bytes, off: np.ndarray, lens: np.ndarray, L: int = L_MAX) -> np.ndarray:
    """[n, L] int8 read codes from a packed read arena (one vectorised
    gather; pad code 4)."""
    from ..utils.encoding import BASE2INX

    buf = np.frombuffer(arena, np.uint8)
    cols = np.arange(L, dtype=np.int64)[None, :]
    idx = np.minimum(off[:, None] + cols, max(len(buf) - 1, 0))
    valid = cols < lens[:, None]
    return np.where(valid, BASE2INX[buf[idx]], 4).astype(np.int8)


def diag_gapfree(
    arena: bytes,
    off: np.ndarray,      # [n] read arena offsets (winners)
    lens: np.ndarray,     # [n] read lengths
    bests: np.ndarray,    # [n] device best scores
    aecs: np.ndarray,     # [n] GLOBAL end columns
    ivg: np.ndarray,      # [n, K, 2] GLOBAL band intervals (0,0 = unused)
    ref_fw: np.ndarray,   # [len1] forward-strand reference codes
    ref_rc: np.ndarray,   # [len1] rc-strand codes (pass ref_fw again if n/a)
    sel: np.ndarray,      # [n] strand select (1 = rc row)
    submat: np.ndarray,   # [31,5,5], or [2,31,5,5] selected per entry by
                          # ``sm_sel`` (the realign path's fw/rc PSSM choice)
    sm_sel: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Provably gap-free winners: (mask [n] bool, abc [n] int32).

    If the pure-diagonal substitution sum ending at ``aec`` equals the
    device best and the whole diagonal lies inside one open band interval,
    the reference's traceback IS that gap-free diagonal: S along the
    diagonal can never exceed the prefix sums (or the end value would
    exceed the total, contradiction via the diag candidate
    S[r+1][c+1] >= S[r][c]+sub), so every cell's value equals its diagonal
    prefix, every competing candidate is <= the diagonal predecessor, and
    the reference's tie-breaking prefers diag over gaps/hp while restart
    needs STRICT > (src/mia.c:907-965).  Such winners skip the native
    window refill entirely — the dominant case for short aDNA reads, where
    indels are rare."""
    n = len(off)
    if n == 0:
        return np.zeros(0, bool), np.zeros(0, np.int32)
    L = int(lens.max())
    abcs = (aecs - lens + 1).astype(np.int64)
    # one interval must cover the whole diagonal's columns
    used = ivg[:, :, 1] > 0
    cover = (
        used
        & (ivg[:, :, 0] <= abcs[:, None])
        & (aecs[:, None] < ivg[:, :, 1])
    ).any(axis=1) & (abcs >= 0)

    buf = np.frombuffer(arena, np.uint8)
    rows = np.arange(L, dtype=np.int64)[None, :]
    valid = rows < lens[:, None]
    ridx = np.minimum(off[:, None] + rows, max(len(buf) - 1, 0))
    from ..utils.encoding import BASE2INX

    s2 = np.where(valid, BASE2INX[buf[ridx]], 4).astype(np.int64)
    cidx = np.clip(abcs[:, None] + rows, 0, len(ref_fw) - 1)
    s1 = np.where(
        np.asarray(sel)[:, None] == 1,
        np.asarray(ref_rc, np.int64)[cidx],
        np.asarray(ref_fw, np.int64)[cidx],
    )
    # find_sm_depth per (read, row) — pure numpy (no jax import here: this
    # runs in server-mode client processes)
    from_back = lens[:, None] - (rows + 1)
    d = np.where(
        rows < PSSM_DEPTH,
        rows,
        np.where(from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back, PSSM_DEPTH),
    )
    d = np.clip(d, 0, 2 * PSSM_DEPTH)
    sm = np.asarray(submat)
    if sm.ndim == 4:
        subs = np.where(valid, sm[np.asarray(sm_sel)[:, None], d, s1, s2], 0)
    else:
        subs = np.where(valid, sm[d, s1, s2], 0)
    diag_sum = subs.sum(axis=1)
    ok = cover & (diag_sum == bests)
    return ok, abcs.astype(np.int32)


def pack_chars(arena: bytes, off: np.ndarray, lens: np.ndarray, L: int = L_MAX) -> np.ndarray:
    """[n, L] uint8 raw read chars from a packed read arena (pad 0) — the
    hp device program's input form."""
    buf = np.frombuffer(arena, np.uint8)
    cols = np.arange(L, dtype=np.int64)[None, :]
    idx = np.minimum(off[:, None] + cols, max(len(buf) - 1, 0))
    valid = cols < lens[:, None]
    return np.where(valid, buf[idx], 0).astype(np.uint8)


def device_depths(lengths, L: int):
    """PSSM depth slot per (entry, row), on device (find_sm_depth,
    src/pssm.c:36-46; identical to ops.dp_jax.depths_for)."""
    import jax.numpy as jnp
    from jax import lax

    # lax.iota (not jnp.arange): trace-time concrete constants get hoisted
    # as executable parameters and break cross-program dispatch on meshes
    rows = lax.iota(jnp.int32, L)[None, :]
    ln = lengths[:, None]
    from_back = ln - (rows + 1)
    d = jnp.where(
        rows < PSSM_DEPTH,
        rows,
        jnp.where(from_back < PSSM_DEPTH, 2 * PSSM_DEPTH - from_back, PSSM_DEPTH),
    )
    return jnp.clip(d, 0, 2 * PSSM_DEPTH)


def _entries_core(refs, ref_sel, starts, ivl, s2c, lengths, smidx, sms,
                  n_rows=None):
    """Trace-time body shared by the plain and shard_map'd programs.

    The scorer's row loop stops at the longest entry of the batch (of the
    shard, under a mesh); a static ``n_rows`` (L_MAX: every row) replaces
    that bound, which is how ``chip_smoke.py`` times the full scan."""
    import jax.numpy as jnp
    from jax import lax

    from ..ops.dp_jax import batch_last_row_rowsm

    WTOT = refs.shape[1]
    # one fused gather: [E, WIN_W] window codes from the selected strand
    # (lax.iota, not jnp.arange — see device_depths)
    flat = refs.reshape(-1)
    idx = (
        ref_sel.astype(jnp.int32)[:, None] * WTOT
        + starts.astype(jnp.int32)[:, None]
        + lax.iota(jnp.int32, WIN_W)[None, :]
    )
    wins = flat[idx].astype(jnp.int32)
    cols = lax.iota(jnp.int32, WIN_W)[None, None, :]
    ivl32 = ivl.astype(jnp.int32)
    maskw = (
        (cols >= ivl32[:, :, 0][:, :, None]) & (cols < ivl32[:, :, 1][:, :, None])
    ).any(axis=1)
    # read codes arrive nibble-packed (two 0..4 codes per byte), halving the
    # dominant [E, L] host-to-device payload
    lo4 = (s2c & 0xF).astype(jnp.int32)
    hi4 = ((s2c >> 4) & 0xF).astype(jnp.int32)
    E = s2c.shape[0]
    s2c32 = jnp.stack([lo4, hi4], axis=-1).reshape(E, 2 * s2c.shape[1])
    depths = device_depths(lengths, s2c32.shape[1])
    # row_sm[e, r, i] = sms[smidx[e], depth(e,r), i, s2c[e,r]] — computed on
    # device so only the int8 codes ship
    sm_t = jnp.transpose(sms, (0, 1, 3, 2))  # [2, 31, read_base, ref_base]
    row_sm = sm_t[smidx.astype(jnp.int32)[:, None], depths, s2c32]  # [E, L, 5]
    last = batch_last_row_rowsm(
        wins, maskw, row_sm, lengths, sg5=True,
        n_rows=jnp.max(lengths) if n_rows is None else n_rows,
    )
    aec = jnp.argmax(last, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(last, aec[:, None], axis=1)[:, 0]
    return jnp.stack([best, aec])  # [2, E]


def _entries_core_hp(refs, refchr, hpcs_g, b2i, pengop, ref_sel, starts, ivl,
                     s2chr, lengths, smidx, sms):
    """Homopolymer (-h) variant of :func:`_entries_core`: reads ship as raw
    chars (the hp conditions need char equality, src/mia.c:885), codes and
    read-run arrays derive on device, and the scorer is
    :func:`mia.ops.dp_jax.batch_last_row_hp` (reference hp recurrence
    src/mia.c:883-905 with the truncated discount table precomputed on
    host, src/map_align.c:1096-1135)."""
    import jax.numpy as jnp
    from jax import lax

    from ..ops.dp_jax import batch_last_row_hp

    WTOT = refs.shape[1]
    idx = (
        ref_sel.astype(jnp.int32)[:, None] * WTOT
        + starts.astype(jnp.int32)[:, None]
        + lax.iota(jnp.int32, WIN_W)[None, :]
    )
    wins = refs.reshape(-1)[idx].astype(jnp.int32)
    winchr = refchr.reshape(-1)[idx].astype(jnp.int32)
    winhpcs = hpcs_g.reshape(-1)[idx].astype(jnp.int32)
    cols = lax.iota(jnp.int32, WIN_W)[None, None, :]
    ivl32 = ivl.astype(jnp.int32)
    maskw = (
        (cols >= ivl32[:, :, 0][:, :, None]) & (cols < ivl32[:, :, 1][:, :, None])
    ).any(axis=1)
    s2chr32 = s2chr.astype(jnp.int32)
    s2c32 = b2i[jnp.clip(s2chr32, 0, 255)].astype(jnp.int32)
    depths = device_depths(lengths, s2c32.shape[1])
    sm_t = jnp.transpose(sms, (0, 1, 3, 2))
    row_sm = sm_t[smidx.astype(jnp.int32)[:, None], depths, s2c32]
    last = batch_last_row_hp(
        wins, winchr, maskw, row_sm, lengths, s2chr32, winhpcs,
        starts.astype(jnp.int32), pengop, sg5=True,
    )
    aec = jnp.argmax(last, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(last, aec[:, None], axis=1)[:, 0]
    return jnp.stack([best, aec])


@functools.lru_cache(maxsize=None)
def _plain_fn_hp():
    import jax

    @jax.jit
    def fn(refs, refchr, hpcs_g, b2i, pengop, ref_sel, starts, ivl, s2chr,
           lengths, smidx, sms):
        return _entries_core_hp(
            refs, refchr, hpcs_g, b2i, pengop, ref_sel, starts, ivl, s2chr,
            lengths, smidx, sms,
        )

    return fn


def hp_pengop_table() -> np.ndarray:
    """int(GOP * frac) per homopolymer length slot (exact C double->int
    truncation: int(a+b) == a + int(b) for integer a, positive b — so the
    gap-length term adds back in integer arithmetic on device)."""
    from ..constants import GOP
    from ..ops.dp_numpy import _HP_FRac

    return np.array([int(GOP * f) for f in list(_HP_FRac) + [0.10]], np.int32)


@functools.lru_cache(maxsize=None)
def _plain_fn():
    import jax

    return jax.jit(_entries_core)


@functools.lru_cache(maxsize=None)
def _mesh_fn(mesh):
    """Data-parallel program: entries shard over the mesh's ``dp`` axis, the
    reference strands and PSSMs replicate — the production realisation of
    SURVEY §2's read-data-parallelism row."""
    import jax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    in_specs = (
        P(None, None),        # refs [2, WTOT] replicated
        P("dp"),              # ref_sel [E]
        P("dp"),              # starts [E]
        P("dp", None, None),  # ivl [E, K, 2]
        P("dp", None),        # s2c [E, L]
        P("dp"),              # lengths [E]
        P("dp"),              # smidx [E]
        P(None, None, None, None),  # sms [2, 31, 5, 5] replicated
    )
    sharded = jax.shard_map(
        _entries_core,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(None, "dp"),
        check_vma=False,
    )
    # explicit in/out shardings: without them, running any single-device
    # jit program first leaves jit's C++ fastpath resolving this program's
    # np.ndarray args against trimmed PartitionSpecs (AssertionError (1,3))
    # or executing with a mismatched buffer layout ("supplied 8 buffers but
    # compiled program expected 9")
    return jax.jit(
        sharded,
        in_shardings=tuple(NamedSharding(mesh, s) for s in in_specs),
        out_shardings=NamedSharding(mesh, P(None, "dp")),
    )


class Pass1Scorer:
    """Batches entries against up to two reference strands on the device.

    The jitted program has process-constant shapes; construction launches
    its compilation on a daemon thread so it overlaps host streaming.  With
    ``mesh`` (axis name ``dp``) the entry axis shards across devices."""

    def __init__(
        self,
        fw_s1c,
        rc_s1c,
        len1: int,
        submat,
        submat_b=None,
        batch: int | None = None,
        mesh=None,
        warm: bool = True,
        defer: bool = False,
        hp_seqs: tuple[str, str] | None = None,
    ):
        self.len1 = len1
        self.batch = batch or default_batch()
        self.E = 2 * self.batch
        # -h homopolymer mode: entries ship raw chars and score with the hp
        # device program; reference hp-run starts are precomputed per strand
        self.hp = hp_seqs is not None
        if self.hp:
            if mesh is not None:
                raise ValueError("hp device program does not shard (yet)")
            from ..utils.encoding import pop_hpl_and_hps

            WPAD = -(-len1 // REF_BUCKET) * REF_BUCKET
            WTOT = WPAD + WIN_W
            refchr = np.zeros((2, WTOT), np.uint8)
            hpcs = np.zeros((2, WTOT), np.int32)
            for i, s in enumerate(hp_seqs):
                s = s[:len1]
                refchr[i, : len(s)] = np.frombuffer(
                    s.encode("latin-1"), np.uint8
                )
                _, hps = pop_hpl_and_hps(s)
                hpcs[i, : len(s)] = hps
            self._refchr_np = refchr
            self._hpcs_np = hpcs
            self._pengop_np = hp_pengop_table()
        # reference pads to a REF_BUCKET multiple + WIN_W of tail padding so
        # per-read window gathers never run off the end (gathered junk
        # columns are masked) and consensus-length drift between iterations
        # never changes the compiled shape
        WPAD = -(-len1 // REF_BUCKET) * REF_BUCKET
        self.WTOT = WPAD + WIN_W
        refs = np.full((2, self.WTOT), 4, np.int8)
        refs[0, :len1] = np.asarray(fw_s1c[:len1], dtype=np.int8)
        refs[1, :len1] = np.asarray(rc_s1c[:len1], dtype=np.int8)
        self._refs_np = refs
        self._sms_np = np.stack(
            [
                np.asarray(submat, dtype=np.int32),
                np.asarray(submat_b if submat_b is not None else submat, np.int32),
            ]
        )
        self._mesh = mesh
        self._warm = warm
        self._warmed = False
        self.warmup_s = 0.0  # wall time of the warmup compile + first run
        self._dev_ready = threading.Event()
        self._init_error: BaseException | None = None
        self._init_thread = None
        self.result_devices = 0
        if defer:
            # pass-1 path: backend init and the program's compile run on a
            # daemon thread while the host streams and packs reads; the
            # first dispatch joins it
            self._init_thread = threading.Thread(
                target=self._init_device_guarded, daemon=True
            )
            _INIT_THREADS.append(self._init_thread)
            self._init_thread.start()
        else:
            self._init_device_guarded()
            self.raise_if_failed()

    def _init_device_guarded(self) -> None:
        try:
            self._init_device()
        except BaseException as e:  # surfaced by _wait_ready at dispatch
            self._init_error = e
            self._dev_ready.set()
            return
        # ready BEFORE the warmup dispatch: _warmup goes through
        # dispatch_entries -> _wait_ready and must not deadlock; an early
        # real dispatch simply shares the jit-internal compile lock
        self._dev_ready.set()
        if self._warm:
            self._warmup()

    def _init_device(self) -> None:
        import jax.numpy as jnp

        from ..utils.jaxcfg import setup_jax_cache

        setup_jax_cache()
        mesh = self._mesh
        self._refs = jnp.asarray(self._refs_np)
        self._sms = jnp.asarray(self._sms_np)
        self._arg_shardings = None
        if mesh is not None and mesh.size > 1:
            import jax
            from jax.sharding import NamedSharding
            from jax.sharding import PartitionSpec as P

            self._fn = _mesh_fn(mesh)
            # jit's C++ fastpath mis-shards raw numpy args once warmed by a
            # previously-run single-device program (it applies the
            # executable's trailing-None-trimmed PartitionSpec to the raw
            # array: AssertionError (1, 3) on the rank-3 ivl); pre-placing
            # every per-entry arg with an explicit full-rank NamedSharding
            # sidesteps that path entirely
            def sh(*spec):
                return NamedSharding(mesh, P(*spec))

            self._arg_shardings = (
                sh("dp"),              # ref_sel [E]
                sh("dp"),              # starts [E]
                sh("dp", None, None),  # ivl [E, K, 2]
                sh("dp", None),        # s2c [E, L]
                sh("dp"),              # lengths [E]
                sh("dp"),              # smidx [E]
            )
            self._refs = jax.device_put(self._refs, sh(None, None))
            self._sms = jax.device_put(self._sms, sh(None, None, None, None))
        elif self.hp:
            from ..utils.encoding import BASE2INX

            self._refchr = jnp.asarray(self._refchr_np)
            self._hpcs = jnp.asarray(self._hpcs_np)
            self._b2i = jnp.asarray(BASE2INX.astype(np.int32))
            self._pengop = jnp.asarray(self._pengop_np)
            self._fn = _plain_fn_hp()
        else:
            self._fn = _plain_fn()

    def _wait_ready(self) -> None:
        """Block until the device program is constructed; re-raise any
        device failure at the caller (the dispatch site)."""
        self._dev_ready.wait()
        self.raise_if_failed()

    def failed(self) -> bool:
        """True once construction, compile or a warmup run of the device
        program failed (non-blocking)."""
        return self._init_error is not None

    def raise_if_failed(self) -> None:
        err = self._init_error
        if err is not None:
            raise RuntimeError(
                f"device scoring program failed: {type(err).__name__}: {err}"
            ) from err

    def device_ready(self) -> bool:
        """True once the device can score a batch without stalling the
        caller on backend init or executable compile/load (non-blocking).
        The assembler work-steals: batches go to the native engine until
        this flips, so a cold compile never blocks the pipeline.  A failed
        device program raises here instead of reading as "not ready"."""
        self.raise_if_failed()
        if not self._dev_ready.is_set():
            return False
        return self._fn in _RUN_PROGRAMS

    def _warmup(self) -> None:
        """Compile the program on dummy inputs and FETCH the result (daemon
        thread).  Real dispatches of the same shapes share the compile via
        jit's internal cache.  A failure is recorded: :meth:`failed` turns
        true and the next readiness check or dispatch raises it."""
        import time

        t0 = time.time()
        try:
            h = self.dispatch_entries(
                np.zeros(1, np.int8),
                np.zeros(1, np.int32),
                np.zeros((1, MAX_INTERVALS, 2), np.int32),
                np.zeros((1, L_MAX), np.uint8)
                if self.hp
                else np.full((1, L_MAX), 4, np.int8),
                np.ones(1, np.int32),
                np.zeros(1, np.int8),
            )
            self.collect_entries(h)
            self._warmed = True
        except Exception as e:
            self._init_error = e
        self.warmup_s = time.time() - t0

    # ------------------------------------------------------------- dispatch
    def dispatch_entries(self, ref_sel, starts, ivl, s2c, lengths, smidx):
        """Enqueue up to E_BATCH entries; fully asynchronous.

        ivl holds WINDOW-LOCAL [lo, hi) intervals (global band minus the
        entry's window start); entries with all-zero intervals score HIM.
        Returns an opaque handle for :meth:`collect_entries`."""
        self._wait_ready()
        n = len(ref_sel)
        if n == 0:
            return (None, 0)
        E = self.E
        assert n <= E

        def pad(a, dtype, fill=0):
            out = np.full((E,) + np.shape(a)[1:], fill, dtype)
            out[:n] = a
            return out

        s2c_p = np.full((E, L_MAX), 0 if self.hp else 4, np.uint8)
        s2c_p[:n, : s2c.shape[1]] = s2c
        lens_p = pad(np.maximum(np.asarray(lengths, np.int32), 1), np.int32, 1)
        ref_sel_p = pad(ref_sel, np.int8)
        starts_p = pad(starts, np.int32)
        ivl_p = pad(ivl, np.int16)
        smidx_p = pad(smidx, np.int8)
        if self.hp:
            # hp mode ships raw chars (char equality + run computation
            # happen on device); no nibble pack
            out = self._fn(
                self._refs, self._refchr, self._hpcs, self._b2i, self._pengop,
                ref_sel_p, starts_p, ivl_p, s2c_p, lens_p, smidx_p, self._sms,
            )
            return (out, n)
        # nibble-pack the read codes (codes 0..4, two per byte)
        s2c4 = np.ascontiguousarray(s2c_p[:, 0::2] | (s2c_p[:, 1::2] << 4))
        args = (ref_sel_p, starts_p, ivl_p, s2c4, lens_p, smidx_p)
        if self._arg_shardings is not None:
            import jax

            args = tuple(
                jax.device_put(a, s) for a, s in zip(args, self._arg_shardings)
            )
        out = self._fn(self._refs, *args, self._sms)
        return (out, n)

    @staticmethod
    def ready(handle) -> bool:
        """True when the batch's device results have landed (non-blocking)."""
        out = handle[0]
        return out is None or bool(out.is_ready())

    def collect_entries(self, handle):
        """Materialise a dispatched batch: (best, aec) int64 arrays [n];
        aec is WINDOW-LOCAL (add the entry's window start)."""
        import jax

        out, n = handle[:2]
        if out is None:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        arr = jax.device_get(out)
        _RUN_PROGRAMS.add(self._fn)
        # distinct devices that hold a shard of the result (the dp mesh
        # places one per device)
        self.result_devices = len({sh.device for sh in out.addressable_shards})
        return arr[0, :n].astype(np.int64), arr[1, :n].astype(np.int64)

    # ------------------------------------------------- pass-1 (two strands)
    def dispatch_packed(self, s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags):
        """Enqueue one pass-1 read batch already packed by the native host
        engine (core/hostbatch.py: BatchHost.prepare): each read becomes two
        entries (fw then rc).  Results via :meth:`collect_arrays`.

        flags: per-read FLAG_SKIP / FLAG_HOST_ONLY / FLAG_WIDE bits; flagged
        reads get empty intervals (garbage scores the caller must ignore —
        WIDE reads are solved by the native engine instead)."""
        n = len(lens)
        if n == 0:
            return (None, 0, None, None)
        assert n <= self.batch
        entries = build_pass1_entries(s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags)
        handle = self.dispatch_entries(*entries)
        return handle + (fw_ws.copy(), rc_ws.copy())

    def collect_arrays(self, handle):
        """Materialise a packed pass-1 batch: (fb, fa, rb, ra) int64 [n]
        with aec in GLOBAL reference coordinates."""
        out, n2, fw_ws, rc_ws = handle
        best, aec = self.collect_entries((out, n2))
        return split_pass1_results(best, aec, fw_ws, rc_ws)


def windowed_exact_dp(a: Alignment, device_best: int, device_aec: int) -> None:
    """Run the exact host DP for ``a`` restricted to a score-bounded window
    ending at the device-reported end column; falls back to the full width
    when the window result disagrees.  On return a.pw holds the winning
    traceback strings (solve_sg)."""
    from ..ops.dp_numpy import solve_sg

    len2 = a.len2
    max_sub = int(np.max(a.submat))
    slack = (
        max(0, (len2 * max_sub - device_best) // GEP)
        if device_best < len2 * max_sub
        else 0
    )
    margin = len2 + slack + 16

    full_mask = a.align_mask[: a.len1].copy()
    lo = max(device_aec - margin, 0)
    if lo > 0 or device_aec < a.len1 - 1:
        a.align_mask[: a.len1] = 0
        a.align_mask[lo : device_aec + 1] = full_mask[lo : device_aec + 1]
        solve_sg(a)
        a.align_mask[: a.len1] = full_mask
        if a.best_score == device_best and a.aec == device_aec:
            if lo == 0 or a.abc > lo + 2:
                return
        # fall back: recompute over the full (kmer-banded) width
    solve_sg(a)
