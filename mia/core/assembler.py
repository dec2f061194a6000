"""End-to-end iterative assembly pipeline (mia main, src/mia_main.c:394-989).

Pass 1 aligns every read fw+rc against the (wrapped) reference, then the
engine iterates: consensus -> realign -> filter -> cull -> write maln, until
the consensus string repeats or MAX_ITER is hit.
"""
from __future__ import annotations

import functools
import os as _os
import sys
import time

import numpy as np

from ..config import MiaConfig
from ..constants import INIT_ALN_SEQ_LEN, MAX_ITER, PSSM_DEPTH
from ..io.fasta import read_fasta_ref
from ..io.native import iter_frag_seqs_fast as iter_frag_seqs
from ..io.ids import parse_ids
from ..io.maln import write_ma
from ..io.pssm_io import find_read_pssm
from ..ops.pssm import init_flatsubmat, revcom_submat
from .columns import consensus_assembly_string, sort_aln_frags
from .driver import (
    init_alignment,
    reiterate_assembly,
    set_hp_cols,
    set_hp_rows,
    set_seq1,
    set_seq2,
    sg_align,
    trim_frag,
)
from ..ops.kmer import KmerPosArray, new_kmer_filter
from .fsdb import (
    FSDB,
    clean_FSDB,
    collapse_FSDB,
    cull_maln_from_fsdb,
    pop_smp_from_FSDB,
    set_uniq_in_fsdb,
    sort_fsdb,
    sort_fsdb_qscore,
    write_fastq,
)
from .merge import add_ref_wrap
from .types import MapAlignment
from ..utils import profiling


def _log(msg: str) -> None:
    print(msg, file=sys.stderr)


def run_assembly(cfg: MiaConfig) -> MapAlignment:
    """Run the full mia pipeline; returns the final culled MapAlignment.

    Multi-host (SPMD over read shards): when launched under
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID, every host
    runs this same function over its contiguous slice of the input stream;
    repeat filtering and the dynamic score cutoff replay globally
    (parallel.distributed.GlobalReadFilter), per-iteration consensus counts
    and the shared max-insert array all-reduce, convergence is a global
    vote, and host 0 writes the complete maln — byte-identical to a
    single-process run (tests/test_distributed.py)."""
    from ..parallel import distributed as dist

    multi = dist.initialize_if_needed()
    # -C / -q need sequence content globally (duplicate groups span hosts;
    # the fastq export is one global file): full stubs mirror id/seq/qual
    gf = (
        dist.GlobalReadFilter(full=cfg.collapse or cfg.make_fastq)
        if multi
        else None
    )
    reduce_cc = dist.reduce_column_counts if multi else None
    if cfg.submat_fn:
        ancsubmat = find_read_pssm(cfg.submat_fn)
    else:
        ancsubmat = init_flatsubmat()
    rcancsubmat = revcom_submat(ancsubmat)
    flatsubmat = init_flatsubmat()

    maln = MapAlignment()
    maln.cons_code = cfg.cons_code
    maln.distant_ref = cfg.distant_ref

    fsdb = FSDB()

    maln.ref = read_fasta_ref(cfg.ref_fn)
    if cfg.circular:
        add_ref_wrap(maln.ref)
    else:
        maln.ref.wrap_seq_len = maln.ref.seq_len
    maln.ref.gaps = np.zeros(maln.ref.wrap_seq_len + 1, dtype=np.int64)

    fkpa = rkpa = None
    if cfg.kmer_filt_len > 0:
        _log("Making kmer list for k-mer filtering...")
        fkpa = KmerPosArray(
            maln.ref.seq[: maln.ref.wrap_seq_len], cfg.kmer_filt_len, cfg.soft_mask
        )
        rkpa = KmerPosArray(
            maln.ref.rcseq[: maln.ref.wrap_seq_len], cfg.kmer_filt_len, cfg.soft_mask
        )

    # raw (possibly soft-masked) strands for the native batch engine's own
    # k-mer index build; captured before the uppercase below
    raw_fw_strand = maln.ref.seq
    raw_rc_strand = maln.ref.rcseq

    # k-mer tables built; uppercase the reference from here on
    maln.ref.seq = (
        maln.ref.seq[: maln.ref.wrap_seq_len].upper()
        + maln.ref.seq[maln.ref.wrap_seq_len :]
    )
    maln.ref.rcseq = (
        maln.ref.rcseq[: maln.ref.wrap_seq_len].upper()
        + maln.ref.rcseq[maln.ref.wrap_seq_len :]
    )

    size2 = maln.ref.wrap_seq_len + 2 * INIT_ALN_SEQ_LEN
    fw_align = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=False, hp_special=cfg.hp_special)
    rc_align = init_alignment(INIT_ALN_SEQ_LEN, size2, rc=True, hp_special=cfg.hp_special)

    adapt_align = None
    if cfg.do_adapter_trimming:
        adapt_align = init_alignment(
            INIT_ALN_SEQ_LEN, INIT_ALN_SEQ_LEN, rc=False, hp_special=cfg.hp_special
        )
        adapt_align.submat = flatsubmat
        set_seq2(adapt_align, cfg.adapter)
        if cfg.hp_special:
            set_hp_rows(adapt_align)
        adapt_align.sg5 = True
        adapt_align.sg3 = False

    ref_len1 = maln.ref.wrap_seq_len if cfg.circular else maln.ref.seq_len
    set_seq1(fw_align, maln.ref.seq, ref_len1)
    set_seq1(rc_align, maln.ref.rcseq, ref_len1)
    if cfg.hp_special:
        set_hp_cols(fw_align)
        set_hp_cols(rc_align)

    good_ids = parse_ids(cfg.ids_file) if cfg.ids_file else None

    _log("Starting to align sequences to the reference...")
    seen = 0
    fw_align.submat = ancsubmat
    rc_align.submat = ancsubmat

    # engine selection for pass 1:
    #   "native" (default) — fully-native batched solver (k-mer filter +
    #       banded fw/rc DP + traceback in one threaded FFI call per batch)
    #   "jax"    — score batches on the device, traceback on host; -h scores
    #       with the homopolymer device program (dp_jax.batch_last_row_hp)
    #   "numpy"  — exact per-read host path
    use_jax = cfg.engine == "jax"
    use_native = cfg.engine == "native"
    scorer = None
    bhost = None
    pending: list = []
    if use_jax or use_native:
        from .hostbatch import BatchHost
        from .jax_engine import MAX_INTERVALS, WIN_W

        # native batched engine; the raw (pre-uppercase) strands drive the
        # k-mer index exactly like populate_kpa runs before make_ref_upper
        # (src/mia_main.c:659-676)
        bhost = BatchHost.create(
            raw_fw_strand,
            raw_rc_strand,
            ref_len1,
            ancsubmat,
            None,
            cfg.kmer_filt_len if cfg.kmer_filt_len > 0 else -1,
            cfg.soft_mask,
            WIN_W,
            MAX_INTERVALS,
            hp=cfg.hp_special,
        )
        if bhost is None:
            # no native lib (and the auto-build failed): the exact per-read
            # numpy path serves both engines
            use_native = False
            use_jax = False
    mesh = None
    if use_jax:
        from ..serve import refuse_if_served
        from .jax_engine import Pass1Scorer, make_dp_mesh

        if cfg.dp_devices not in (0, 1):
            refuse_if_served()  # the mesh opens the devices in-process
        mesh = make_dp_mesh(cfg.dp_devices)
        if mesh is not None:
            profiling.count(
                "pass1.mesh_devices", len({d.id for d in mesh.devices.flat})
            )
        # -h: the hp device program needs the raw strand strings for the
        # reference homopolymer-run arrays (src/mia.c:883-905); it has no
        # mesh variant, so dp-sharded -h runs stay on the native engine
        hp_seqs = None
        if cfg.hp_special:
            if mesh is not None:
                mesh = None
            hp_seqs = (
                fw_align.seq1[: fw_align.len1],
                rc_align.seq1[: rc_align.len1],
            )
        scorer = None
        if mesh is None:
            # resident scoring server (mia.serve): skips this process's
            # backend init + executable load entirely when one is running
            from ..serve import connect_scorer

            scorer = connect_scorer(
                fw_align.s1c, rc_align.s1c, fw_align.len1, ancsubmat,
                hp_seqs=hp_seqs,
            )
            if scorer is not None:
                profiling.count("pass1.using_server")
            elif (
                _os.environ.get("MIA_SERVER", "auto") != "0"
                and _os.environ.get("MIA_STEAL", "1") != "0"
            ):
                # no server yet: connect_scorer spawned one for subsequent
                # runs; THIS run stays on the native engine — importing the
                # device runtime in-process would fight the host cores for
                # the GIL during the very work it should speed up
                profiling.count("pass1.server_spawned_native_run")
                use_jax = False
                use_native = True
        if use_jax and scorer is None:
            # defer=True: the ~10 s backend init + executable load overlaps
            # the read streaming below instead of blocking before it
            refuse_if_served()
            scorer = Pass1Scorer(
                fw_align.s1c, rc_align.s1c, fw_align.len1, ancsubmat, mesh=mesh,
                defer=True, hp_seqs=hp_seqs,
            )

    # asynchronous device pipeline: batches dispatch without blocking and
    # drain in read order as their results land (or when the inflight cap is
    # hit), so the device computes while the host streams/packs/merges
    inflight: list = []
    NATIVE_BATCH = 4096
    MAX_INFLIGHT = 16
    # work-stealing switch state for the device path (MIA_STEAL=0
    # forces every batch to wait for the device — tests use it so the
    # device path is actually exercised on fast-compile backends).  Only a
    # program that is not ready yet is stolen from: device_ready() raises
    # once the device program has failed
    steal = _os.environ.get("MIA_STEAL", "1") != "0"
    device_on = False
    # one worker overlaps each batch's native finish with the previous
    # batch's python merge (pass-1 device path)
    import concurrent.futures as _cf

    finish_pool = _cf.ThreadPoolExecutor(max_workers=1)
    finishing: list = []
    # a second worker overlaps pack/k-mer-prepare/dispatch with the read
    # streaming (the FFI calls release the GIL, so this is real overlap on
    # the 2-core host); inflight holds futures in stream order
    prep_pool = _cf.ThreadPoolExecutor(max_workers=1)

    def _host_align_one(f) -> None:
        """Per-read host fallback (mask too fragmented for the device)."""
        frag_len = f.trim_point + 1 if f.trimmed else f.seq_len
        new_kmer_filter(
            f.seq,
            frag_len,
            fkpa,
            rkpa,
            cfg.kmer_filt_len,
            fw_align.align_mask,
            rc_align.align_mask,
            fw_align.len1,
            rc_align.len1,
        )
        sg_align(maln, f, fsdb, fw_align, rc_align)

    def _solve_native_subset(records_sub: list) -> list[tuple]:
        """Threaded native full solve of a read subset (wide bands); returns
        per-read (meta_row, ref_str_bytes, frag_str_bytes)."""
        from .hostbatch import STATUS_HOST_FALLBACK

        reads = [
            (f.seq[: f.trim_point + 1] if f.trimmed else f.seq[: f.seq_len])
            for f in records_sub
        ]
        arena, off, lens = bhost.pack_reads(reads)
        cap = bhost.TRACE_CAP
        meta, ra, fa = bhost.solve_pass1(arena, off[:-1], lens, maln.distant_ref)
        out = []
        retry = [
            j for j in range(len(records_sub)) if meta[j, 0] == STATUS_HOST_FALLBACK
        ]
        wide: dict[int, tuple] = {}
        if retry:
            # second pass with a full-width traceback arena, still batched
            a2, o2, l2 = bhost.pack_reads([reads[j] for j in retry])
            wcap = bhost.wide_cap
            m2, r2, f2 = bhost.solve_pass1(
                a2, o2[:-1], l2, maln.distant_ref, cap=wcap
            )
            for t, j in enumerate(retry):
                wide[j] = (
                    m2[t],
                    r2[t * wcap : (t + 1) * wcap],
                    f2[t * wcap : (t + 1) * wcap],
                )
        for j in range(len(records_sub)):
            if j in wide:
                out.append(wide[j])
            else:
                out.append(
                    (meta[j], ra[j * cap : (j + 1) * cap], fa[j * cap : (j + 1) * cap])
                )
        return out

    def _merge_native_solved(f, m, ra, fa) -> None:
        """Merge one natively-solved read (meta from mia_p1_solve)."""
        from .driver import finish_alignment
        from .hostbatch import (
            STATUS_GATED,
            STATUS_HOST_FALLBACK,
            STATUS_NO_KMER,
        )

        st = int(m[0])
        if st == STATUS_NO_KMER:
            return
        if st == STATUS_GATED:
            f.score = int(m[2])
            return
        if st == STATUS_HOST_FALLBACK:
            _host_align_one(f)
            return
        n = int(m[5])
        pw = (ra[:n].decode("latin-1"), fa[:n].decode("latin-1"))
        finish_alignment(
            maln, f, fsdb, bool(m[1]), int(m[2]), int(m[3]), int(m[4]), pw
        )

    def _start_drain():
        """Collect the oldest batch, pick winners, and SUBMIT the native
        finish (window DP + traceback) to the worker thread; the python
        merge of the previous batch overlaps it (the FFI call releases the
        GIL).  Returns a token for :func:`_merge_drained`."""
        from ..constants import FIRST_ROUND_SCORE_CUTOFF
        from .hostbatch import FLAG_HOST_ONLY, FLAG_SKIP, FLAG_WIDE

        profiling.count("pass1.batches_drained")
        records, handle, prep = inflight.pop(0).result()
        arena, off, lens, fw_ivg, rc_ivg, flags = prep
        with profiling.phase("pass1.collect_wait"):
            fb, fa, rb, ra = scorer.collect_arrays(handle)
        # reads whose band exceeds the device window: threaded native solve
        # (there is deliberately no second full-width device program)
        wide_idx = [
            i
            for i in range(len(records))
            if (flags[i] & FLAG_WIDE) and not (flags[i] & (FLAG_SKIP | FLAG_HOST_ONLY))
        ]
        # select windowed winners (strand, gate) -> one native finish call;
        # vectorised: the per-read python loop was ~unprofiled seconds at
        # 100k (it runs on the critical streaming thread)
        flags_a = np.asarray(flags)
        eligible = (flags_a & (FLAG_SKIP | FLAG_HOST_ONLY | FLAG_WIDE)) == 0
        fb_a = np.asarray(fb)
        rb_a = np.asarray(rb)
        rcwin_a = ~(fb_a > rb_a)
        best_a = np.where(rcwin_a, rb_a, fb_a)
        gated = eligible & (best_a < FIRST_ROUND_SCORE_CUTOFF)
        if maln.distant_ref:
            gated &= False
        for i in np.flatnonzero(gated):
            # gate rejects: no traceback needed (src/map_align.c:1614)
            records[i].score = int(best_a[i])
            flags[i] |= FLAG_SKIP
        widx_sel = np.flatnonzero(eligible & ~gated)
        win = widx_sel.tolist()
        strand_l = rcwin_a[widx_sel].astype(bool).tolist()
        # strand by RECORD index (the merge no longer walks winners in
        # ordinal lockstep once gap-free records split off)
        strand = dict(zip(win, strand_l))
        bests = best_a[widx_sel].astype(np.int64)
        aecs = np.where(rcwin_a[widx_sel], np.asarray(ra)[widx_sel],
                        np.asarray(fa)[widx_sel]).astype(np.int64)
        profiling.count("pass1.device_scored_reads", len(win))
        profiling.count("pass1.native_solved_wide_reads", len(wide_idx))

        def work():
            wide_res = (
                dict(
                    zip(wide_idx, _solve_native_subset([records[i] for i in wide_idx]))
                )
                if wide_idx
                else {}
            )
            if not win:
                return wide_res, {}, {}, None, None, None, bhost.TRACE_CAP
            widx = np.asarray(win)
            strand_a = np.asarray(strand_l, np.uint8)
            ivg = np.where(
                strand_a[:, None, None] == 1, rc_ivg[widx], fw_ivg[widx]
            )
            bests_a = np.asarray(bests, np.int64)
            aecs_a = np.asarray(aecs, np.int64)
            # provably gap-free winners skip the native window refill
            # entirely (jax_engine.diag_gapfree; the dominant aDNA case)
            from .jax_engine import diag_gapfree

            t0 = time.time()
            gf_ok, gf_abc = diag_gapfree(
                arena, off[widx], lens[widx], bests_a, aecs_a, ivg,
                fw_align.s1c[: fw_align.len1], rc_align.s1c[: rc_align.len1],
                strand_a, ancsubmat,
            )
            diag = {}
            for w in np.flatnonzero(gf_ok):
                i = win[w]
                diag[i] = (int(bests_a[w]), int(gf_abc[w]), int(aecs_a[w]),
                           bool(strand_a[w]))
            fin = np.flatnonzero(~gf_ok)
            profiling.count("pass1.gapfree_shortcut", len(diag))
            if len(fin) == 0:
                profiling.add_time("pass1.native_finish", time.time() - t0)
                return wide_res, diag, {}, None, None, None, bhost.TRACE_CAP
            fsel = widx[fin]
            # tight output cap: a finish traceback spans at most the margin
            # window + the read length; overflow falls back per read
            fcap = min(
                bhost.TRACE_CAP, 2 * int(lens[fsel].max(initial=1)) + 768
            )
            meta, ref_arena, frag_arena = bhost.finish(
                arena,
                off[fsel],
                lens[fsel],
                strand_a[fin],
                np.zeros(len(fin), np.uint8),
                np.asarray(bests_a[fin], np.int32),
                np.asarray(aecs_a[fin], np.int32),
                ivg[fin],
                cap=fcap,
            )
            profiling.add_time("pass1.native_finish", time.time() - t0)
            fmap = {int(win[w]): j for j, w in enumerate(fin)}
            return wide_res, diag, fmap, meta, ref_arena, frag_arena, fcap

        return records, flags, strand, finish_pool.submit(work)

    def _merge_drained(token) -> None:
        from .driver import finish_alignment
        from .hostbatch import FLAG_HOST_ONLY, FLAG_SKIP, FLAG_WIDE

        records, flags, strand, fut = token
        wide_res, diag, fmap, meta, ref_arena, frag_arena, cap = fut.result()
        t_merge = time.time()
        for i, f in enumerate(records):
            fl = flags[i]
            if fl & FLAG_SKIP:
                continue
            if fl & FLAG_HOST_ONLY:
                _host_align_one(f)
                continue
            if fl & FLAG_WIDE:
                _merge_native_solved(f, *wide_res[i])
                continue
            if i in diag:
                # provably gap-free: the traceback IS the diagonal
                best, abc, aec, rc = diag[i]
                sref = rc_align.seq1 if rc else fw_align.seq1
                length = f.trim_point + 1 if f.trimmed else f.seq_len
                pw = (sref[abc : aec + 1], f.seq[:length])
                finish_alignment(maln, f, fsdb, rc, best, abc, aec, pw)
                continue
            j = fmap[i]
            n = int(meta[j, 3])
            if n < 0:  # native finish worker failed: per-read host path
                _host_align_one(f)
                continue
            pw = (
                ref_arena[j * cap : j * cap + n].decode("latin-1"),
                frag_arena[j * cap : j * cap + n].decode("latin-1"),
            )
            finish_alignment(
                maln,
                f,
                fsdb,
                strand[i],
                int(meta[j, 0]),
                int(meta[j, 1]),
                int(meta[j, 2]),
                pw,
            )
        profiling.add_time("pass1.py_merge", time.time() - t_merge)

    def _flush_native() -> None:
        """Fully-native batched pass 1: one threaded FFI call does k-mer
        filter + banded fw/rc DP + strand pick + gate + traceback for the
        whole batch; Python only merges the results (in read order)."""
        from .driver import finish_alignment
        from .hostbatch import (
            STATUS_GATED,
            STATUS_HOST_FALLBACK,
            STATUS_NO_KMER,
        )

        records = pending[:]
        pending.clear()
        if not records:
            return
        reads = [
            (f.seq[: f.trim_point + 1] if f.trimmed else f.seq[: f.seq_len])
            for f in records
        ]
        arena, off, lens = bhost.pack_reads(reads)
        meta, ref_arena, frag_arena = bhost.solve_pass1(
            arena, off[:-1], lens, maln.distant_ref
        )
        cap = bhost.TRACE_CAP
        # wide second pass: reads whose winning window outgrows the default
        # traceback arena (saturated k-mer bands) re-solve with a full-width
        # arena — still batched, still native
        wide: dict[int, tuple] = {}
        fb_idx = [i for i in range(len(records)) if meta[i, 0] == STATUS_HOST_FALLBACK]
        if fb_idx:
            sub = [reads[i] for i in fb_idx]
            a2, o2, l2 = bhost.pack_reads(sub)
            wcap = bhost.wide_cap
            m2, r2, f2 = bhost.solve_pass1(
                a2, o2[:-1], l2, maln.distant_ref, cap=wcap
            )
            for j, i in enumerate(fb_idx):
                wide[i] = (m2[j], r2[j * wcap : (j + 1) * wcap], f2[j * wcap : (j + 1) * wcap])
        for i, f in enumerate(records):
            m = meta[i]
            ra = ref_arena[i * cap : (i + 1) * cap]
            fa = frag_arena[i * cap : (i + 1) * cap]
            if m[0] == STATUS_HOST_FALLBACK and i in wide:
                m, ra, fa = wide[i]
            st = int(m[0])
            if st == STATUS_NO_KMER:
                continue
            if st == STATUS_GATED:
                f.score = int(m[2])
                continue
            if st == STATUS_HOST_FALLBACK:
                _host_align_one(f)
                continue
            n = int(m[5])
            pw = (ra[:n].decode("latin-1"), fa[:n].decode("latin-1"))
            finish_alignment(
                maln, f, fsdb, bool(m[1]), int(m[2]), int(m[3]), int(m[4]), pw
            )

    def _prepare_dispatch(records: list):
        """Worker-thread half of a batch submit: pack + k-mer prepare +
        device dispatch (all FFI/socket work off the streaming thread)."""
        from .jax_engine import L_MAX, MAX_INTERVALS

        reads = [
            (f.seq[: f.trim_point + 1] if f.trimmed else f.seq[: f.seq_len])
            for f in records
        ]
        with profiling.phase("pass1.pack_prepare"):
            arena, off, lens = bhost.pack_reads(reads)
            s2c, fw_ws, rc_ws, fw_ivg, rc_ivg, flags = bhost.prepare(
                arena, off, lens, L_MAX, MAX_INTERVALS
            )
        if getattr(scorer, "hp", False):
            from .hostbatch import FLAG_HOST_ONLY
            from .jax_engine import hp_routes_to_host, pack_chars

            # hp device program keeps an HPW-deep ring of previous score
            # rows: reads containing a homopolymer run of >= HPW bases
            # (vanishingly rare) stay on the exact host path
            for i, r in enumerate(reads):
                if hp_routes_to_host(r):
                    flags[i] |= FLAG_HOST_ONLY
            s2c = pack_chars(arena, off[:-1], lens)
        with profiling.phase("pass1.dispatch"):
            handle = scorer.dispatch_packed(
                s2c, lens, fw_ws, rc_ws, fw_ivg, rc_ivg, flags
            )
        return records, handle, (arena, off[:-1], lens, fw_ivg, rc_ivg, flags)

    def _inflight_ready(fut) -> bool:
        return fut.done() and type(scorer).ready(fut.result()[1])

    def flush_pending(final: bool = False) -> None:
        if pending:
            records = pending[:]
            pending.clear()
            inflight.append(prep_pool.submit(_prepare_dispatch, records))
        # drain in read order: everything whose result already landed, plus
        # enough to respect the inflight cap (bounds host-side batch buffers)
        while inflight and (
            final
            or len(inflight) > MAX_INFLIGHT
            or _inflight_ready(inflight[0])
        ):
            finishing.append(_start_drain())
            while len(finishing) > 1:
                _merge_drained(finishing.pop(0))
        if final:
            while finishing:
                _merge_drained(finishing.pop(0))

    t_pass1 = time.time()
    if multi:
        # contiguous per-host slice of the stream; gids keep the global
        # stream order observable for the global filter replay.  The count
        # pass is native (no python objects) and each host materialises
        # ONLY its slice (per-host memory scales 1/n_hosts).
        from ..io.native import count_frag_seqs, iter_frag_seqs_range

        shard = dist.host_read_shard(count_frag_seqs(cfg.frag_fn))
        stream = iter_frag_seqs_range(cfg.frag_fn, shard.start, shard.count)
        gid0 = shard.start
    else:
        stream = iter_frag_seqs(cfg.frag_fn)
        gid0 = 0
    for frag_seq in stream:
        frag_seq.gid = gid0 + seen
        seen += 1
        if good_ids is None or frag_seq.id in good_ids:
            if cfg.do_adapter_trimming:
                trim_frag(frag_seq, cfg.adapter, adapt_align)
            else:
                frag_seq.trimmed = False
            if use_native:
                pending.append(frag_seq)
                if len(pending) >= NATIVE_BATCH:
                    _flush_native()
            elif use_jax:
                # batched device path: the native engine applies the k-mer
                # filter, the device scores, the native engine tracebacks.
                # Until the device program is compiled/loaded, full batches
                # are WORK-STOLEN by the threaded native solver so a cold
                # compile never stalls the pipeline; the switch to the
                # device is one-way, preserving stream merge order.
                pending.append(frag_seq)
                if len(pending) >= scorer.batch:
                    if device_on or not steal or scorer.device_ready():
                        device_on = True
                        flush_pending()
                    else:
                        profiling.count("pass1.batches_stolen_native")
                        _flush_native()
            else:
                frag_len = (
                    frag_seq.trim_point + 1 if frag_seq.trimmed else frag_seq.seq_len
                )
                if new_kmer_filter(
                    frag_seq.seq,
                    frag_len,
                    fkpa,
                    rkpa,
                    cfg.kmer_filt_len,
                    fw_align.align_mask,
                    rc_align.align_mask,
                    fw_align.len1,
                    rc_align.len1,
                ):
                    sg_align(maln, frag_seq, fsdb, fw_align, rc_align)
        if seen % 1000 == 0:
            sys.stderr.write(".")
        if seen % 80000 == 0:
            sys.stderr.write("\n")
    if use_native:
        _flush_native()
    elif use_jax:
        if pending and steal and not device_on and not scorer.device_ready():
            profiling.count("pass1.batches_stolen_native")
            _flush_native()
        flush_pending(final=True)
        finish_pool.shutdown(wait=True)
        prep_pool.shutdown(wait=True)
        # a device program that failed while every batch was stolen must
        # still stop the run
        scorer.raise_if_failed()
        if mesh is not None:
            profiling.count("pass1.result_devices", scorer.result_devices)
    if bhost is not None:
        bhost.close()
    profiling.count("pass1.reads_seen", seen)
    profiling.add_time("pass1", time.time() - t_pass1)

    with profiling.phase("filters.pop_smp"):
        pop_smp_from_FSDB(fsdb, PSSM_DEPTH)
    sys.stderr.write("\n")
    iter_num = 1

    # culled maln: shares the ref, sized to the current alignment count
    # (init_culled_map_alignment, src/mia.c:41-58)
    culled = MapAlignment()
    culled.ref = maln.ref
    culled.cons_code = maln.cons_code
    culled.distant_ref = maln.distant_ref
    if multi:
        culled.size = int(
            dist.allreduce_terms(np.array([maln.num_aln_seqs], np.int64))[0]
        )
    else:
        culled.size = maln.num_aln_seqs


    def _filter_and_cull() -> None:
        """Repeat filters + score cull — globally replayed when multi-host
        (the stub FSDB reproduces the single-process sort/uniq/fit history,
        including float summation order)."""
        _log("Repeat and score filtering")
        if multi:
            gf.refresh(fsdb)
            gf.assign_slots()  # global maln slot layout BEFORE the sorts
        if cfg.repeat_filt:
            sort_fsdb(fsdb)
            if multi:
                gf.sort_and_uniq(False, cfg.just_outer_coords, cfg.tolerance, fsdb)
            else:
                set_uniq_in_fsdb(fsdb, cfg.just_outer_coords, cfg.tolerance)
        if cfg.repeat_qual_filt:
            sort_fsdb_qscore(fsdb)
            if multi:
                gf.sort_and_uniq(True, cfg.just_outer_coords, cfg.tolerance, fsdb)
            else:
                set_uniq_in_fsdb(fsdb, cfg.just_outer_coords, cfg.tolerance)
        with profiling.phase("filters.cull"):
            if multi and cfg.hard_cut <= 0 and not cfg.score_cut_set:
                slope, intercept = gf.score_cut()
                cull_maln_from_fsdb(culled, fsdb, cfg.hard_cut, True, slope, intercept)
            else:
                cull_maln_from_fsdb(
                    culled, fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                    cfg.intercept,
                )
        if multi:
            dist.allreduce_max(maln.ref.gaps)
        culled.fpsm = ancsubmat
        culled.rpsm = rcancsubmat
        sort_aln_frags(culled)
        if multi:
            # global slot-dropped replay: the reference's DR bit is sticky
            # per REUSED maln slot; override the local (host-sharded) stale
            # flags with the single-process bits so consensus and the
            # writer see exactly what one process would
            drops = gf.cull_drops(
                cfg.hard_cut, cfg.score_cut_set, cfg.slope, cfg.intercept,
                culled.distant_ref, maln.ref,
            )
            sp = gf.sort_pos()
            for fs in fsdb.fss:
                if not fs.unique_best:
                    continue
                p = sp[fs.gid]
                if (p, 0) in drops:
                    fs.front_asp.dropped = drops[(p, 0)]
                if fs.back_asp is not None and (p, 1) in drops:
                    fs.back_asp.dropped = drops[(p, 1)]
            # records freshly merged under this layout enter the global
            # slot->content map (collective; see write_ma_global)
            gf.snapshot_fresh(fsdb)

    def _write_maln(fn: str) -> None:
        with profiling.phase("io.write_maln"):
            if multi:
                dist.write_ma_global(fn, culled, gf, fsdb, culled.size)
            else:
                write_ma(fn, culled)

    _filter_and_cull()

    fw_align.submat = ancsubmat
    fw_align.sg5 = True
    fw_align.sg3 = True

    last_assembly_cons = maln.ref.seq[: maln.ref.seq_len]

    fw_align.align_mask[: fw_align.len1] = 1
    clean_FSDB(fsdb)
    if multi:
        gf.clean()
    if cfg.collapse:
        if multi:
            gf.collapse(fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                        cfg.intercept)
        else:
            collapse_FSDB(fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                          cfg.intercept)

    with profiling.phase("reiterate"):
        reiterate_assembly(
            last_assembly_cons, iter_num, maln, fsdb, fw_align, ancsubmat,
            rcancsubmat, engine=cfg.engine, mesh=mesh,
        )
    pop_smp_from_FSDB(fsdb, PSSM_DEPTH)
    _filter_and_cull()
    maln_fn = f"{cfg.maln_root}.{iter_num}"
    if not cfg.iterate or not cfg.final_only:
        _write_maln(maln_fn)
        if cfg.make_fastq:
            if multi:
                gf.write_fastq_host0(cfg.fastq_out_fn)
            else:
                write_fastq(cfg.fastq_out_fn, fsdb)

    # device consensus accumulation (SURVEY §2 native->device item 4): under
    # a mesh the in-process psum path; under the device engine the resident
    # server or the in-process program; integer scatter-adds make each
    # bit-equal to the host accumulator.  A hook returns None to route one
    # pass to the host (program not compiled yet, or a stream beyond the
    # device buckets), counted per reason; a device failure raises.
    cons_hook = None
    if cfg.engine == "jax" and scorer is not None:
        from ..ops import consensus_device as _cd
        from ..serve import ServerScorer, connect_consensus

        ndev = 1 if mesh is None else int(mesh.devices.size)
        if mesh is not None:
            _device = functools.partial(_cd.device_column_counts, mesh=mesh)
        elif isinstance(scorer, ServerScorer):
            _device = connect_consensus()
        else:
            # in-process device runtime (MIA_SERVER=0).  A cold program
            # stays on the host path unless MIA_STEAL=0 forces the device
            def _device(seq, smp, starts, spans, seq_off, smp_off, revs,
                        fpsm, rpsm, n):
                if steal and not _cd.is_warm(int(spans.sum()), len(spans), int(n)):
                    return None
                return _cd.device_column_counts(
                    seq, smp, starts, spans, seq_off, smp_off, revs,
                    fpsm, rpsm, n,
                )

        def _cons_hook(seq, smp, starts, spans, *a):
            if not _cd.fits(int(spans.sum()), ndev):
                profiling.count("consensus.host_too_large")
                return None
            res = _device(seq, smp, starts, spans, *a)
            if res is None:
                profiling.count("consensus.host_cold")
            return res

        if _device is not None:
            cons_hook = _cons_hook

    if cfg.iterate:
        _log("Generating new assembly consensus")
        with profiling.phase("consensus"):
            assembly_cons = consensus_assembly_string(
                culled, reduce_cc=reduce_cc, device_hook=cons_hook
            )

        def _unconverged() -> bool:
            eq = assembly_cons == last_assembly_cons
            if multi:
                return not dist.converged_everywhere(eq)
            return not eq

        while _unconverged() and iter_num < MAX_ITER:
            iter_num += 1
            last_assembly_cons = assembly_cons
            _log(f"Starting assembly iteration {iter_num}")

            if cfg.collapse:
                if multi:
                    gf.collapse(
                        fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                        cfg.intercept,
                    )
                else:
                    collapse_FSDB(
                        fsdb, cfg.hard_cut, cfg.score_cut_set, cfg.slope,
                        cfg.intercept,
                    )
            with profiling.phase("reiterate"):
                reiterate_assembly(
                    assembly_cons, iter_num, maln, fsdb, fw_align, ancsubmat,
                    rcancsubmat, engine=cfg.engine, mesh=mesh,
                )
            with profiling.phase("filters.pop_smp"):
                pop_smp_from_FSDB(fsdb, PSSM_DEPTH)
            _filter_and_cull()
            maln_fn = f"{cfg.maln_root}.{iter_num}"
            if not cfg.final_only:
                _log(f"Writing maln file for iteration {iter_num}")
                _write_maln(maln_fn)
            with profiling.phase("consensus"):
                assembly_cons = consensus_assembly_string(
                    culled, reduce_cc=reduce_cc, device_hook=cons_hook
                )

        if assembly_cons == last_assembly_cons:
            _log("Assembly convergence - writing final maln")
        else:
            _log(f"Assembly did not converge after {iter_num} rounds, quitting")
        maln_fn = f"{cfg.maln_root}.{iter_num}"
        if cfg.final_only:
            _write_maln(maln_fn)
        if cfg.make_fastq:
            if multi:
                gf.write_fastq_host0(cfg.fastq_out_fn)
            else:
                write_fastq(cfg.fastq_out_fn, fsdb)

    return culled
