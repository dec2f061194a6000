"""Per-read alignment driver and the iterative realignment engine.

Ports sg_align (src/map_align.c:1500-1665), trim_frag
(src/map_align.c:1304-1368) and reiterate_assembly (src/mia_main.c:24-280).
The DP itself runs through :mod:`mia.ops.dp_numpy` (exact) or the batched
JAX path; this module owns the strand choice, coordinate fixups, circular
splits and maln/FSDB bookkeeping.
"""
from __future__ import annotations

import numpy as np

from ..constants import (
    FIRST_ROUND_SCORE_CUTOFF,
    FLAT_MATCH,
    GEP,
    GOP,
    INIT_ALN_SEQ_LEN,
    REALIGN_BUFFER,
    TRIM_SCORE_CUT,
)
from ..ops.dp_numpy import (
    Alignment,
    dyn_prog,
    find_align_begin,
    max_sg_score,
    populate_pwaln_to_begin,
    solve_sg,
    trim_argmax_last_col,
)
from ..utils.encoding import encode_seq, pop_hpl_and_hps, revcom
from .fsdb import add_virgin_fs2fsdb
from .merge import add_ref_wrap, c2rcc, merge_pwaln_into_maln, revcom_PWAF, split_pwaln
from .types import FSDB, FragSeq, MapAlignment, PWAlnFrag


def init_alignment(size1: int, size2: int, rc: bool, hp_special: bool) -> Alignment:
    """Workspace sized like the reference's init_alignment
    (src/mia.c:988-1030): size1 rows (fragment) x size2 cols (reference)."""
    a = Alignment()
    a.hp = hp_special
    a.rc = rc
    a.align_mask = np.ones(size2, dtype=np.uint8)
    a.s1c = np.zeros(size2, dtype=np.int8)
    a.s2c = np.zeros(size1, dtype=np.int8)
    return a


def set_seq1(a: Alignment, seq: str, length: int | None = None) -> None:
    a.seq1 = seq
    a.len1 = len(seq) if length is None else length
    enc = encode_seq(seq[: a.len1])
    if len(enc) > len(a.s1c):
        a.s1c = np.zeros(len(enc) + 16, dtype=np.int8)
    a.s1c[: a.len1] = enc


def set_seq2(a: Alignment, seq: str, length: int | None = None) -> None:
    a.seq2 = seq
    a.len2 = len(seq) if length is None else length
    enc = encode_seq(seq[: a.len2])
    if len(enc) > len(a.s2c):
        a.s2c = np.zeros(len(enc) + 16, dtype=np.int8)
    a.s2c[: a.len2] = enc


def set_hp_cols(a: Alignment) -> None:
    a.hpcl, a.hpcs = pop_hpl_and_hps(a.seq1[: a.len1])


def set_hp_rows(a: Alignment) -> None:
    a.hprl, a.hprs = pop_hpl_and_hps(a.seq2[: a.len2])


def trim_frag(frag_seq: FragSeq, adapter: str, align: Alignment) -> None:
    """Adapter trimming via DP of adapter (rows) vs read (columns); sets
    trimmed/trim_point (src/map_align.c:1304-1368)."""
    set_seq1(align, frag_seq.seq)
    if align.hp:
        set_hp_cols(align)
    dyn_prog(align)
    max_score = trim_argmax_last_col(align)
    find_align_begin(align)
    if max_score >= TRIM_SCORE_CUT or max_score >= (
        (align.aer - align.abr + 1) * FLAT_MATCH
    ):
        frag_seq.trimmed = True
        frag_seq.trim_point = align.abc - 1
    else:
        frag_seq.trimmed = False


def sg_align(
    maln: MapAlignment,
    fs: FragSeq,
    fsdb: FSDB,
    fw_a: Alignment,
    rc_a: Alignment,
    precomputed=None,
) -> bool:
    """Align one read fw+rc, keep the better strand, merge into the maln and
    insert into the FSDB (src/map_align.c:1500-1665).

    With ``precomputed`` = (fw StrandScore, rc StrandScore) from the device
    scorer, only the winning strand's DP is recomputed on host (in a
    score-verified window) for traceback; otherwise both strands run here."""
    rs = maln.ref
    length = fs.trim_point + 1 if fs.trimmed else fs.seq_len
    if length <= 0:
        # adapter trimming consumed the whole read: the reference runs a
        # len2=0 DP here and emits uninitialised-memory garbage
        # (src/mia.c:1514-1543 with trim_point == -1); we define such reads
        # as unalignable and skip them
        return True
    set_seq2(fw_a, fs.seq, length)
    set_seq2(rc_a, fs.seq, length)
    if fw_a.hp:
        set_hp_rows(fw_a)
        set_hp_rows(rc_a)
    fw_a.sg5 = fw_a.sg3 = True
    rc_a.sg5 = rc_a.sg3 = True

    if precomputed is not None:
        from .jax_engine import windowed_exact_dp

        fw_ss, rc_ss = precomputed
        dev = fw_ss if fw_ss.best > rc_ss.best else rc_ss
        if dev.best < FIRST_ROUND_SCORE_CUTOFF and not maln.distant_ref:
            # gate will reject this read: no traceback needed, nothing of its
            # state survives (src/map_align.c:1614)
            fs.score = dev.best
            return True
        best_a = fw_a if fw_ss.best > rc_ss.best else rc_a
        windowed_exact_dp(best_a, dev.best, dev.aec)
    else:
        # traceback emit is O(path length) — cheap enough to do for both
        # strands rather than refill the winner
        solve_sg(fw_a)
        solve_sg(rc_a)
        best_a = fw_a if fw_a.best_score > rc_a.best_score else rc_a

    pw = best_a.pw if best_a.pw is not None else populate_pwaln_to_begin(best_a)
    finish_alignment(
        maln, fs, fsdb, best_a.rc, best_a.best_score, best_a.abc, best_a.aec, pw
    )
    return True


def finish_alignment(
    maln: MapAlignment,
    fs: FragSeq,
    fsdb: FSDB,
    rc: bool,
    best_score: int,
    abc: int,
    aec: int,
    pw: tuple[str, str],
) -> None:
    """Merge one aligned read into the maln + FSDB given its winning strand's
    traceback (the bookkeeping half of sg_align, src/map_align.c:1560-1665).
    Shared between the per-read host path and the batched native/device path."""
    rs = maln.ref
    front = PWAlnFrag()
    front.ref_id = rs.id
    front.ref_desc = rs.desc
    front.frag_id = fs.id
    front.frag_desc = fs.desc
    front.ref_seq, front.frag_seq = pw
    front.start = abc
    front.end = aec
    front.trimmed = fs.trimmed
    front.segment = "a"
    front.score = best_score
    fs.score = best_score

    if rc:
        revcom_PWAF(front)
        front.revcom = True
        fs.rc = True
        front.start = c2rcc(aec, rs.seq_len)
        front.end = c2rcc(abc, rs.seq_len)
        fs.as_ = c2rcc(aec, rs.seq_len)
        fs.ae = c2rcc(abc, rs.seq_len)
    else:
        front.revcom = False
        fs.rc = False
        fs.as_ = abc
        fs.ae = aec
    if fs.as_ > fs.ae:
        # wrapped rc alignment: keep ae beyond seq_len for the next round
        # (src/map_align.c:1600-1604)
        fs.ae = rs.seq_len + fs.as_

    if front.end > rs.seq_len:
        front.end = front.end - rs.seq_len

    if fs.score >= FIRST_ROUND_SCORE_CUTOFF or maln.distant_ref:
        if front.start > front.end:
            back = split_pwaln(front, rs.seq_len)
            fs.front_asp = merge_pwaln_into_maln(front, maln)
            fs.back_asp = merge_pwaln_into_maln(back, maln)
            fs.back_fresh = True
        else:
            fs.front_asp = merge_pwaln_into_maln(front, maln)
            fs.back_asp = None
            fs.back_fresh = False
        fs.unique_best = True
        fs.num_inputs = 1
        fs.strand_known = fs.score > FIRST_ROUND_SCORE_CUTOFF
        add_virgin_fs2fsdb(fs, fsdb)


def reiterate_assembly(
    new_ref_seq: str,
    iter_num: int,
    maln: MapAlignment,
    fsdb: FSDB,
    a: Alignment,
    ancsubmat: np.ndarray,
    rcancsubmat: np.ndarray,
    engine: str = "native",
    mesh=None,
) -> None:
    """Re-align every FSDB read against the new consensus
    (src/mia_main.c:24-280).

    Known-strand reads realign in a [as-50, ae+50] window; unknown-strand
    reads under -D re-probe both strands full-length.  Reads normalised to
    reference orientation score with the revcom PSSM so end-damage stays on
    the right molecular end.

    With ``engine == "jax"`` the window DP scoring for every device-sized
    window runs batched on the device (one entry per read against the new
    consensus, the read's strand picking the fw/rc PSSM) and only the
    score-verified margin-window traceback stays on the native threads;
    windows wider than the device window fall back to the native solver."""
    import time as _time0

    _t_setup = _time0.time()
    ref = maln.ref
    ref_len = len(new_ref_seq)
    ref.seq = new_ref_seq
    ref.rcseq = None
    if iter_num > 1:
        ref.id = f"ConsAssem.{iter_num}"
        ref.desc = "iteration assembly"
    ref.seq_len = ref_len
    ref.size = ref_len + 1
    if ref.circular:
        add_ref_wrap(ref)
    else:
        ref.wrap_seq_len = ref.seq_len
    ref.gaps = np.zeros(ref.wrap_seq_len + 1, dtype=np.int64)

    if a.hp:
        a.hpcl, a.hpcs = pop_hpl_and_hps(ref.seq[: ref.wrap_seq_len])

    # clear insert arrays of live slots, then reset the logical count; slot
    # objects persist for reuse (src/mia_main.c:81-106)
    for asp in maln.pool[: maln.num_aln_seqs]:
        asp.ins = {}
    maln.num_aln_seqs = 0

    def _reprobe(fs: FragSeq) -> None:
        """Distant-ref + unknown strand: full-length fw+rc re-probe
        (src/mia_main.c:120-174)."""
        a.submat = ancsubmat
        set_seq1(a, ref.seq[: ref.wrap_seq_len])
        set_seq2(a, fs.seq)
        if a.hp:
            set_hp_rows(a)
            set_hp_cols(a)
        solve_sg(a, do_trace=False)
        max_score = a.best_score
        if max_score > FIRST_ROUND_SCORE_CUTOFF:
            fs.strand_known = True
            fs.rc = False
            fs.as_ = a.abc
            fs.ae = a.aec
            fs.score = max_score

        a.submat = rcancsubmat
        tmp_rc = revcom(fs.seq)
        set_seq2(a, tmp_rc, a.len2)
        if a.hp:
            set_hp_rows(a)
            set_hp_cols(a)
        solve_sg(a, do_trace=False)
        max_score = a.best_score
        if max_score > FIRST_ROUND_SCORE_CUTOFF and max_score > fs.score:
            fs.strand_known = True
            fs.rc = True
            fs.as_ = a.abc
            fs.ae = a.aec
            fs.score = max_score
            fs.seq = tmp_rc

    def _window(fs: FragSeq, len2: int) -> tuple[int, int]:
        """[ref_start, ref_end) realignment window (src/mia_main.c:191-212)."""
        ref_start = max(fs.as_ - REALIGN_BUFFER, 0)
        if (fs.ae + REALIGN_BUFFER + 1) > ref.wrap_seq_len:
            ref_end = ref.wrap_seq_len
        else:
            ref_end = fs.ae + REALIGN_BUFFER
        if (ref_start + len2) > ref_end:
            ref_start = 0
            ref_end = ref.wrap_seq_len
        return ref_start, ref_end

    def _merge_front(
        fs: FragSeq, best: int, abc: int, aec: int, pw: tuple[str, str]
    ) -> None:
        """Merge one realigned read (abc/aec in global reference coords;
        the bookkeeping half of the loop body, src/mia_main.c:236-276)."""
        front = PWAlnFrag()
        front.ref_seq, front.frag_seq = pw
        front.ref_id = ref.id
        front.ref_desc = ref.desc
        front.frag_id = fs.id
        front.frag_desc = fs.desc
        front.trimmed = fs.trimmed
        front.revcom = fs.rc
        front.num_inputs = fs.num_inputs
        front.segment = "a"
        front.score = best
        front.start = abc
        front.end = aec

        fs.as_ = abc
        fs.ae = aec
        fs.unique_best = True
        fs.score = best

        if front.end > ref.seq_len:
            front.end = front.end - ref.seq_len

        if front.start > front.end:
            back = split_pwaln(front, ref.seq_len)
            fs.front_asp = merge_pwaln_into_maln(front, maln)
            fs.back_asp = merge_pwaln_into_maln(back, maln)
            fs.back_fresh = True
        else:
            fs.back_fresh = False
            fs.front_asp = merge_pwaln_into_maln(front, maln)
            # reference quirk: reiterate does NOT clear back_asp here
            # (src/mia_main.c:273-276, unlike sg_align's else branch), so
            # a read split in pass 1 but not in this iteration keeps a
            # stale back_asp aliasing another slot — and cull will emit
            # that slot's record twice.  Preserved for byte parity.

    def _python_realign(fs: FragSeq) -> None:
        """Per-read window realignment on the exact host path."""
        a.submat = rcancsubmat if fs.rc else ancsubmat
        set_seq2(a, fs.seq)
        ref_start, ref_end = _window(fs, a.len2)
        set_seq1(a, ref.seq[ref_start:ref_end])
        if a.hp:
            set_hp_rows(a)
            set_hp_cols(a)
        solve_sg(a)
        pw = a.pw if a.pw is not None else populate_pwaln_to_begin(a)
        _merge_front(fs, a.best_score, a.abc + ref_start, a.aec + ref_start, pw)

    from ..utils import profiling

    # batched native realignment: one threaded FFI call per chunk does the
    # window DP + traceback for every strand-known read; the merge
    # bookkeeping below then runs in FSDB order as before
    native_results: dict[int, tuple] = {}
    reprobed = False
    from .hostbatch import STATUS_OK, BatchHost

    bh = BatchHost.create(
        ref.seq[: ref.wrap_seq_len],
        ref.seq[: ref.wrap_seq_len],
        ref.wrap_seq_len,
        ancsubmat,
        rcancsubmat,
        -1,
        False,
        0,
        0,
        upper=False,
        hp=a.hp,
    )
    if bh is not None:
        # re-probes first: they can set strand_known (and flip fs.seq).
        # Both strands of every unknown read go through the threaded native
        # full-width window solver in chunks (the per-read python probe is
        # quadratic pain at distant-ref scale, src/mia_main.c:120-174)
        if maln.distant_ref and iter_num > 1:
            todo = [fs for fs in fsdb.fss if not fs.strand_known]
            if todo:
                probe_reads: list[str] = []
                for fs in todo:
                    probe_reads.append(fs.seq)
                    probe_reads.append(revcom(fs.seq))
                cap = bh.wide_cap
                chunk_n = max(1, (8192 * bh.TRACE_CAP) // max(cap, 1))
                results: list[tuple[int, int, int, int]] = []
                for c0 in range(0, len(probe_reads), chunk_n):
                    chunk = probe_reads[c0 : c0 + chunk_n]
                    arena, off, lens = bh.pack_reads(chunk)
                    m = len(chunk)
                    smidx = np.fromiter(
                        ((c0 + j) % 2 for j in range(m)), np.uint8, m
                    )
                    wlo = np.zeros(m, np.int32)
                    whi = np.full(m, ref.wrap_seq_len, np.int32)
                    meta, _, _ = bh.solve_rei(
                        arena, off[:-1], lens, smidx, wlo, whi, cap=cap
                    )
                    for j in range(m):
                        results.append(
                            (int(meta[j, 0]), int(meta[j, 1]), int(meta[j, 2]),
                             int(meta[j, 3]))
                        )
                for t, fs in enumerate(todo):
                    st_f, best_f, abc_f, aec_f = results[2 * t]
                    st_r, best_r, abc_r, aec_r = results[2 * t + 1]
                    if st_f != STATUS_OK or st_r != STATUS_OK:
                        _reprobe(fs)  # arena overflow etc.: exact per-read
                        continue
                    if best_f > FIRST_ROUND_SCORE_CUTOFF:
                        fs.strand_known = True
                        fs.rc = False
                        fs.as_ = abc_f
                        fs.ae = aec_f
                        fs.score = best_f
                    if best_r > FIRST_ROUND_SCORE_CUTOFF and best_r > fs.score:
                        fs.strand_known = True
                        fs.rc = True
                        fs.as_ = abc_r
                        fs.ae = aec_r
                        fs.score = best_r
                        fs.seq = revcom(fs.seq)
            reprobed = True
        # window sizes are known up front: group reads by whether their
        # window fits the device scorer, then by whether their traceback
        # fits the default arena; solve each group batched
        narrow: list = []
        wide: list = []
        device: list = []
        scorer = None
        if engine == "jax" and not (a.hp and mesh is not None):
            import os

            from ..utils.encoding import encode_seq
            from .jax_engine import Pass1Scorer, WIN_W, L_MAX

            steal = os.environ.get("MIA_STEAL", "1") != "0"
            # -h: window scoring uses the hp device program against the new
            # consensus (reads realign on the fw strand; smidx picks the
            # PSSM, so both hp slots carry the fw consensus runs)
            hp_seqs = None
            if a.hp:
                s_fw = ref.seq[: ref.wrap_seq_len]
                hp_seqs = (s_fw, s_fw)
            from . import jax_engine as je

            enc = encode_seq(ref.seq[: ref.wrap_seq_len])
            if mesh is None:
                from ..serve import connect_scorer

                scorer = connect_scorer(
                    enc, enc, ref.wrap_seq_len, ancsubmat, rcancsubmat,
                    hp_seqs=hp_seqs,
                )
                if scorer is not None and steal and not scorer.device_ready():
                    # cold server program: realign natively this round
                    profiling.count("reiterate.server_cold")
                    scorer = None
            # local device only when its program is already warm
            # in-process (pass 1 compiled and ran it) — a cold
            # compile would stall the whole iteration, and the
            # native window solver is fast.  Checked BEFORE
            # construction so no extra init thread is ever spawned
            # (MIA_STEAL=0 forces the device path regardless).
            if scorer is None and (not steal or je.any_program_warm()):
                from ..serve import refuse_if_served

                refuse_if_served()
                scorer = Pass1Scorer(
                    enc,
                    enc,
                    ref.wrap_seq_len,
                    ancsubmat,
                    rcancsubmat,
                    mesh=mesh,
                    warm=False,
                    hp_seqs=hp_seqs,
                )
        profiling.add_time(
            "reiterate.setup", __import__("time").time() - _t_setup
        )
        _t_cls = __import__("time").time()
        hp_route = None
        if a.hp and scorer is not None:
            from .jax_engine import hp_routes_to_host

            def hp_route(fs):
                return hp_routes_to_host(fs.seq)

        for fs in fsdb.fss:
            if not fs.strand_known:
                continue
            len2 = len(fs.seq)
            lo, hi = _window(fs, len2)
            job = (fs, lo, hi)
            if (hi - lo) + len2 + 2 > bh.TRACE_CAP:
                wide.append(job)
            elif (
                scorer is not None
                and hi - max(lo - 2, 0) <= WIN_W
                and len2 <= L_MAX
                and not (hp_route is not None and hp_route(fs))
            ):
                device.append(job)
            else:
                narrow.append(job)
        profiling.add_time(
            "reiterate.classify", __import__("time").time() - _t_cls
        )
        # device-sized windows: dispatch ALL chunks asynchronously, then
        # run the native groups (the device scores while the host solves)
        _t_disp = __import__("time").time()
        dev_handles: list = []
        if device:
            from .jax_engine import MAX_INTERVALS, pack_s2c

            E = scorer.E
            for c0 in range(0, len(device), E):
                chunk = device[c0 : c0 + E]
                m = len(chunk)
                arena, off, lens = bh.pack_reads([fs.seq for fs, _, _ in chunk])
                los = np.fromiter((lo for _, lo, _ in chunk), np.int32, m)
                his = np.fromiter((hi for _, _, hi in chunk), np.int32, m)
                ws = np.maximum(los - 2, 0)
                # K must match the pass-1 shape exactly or the program
                # recompiles (shape-keyed jit cache)
                ivl = np.zeros((m, MAX_INTERVALS, 2), np.int32)
                ivl[:, 0, 0] = los - ws
                ivl[:, 0, 1] = his - ws
                smidx = np.fromiter(
                    (1 if fs.rc else 0 for fs, _, _ in chunk), np.int8, m
                )
                if getattr(scorer, "hp", False):
                    from .jax_engine import pack_chars

                    s2c = pack_chars(arena, off[:-1], lens)
                else:
                    s2c = pack_s2c(arena, off[:-1], lens)
                handle = scorer.dispatch_entries(
                    np.zeros(m, np.int8), ws, ivl, s2c, lens, smidx
                )
                dev_handles.append(
                    (chunk, handle, arena, off, lens, ws, los, his, smidx)
                )
        profiling.add_time(
            "reiterate.dispatch", __import__("time").time() - _t_disp
        )
        _t_ns = _time2 = __import__("time").time()
        CHUNK = 8192
        # bound per-chunk output-arena allocation (2 arenas of n*cap
        # bytes): the wide group's cap is the full reference width, so
        # scale its chunk size down to ~TARGET_ARENA bytes per arena
        TARGET_ARENA = CHUNK * bh.TRACE_CAP
        for jobs, cap in ((narrow, bh.TRACE_CAP), (wide, bh.wide_cap)):
            chunk_n = max(1, min(CHUNK, TARGET_ARENA // max(cap, 1)))
            for c0 in range(0, len(jobs), chunk_n):
                chunk = jobs[c0 : c0 + chunk_n]
                arena, off, lens = bh.pack_reads([fs.seq for fs, _, _ in chunk])
                wlo = np.fromiter((lo for _, lo, _ in chunk), np.int32, len(chunk))
                whi = np.fromiter((hi for _, _, hi in chunk), np.int32, len(chunk))
                smidx = np.fromiter(
                    (1 if fs.rc else 0 for fs, _, _ in chunk), np.uint8, len(chunk)
                )
                meta, ref_a, frag_a = bh.solve_rei(
                    arena, off[:-1], lens, smidx, wlo, whi, cap=cap
                )
                for j, (fs, _, _) in enumerate(chunk):
                    if meta[j, 0] != STATUS_OK:
                        continue  # falls back to the per-read path below
                    n = int(meta[j, 4])
                    native_results[id(fs)] = (
                        int(meta[j, 1]),
                        int(meta[j, 2]),
                        int(meta[j, 3]),
                        ref_a[j * cap : j * cap + n],
                        frag_a[j * cap : j * cap + n],
                    )
        profiling.add_time("reiterate.native_solve", __import__("time").time() - _t_ns)
        _t_dev = __import__("time").time()
        # drain the device chunks: verified margin-window traceback on
        # the native threads (mia_p1_finish), results in global coords.
        # The finish FFI call releases the GIL, so it runs on a worker
        # thread while the main thread waits on the NEXT chunk's server
        # collect — the same overlap pass 1 uses.
        sms2 = np.stack(
            [np.asarray(ancsubmat, np.int64), np.asarray(rcancsubmat, np.int64)]
        )
        from ..utils import encoding as _encoding

        ref_str = ref.seq[: ref.wrap_seq_len]
        enc_codes = _encoding.encode_seq(ref_str)

        def _finish_chunk(args):
            chunk, arena, off, lens, ws, los, his, smidx, best, aecl = args
            aec = (aecl + ws).astype(np.int32)
            m = len(chunk)
            ivg = np.zeros((m, 1, 2), np.int32)
            ivg[:, 0, 0] = los
            ivg[:, 0, 1] = his
            # provably gap-free realignments skip the native window refill
            # (jax_engine.diag_gapfree; PSSM selected per read by smidx)
            from .jax_engine import diag_gapfree

            gf_ok, gf_abc = diag_gapfree(
                arena, off[:-1], lens, best.astype(np.int64),
                aec.astype(np.int64), ivg.astype(np.int64),
                enc_codes, enc_codes, np.zeros(m, np.int8), sms2,
                sm_sel=smidx,
            )
            diag = {}
            for j in np.flatnonzero(gf_ok):
                fs = chunk[j][0]
                a0, a1 = int(gf_abc[j]), int(aec[j])
                diag[id(fs)] = (
                    int(best[j]), a0, a1,
                    ref_str[a0 : a1 + 1], fs.seq,
                )
            profiling.count("reiterate.gapfree_shortcut", len(diag))
            fin = np.flatnonzero(~gf_ok)
            if len(fin) == 0:
                return chunk, diag, None, None, None, None, 0
            fcap = min(
                bh.TRACE_CAP,
                int((his - los).max(initial=1)) + int(lens.max(initial=1)) + 64,
            )
            meta, ref_a, frag_a = bh.finish(
                arena,
                off[:-1][fin],
                lens[fin],
                np.zeros(len(fin), np.uint8),
                smidx[fin].astype(np.uint8),
                best[fin].astype(np.int32),
                aec[fin],
                ivg[fin],
                cap=fcap,
            )
            return chunk, diag, fin, meta, ref_a, frag_a, fcap

        from concurrent.futures import ThreadPoolExecutor

        def _store(fut) -> None:
            chunk, diag, fin, meta, ref_a, frag_a, cap = fut.result()
            native_results.update(diag)
            if fin is None:
                return
            for j, w in enumerate(fin):
                fs = chunk[w][0]
                n = int(meta[j, 3])
                if n < 0:
                    continue  # native finish failed: per-read path below
                native_results[id(fs)] = (
                    int(meta[j, 0]),
                    int(meta[j, 1]),
                    int(meta[j, 2]),
                    ref_a[j * cap : j * cap + n],
                    frag_a[j * cap : j * cap + n],
                )

        with ThreadPoolExecutor(1) as fin_pool:
            futs: list = []
            for chunk, handle, arena, off, lens, ws, los, his, smidx in dev_handles:
                _tc = __import__("time").time()
                best, aecl = scorer.collect_entries(handle)
                profiling.add_time(
                    "reiterate.drain_collect", __import__("time").time() - _tc
                )
                futs.append(
                    fin_pool.submit(
                        _finish_chunk,
                        (chunk, arena, off, lens, ws, los, his, smidx, best, aecl),
                    )
                )
                while len(futs) > 1:
                    _store(futs.pop(0))
            while futs:
                _store(futs.pop(0))
        profiling.add_time("reiterate.device_drain", __import__("time").time() - _t_dev)
        profiling.count("reiterate.device_scored_reads", len(device))
        bh.close()

    import time as _time

    _t_merge = _time.time()
    for fs in fsdb.fss:
        if maln.distant_ref and not fs.strand_known and iter_num > 1 and not reprobed:
            _reprobe(fs)

        if fs.strand_known:
            res = native_results.get(id(fs))
            if res is not None:
                best, abc, aec, rb, fb = res
                if isinstance(rb, bytes):  # native-finish arenas
                    rb = rb.decode("latin-1")
                    fb = fb.decode("latin-1")
                _merge_front(fs, best, abc, aec, (rb, fb))
            else:
                _python_realign(fs)
    profiling.add_time("reiterate.merge", _time.time() - _t_merge)
