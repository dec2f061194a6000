"""Core assembly-state types.

Array-of-structs in the reference (src/types.h) becomes lightweight Python
objects carrying NumPy arrays here; the hot data (sequences, masks, counts)
lives in dense arrays shaped for the device programs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(slots=True)
class FragSeq:
    """A raw read plus its alignment state (src/types.h:110-133)."""

    id: str = ""
    desc: str = ""
    seq: str = ""
    qual: str = ""
    qual_sum: int = 0
    trim_point: int = 0
    trimmed: bool = False
    seq_len: int = 0
    strand_known: bool = False
    rc: bool = False
    as_: int = 0
    ae: int = 0
    score: int = 0
    front_asp: Optional["AlnSeq"] = None
    back_asp: Optional["AlnSeq"] = None
    # True when back_asp was (re)written by THIS iteration's merge — the
    # reference leaves stale back pointers otherwise (src/mia_main.c:273-276)
    back_fresh: bool = False
    # multi-host stub bookkeeping (parallel/distributed.GlobalReadFilter):
    # this read's global maln slot indices under the current layout
    front_slot: Optional[int] = None
    back_slot: Optional[int] = None
    unique_best: bool = False
    num_inputs: int = 0
    # quality pileup for read collapsing: [4, len] uint32 (A,C,G,T rows),
    # lazily created (src/types.h:101-107)
    qss: Optional[np.ndarray] = None
    # global stream index for multi-host runs (parallel/distributed.py);
    # -1 in single-process mode
    gid: int = -1


@dataclass(slots=True)
class AlnSeq:
    """A read merged into the multi-alignment (src/types.h:61-78).

    ``seq`` is the gapped read over its reference span; ``ins`` maps span
    offset -> inserted string (gap in the reference immediately before that
    offset); ``smp`` holds 'A'+depth PSSM codes per span position.
    """

    id: str = ""
    desc: str = ""
    seq: str = ""
    smp: str = ""
    ins: dict = field(default_factory=dict)
    start: int = 0
    end: int = 0
    score: int = 0
    num_inputs: int = 0
    segment: str = "n"  # f=front, a=all, b=back, n=not applicable
    revcom: bool = False
    trimmed: bool = False
    dropped: bool = False


@dataclass
class RefSeq:
    """Reference sequence + revcom + per-column max-insert array
    (src/types.h:84-98)."""

    id: str = ""
    desc: str = ""
    seq: str = ""
    rcseq: Optional[str] = None
    seq_len: int = 0
    size: int = 0
    gaps: Optional[np.ndarray] = None  # int32 [wrap_seq_len+1]
    circular: bool = False
    wrap_seq_len: int = 0


@dataclass
class PWAlnFrag:
    """Pairwise alignment fragment, the unit merged into a MapAlignment
    (src/types.h:37-54)."""

    ref_id: str = ""
    ref_desc: str = ""
    frag_id: str = ""
    frag_desc: str = ""
    ref_seq: str = ""
    frag_seq: str = ""
    start: int = 0
    end: int = 0
    revcom: bool = False
    trimmed: bool = False
    score: int = 0
    segment: str = "n"
    num_inputs: int = 0
    offset: int = 0


@dataclass
class MapAlignment:
    """The whole assembly state (src/types.h:183-196).

    The reference preallocates an AlnSeqArray and *reuses* its slots across
    iterations (reiterate_assembly resets num_aln_seqs and overwrites entries
    in merge order, src/mia_main.c:81-106).  Because FragSeqs keep pointers
    into those slots, and merge never resets the ``dropped``/``smp`` fields,
    slot identity is observable in the output.  ``pool`` + ``num_aln_seqs``
    reproduce that: merges overwrite pool objects in place, so stale
    FragSeq.front_asp references alias exactly as in C.
    """

    ref: RefSeq = field(default_factory=RefSeq)
    fpsm: Optional[np.ndarray] = None  # [31,5,5] int32
    rpsm: Optional[np.ndarray] = None
    cons_code: int = 1
    distant_ref: bool = False
    pool: list = field(default_factory=list)
    num_aln_seqs: int = 0
    # maln-format parity with the reference's growable AlnSeqArray
    # (MALN_SIZ header field, src/map_alignment.c:304)
    size: int = 16000

    @property
    def aln_seqs(self) -> list:
        return self.pool[: self.num_aln_seqs]

    def set_aln_seqs(self, seqs: list) -> None:
        self.pool = list(seqs)
        self.num_aln_seqs = len(seqs)

    def next_slot(self) -> "AlnSeq":
        """Slot for the next merge: reuse an existing object when available,
        mirroring the reference's AlnSeqArray reuse."""
        if self.num_aln_seqs < len(self.pool):
            slot = self.pool[self.num_aln_seqs]
        else:
            slot = AlnSeq()
            self.pool.append(slot)
        self.num_aln_seqs += 1
        return slot


class FSDB:
    """Read database (src/types.h:136-143): a list of FragSeqs plus the
    sort/uniq/score machinery in :mod:`mia.core.fsdb`."""

    def __init__(self) -> None:
        self.fss: list[FragSeq] = []

    @property
    def num_fss(self) -> int:
        return len(self.fss)

    def add(self, fs: FragSeq) -> None:
        self.fss.append(fs)
