"""PSSM matrix-file parsing + bundled matrix resolution.

Matrix files carry 15 begin + MIDDLE + 15 end blocks of 4x4 scores under
'# Matrix for position' headers (read_pssm, src/io.c:408-503); N column/row
scores are injected as N_SCORE/NR_SCORE.  Bundled aDNA matrices live in
``mia/data/matrices`` and are resolved like the reference's DATA_PATH
search (find_read_pssm, src/mia_main.c:299-328).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..constants import N_SCORE, NR_SCORE, PSSM_DEPTH

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
MATRIX_DIR = os.path.join(DATA_DIR, "matrices")


def read_pssm(path: str) -> np.ndarray:
    with open(path) as fh:
        lines = fh.read().split("\n")
    it = iter(lines)
    sm = np.zeros((2 * PSSM_DEPTH + 1, 5, 5), dtype=np.int32)

    def block(cur_pos: int, expect: str) -> None:
        line = next(it)
        if expect not in line:
            raise ValueError(f"Problem parsing matrix file: {path}")
        for base in range(4):
            vals = next(it).split()
            sm[cur_pos, base, :4] = [int(v) for v in vals[:4]]
            sm[cur_pos, base, 4] = N_SCORE
        sm[cur_pos, 4, :] = NR_SCORE
        next(it)  # blank separator

    for cur_pos in range(PSSM_DEPTH):
        block(cur_pos, "# Matrix for position")
    block(PSSM_DEPTH, "# Matrix for position: MIDDLE")
    for cur_pos in range(PSSM_DEPTH + 1, 2 * PSSM_DEPTH + 1):
        block(cur_pos, "# Matrix for position:")
    return sm


def find_read_pssm(fn: str) -> np.ndarray:
    """Resolve ``fn`` against cwd then the bundled matrix dir, listing the
    available matrices on a miss (src/mia_main.c:299-328)."""
    if "/" in fn or os.access(fn, os.F_OK):
        return read_pssm(fn)
    f2 = os.path.join(MATRIX_DIR, fn)
    if not os.access(f2, os.F_OK):
        if os.path.isdir(MATRIX_DIR):
            print(
                f"Substitution matrix not found.  Known matrices in {MATRIX_DIR} are:",
                file=sys.stderr,
            )
            for name in sorted(os.listdir(MATRIX_DIR)):
                if not name.startswith("."):
                    print(name, file=sys.stderr)
            raise SystemExit(1)
    return read_pssm(f2)
