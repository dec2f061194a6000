"""Scalar cell-by-cell DP used as a differential oracle for the vectorised
engines.  Deliberately the most literal possible rendering of the recurrence
(dyn_prog, src/mia.c:740-981) — slow, obvious, and independent of the
production code paths."""
import numpy as np

from mia.constants import GEP, GOP, HIM
from mia.ops.dp_numpy import hp_discount_penalty
from mia.ops.pssm import find_sm_depth


def scalar_dyn_prog(s1c, s2c, sm, mask, sg5, seq1=None, seq2=None, hp=None):
    """Returns (score, trace) int64 matrices.  ``hp`` is an optional tuple
    (hpcl, hpcs, hprl, hprs)."""
    len1, len2 = len(s1c), len(s2c)
    score = np.zeros((len2, len1), dtype=np.int64)
    trace = np.zeros((len2, len1), dtype=np.int64)
    best_gap_row = np.zeros(len1, dtype=np.int64)
    if hp is not None:
        hpcl, hpcs, hprl, hprs = hp

    row_sm = [sm[0][i][s2c[0]] for i in range(5)]
    for col in range(len1):
        score[0, col] = row_sm[s1c[col]] if mask[col] else HIM
        best_gap_row[col] = 0

    for row in range(1, len2):
        d = find_sm_depth(row, len2)
        row_sm = [sm[d][i][s2c[row]] for i in range(5)]
        if mask[0]:
            score[row, 0] = row_sm[s1c[0]]
            if sg5:
                score[row, 0] -= GOP + GEP * (row + 1)
        else:
            score[row, 0] = HIM
        trace[row, 0] = 0
        best_gap_col = 0
        for col in range(1, len1):
            if not mask[col]:
                score[row, col] = HIM
                trace[row, col] = 0
                continue
            if col >= 2:
                if (score[row - 1, col - 2] - (GOP + GEP)) > (
                    score[row - 1, best_gap_col]
                    - (GOP + GEP * (col - best_gap_col - 1))
                ):
                    best_gap_col = col - 2
                gap_col = score[row - 1, best_gap_col] - (
                    GOP + GEP * (col - best_gap_col - 1)
                )
            else:
                gap_col = HIM
            if row >= 2:
                if (score[row - 2, col - 1] - (GOP + GEP)) > (
                    score[best_gap_row[col - 1], col - 1]
                    - (GOP + GEP * (row - best_gap_row[col - 1] - 1))
                ):
                    best_gap_row[col - 1] = row - 2
                gap_row = score[best_gap_row[col - 1], col - 1] - (
                    GOP + GEP * (row - best_gap_row[col - 1] - 1)
                )
            else:
                gap_row = HIM
            diag = score[row - 1, col - 1]
            sn = -(GOP + GEP * (row + 1)) if sg5 else 0
            hc = hr = HIM
            if hp is not None and seq1[col] == seq2[row]:
                if hprs[row] == row and hpcs[col] != col and hpcs[col] > 0:
                    hc = score[row - 1, hpcs[col] - 1] - hp_discount_penalty(
                        col - hpcs[col], hpcl[col], hprl[row]
                    )
                if hpcs[col] == col and hprs[row] != row and hprs[row] > 0:
                    hr = score[hprs[row] - 1, col - 1] - hp_discount_penalty(
                        col - hpcs[col], hpcl[col], hprl[row]
                    )
            if sn > diag and sn > gap_col and sn > gap_row and sn > hc and sn > hr:
                trace[row, col] = col
                score[row, col] = sn
            elif diag >= gap_col and diag >= gap_row and diag >= hc and diag >= hr:
                trace[row, col] = 0
                score[row, col] = row_sm[s1c[col]] + diag
            elif gap_col >= gap_row and gap_col >= hc and gap_col >= hr:
                score[row, col] = row_sm[s1c[col]] + gap_col
                trace[row, col] = best_gap_col
            elif gap_row >= hc and gap_row >= hr:
                score[row, col] = row_sm[s1c[col]] + gap_row
                trace[row, col] = -best_gap_row[col - 1]
            elif hc >= hr:
                score[row, col] = row_sm[s1c[col]] + hc
                trace[row, col] = hpcs[col] - 1
            else:
                score[row, col] = row_sm[s1c[col]] + hr
                trace[row, col] = -(hprs[row] - 1)
    return score, trace
