"""Damage-model estimation: fit from a maln, write a loadable matrix file,
and confirm the fitted scores reflect the simulated deamination pattern."""
import os

import numpy as np

from mia.constants import PSSM_DEPTH
from mia.io.maln import read_ma
from mia.io.pssm_io import read_pssm
from mia.models.estimate import (
    count_substitutions,
    estimate_from_maln,
    fit_pssm,
)

from .conftest import GOLDEN


def test_estimate_roundtrip(tmp_path):
    maln = read_ma(os.path.join(GOLDEN, "sim200", "out.maln.2"))
    out = tmp_path / "fit.submat.txt"
    scores = estimate_from_maln(maln, str(out))
    assert scores.shape == (31, 4, 4)
    sm = read_pssm(str(out))
    np.testing.assert_array_equal(sm[:, :4, :4], scores)
    # N column/row injected by the parser (ref-N row wins the corner cell)
    assert (sm[:, :4, 4] == -100).all()
    assert (sm[:, 4, :] == -10).all()


def test_estimate_sees_end_damage(tmp_path):
    """The simulator deaminates C->T at 5' ends; the fitted matrix must score
    C->T higher (less negative) at depth 0 than in the middle."""
    maln = read_ma(os.path.join(GOLDEN, "sim200", "out.maln.2"))
    counts = count_substitutions(maln)
    scores = fit_pssm(counts)
    c_t_start = scores[0, 1, 3]
    c_t_mid = scores[PSSM_DEPTH, 1, 3]
    assert c_t_start > c_t_mid
    # and matches stay strongly positive everywhere
    for d in (0, PSSM_DEPTH, 30):
        for b in range(4):
            assert scores[d, b, b] > 100
