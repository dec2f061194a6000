"""Ancient-DNA damage models.

The reference ships three empirically fitted position-specific substitution
matrices (matrices/*.txt: 454, Solexa one-pass, Solexa paired-end) that score
C->T / G->A deamination near fragment ends.  This module is the model family
around them: named accessors for the bundled PSSMs and a generative damage
model used by the read simulator (:mod:`mia.models.simulate`) to produce
benchmark read sets whose error structure matches what the PSSMs score.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..io.pssm_io import MATRIX_DIR, read_pssm
from ..ops.pssm import init_flatsubmat

BUNDLED = {
    "flat": None,
    "ancient": "ancient.submat.txt",
    "solexa-onepass": "ancient.submat.solexa.onepass.txt",
    "solexa-pe": "ancient.submat.solexa.pe.txt",
}


def load_pssm(name: str) -> np.ndarray:
    """Load a bundled PSSM by short name ('flat', 'ancient', 'solexa-onepass',
    'solexa-pe') or a path."""
    if name in BUNDLED:
        fn = BUNDLED[name]
        if fn is None:
            return init_flatsubmat()
        return read_pssm(os.path.join(MATRIX_DIR, fn))
    return read_pssm(name)


@dataclass
class DamageModel:
    """Generative deamination model: C->T at 5' ends, G->A at 3' ends, with
    exponentially decaying rate from each fragment end."""

    p5_max: float = 0.3       # C->T probability at the 5' terminal base
    p3_max: float = 0.3       # G->A probability at the 3' terminal base
    decay: float = 0.3        # per-base geometric decay of the end effect
    background: float = 0.01  # residual deamination rate in the interior

    def rates(self, length: int) -> tuple[np.ndarray, np.ndarray]:
        pos = np.arange(length)
        p5 = self.background + (self.p5_max - self.background) * self.decay ** pos
        p3 = self.background + (self.p3_max - self.background) * self.decay ** (
            length - 1 - pos
        )
        return p5, p3

    def apply(self, frag: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """frag: int8 codes 0..3 (A,C,G,T); returns damaged copy."""
        n = len(frag)
        p5, p3 = self.rates(n)
        u = rng.random(n)
        out = frag.copy()
        out[(frag == 1) & (u < p5)] = 3  # C->T
        out[(frag == 2) & (u < p3)] = 0  # G->A
        return out
