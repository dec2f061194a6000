"""On-card checks: the same program on the GPU must give the golden bytes and
the scalar oracle's scores.  Marked ``gpu``; they skip without a card (run
them there with ``python -m pytest tests -m gpu``).  ``chip_smoke.py`` runs
the same checks at full size."""
import os
import subprocess
import sys

import pytest

from .conftest import FIXTURES, GOLDEN

ORACLE_CHECK = r"""
import numpy as np
import jax
import mia.core.jax_engine as je
from mia.core.entry_check import oracle_scores, random_entries
assert jax.devices()[0].platform == "gpu", jax.devices()
ent = random_entries(2 * je.default_batch(), seed=3, len1=16825)
sc = je.Pass1Scorer(ent.fw, ent.rc, len(ent.fw), ent.sms[0], ent.sms[1],
                    warm=False)
best, aec = sc.collect_entries(sc.dispatch_entries(*ent.args()))
want_best, want_aec = oracle_scores(ent)
np.testing.assert_array_equal(best, want_best)
np.testing.assert_array_equal(aec, want_aec)
print("ORACLE_OK")
"""


@pytest.mark.gpu
def test_jax_engine_golden_on_gpu(gpu_env, tmp_path):
    """Full fixture assembly with --engine jax on the card == golden bytes
    (the kmer config, so pass 1 takes the windowed device program)."""
    env = dict(gpu_env, MIA_SERVER="0", MIA_STEAL="0")
    subprocess.run(
        [sys.executable, "-m", "mia.cli.mia",
         "-r", os.path.join(FIXTURES, "tr1.fna"),
         "-f", os.path.join(FIXTURES, "tf.fna"),
         "-k", "12", "-m", "out.maln", "--engine", "jax"],
        cwd=tmp_path, env=env, check=True, capture_output=True, timeout=900,
    )
    golden = os.path.join(GOLDEN, "kmer")
    produced = sorted(p for p in os.listdir(tmp_path) if p.startswith("out.maln."))
    assert produced == sorted(os.listdir(golden))
    for fn in produced:
        with open(tmp_path / fn, "rb") as a, open(os.path.join(golden, fn), "rb") as b:
            assert a.read().split(b"\n")[1:] == b.read().split(b"\n")[1:], fn


@pytest.mark.gpu
def test_entry_program_vs_oracle_on_gpu(gpu_env):
    """One full batch of random banded entries on the card == the exact
    scalar engine (scores and earliest-tie end columns)."""
    r = subprocess.run([sys.executable, "-c", ORACLE_CHECK], env=gpu_env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ORACLE_OK" in r.stdout
