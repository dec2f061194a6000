"""Native C++ parser must produce records identical to the exact Python
parser (skipped when native/libmiaio.so is not built)."""
import os
import subprocess

import pytest

from mia.io.fasta import iter_frag_seqs
from mia.io.native import native_available, parse_reads_native

from .conftest import FIXTURES


def _ensure_built():
    if native_available():
        return True
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        subprocess.run(
            ["make", "-C", os.path.join(repo, "native")],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except Exception:
        return False
    # force a re-probe after building
    import mia.io.native as n

    n._TRIED = False
    n._LIB = None
    return native_available()


@pytest.mark.parametrize("name", ["tf.fna", "tf.fastq", "sim200.fastq"])
def test_native_matches_python(name):
    if not _ensure_built():
        pytest.skip("native library unavailable and could not be built")
    path = os.path.join(FIXTURES, name)
    a = parse_reads_native(path)
    b = list(iter_frag_seqs(path))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.id, x.desc, x.seq, x.qual, x.seq_len, x.qual_sum) == (
            y.id, y.desc, y.seq, y.qual, y.seq_len, y.qual_sum,
        )
