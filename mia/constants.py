"""Runtime constants for the MIA framework.

The reference (mpieva/mapping-iterative-assembler) bakes all tunables into
compile-time macros (``src/params.h:15-78``).  Here they are runtime values in
one place so nothing ever needs a recompile; :class:`mia.config.MiaConfig`
exposes the per-run subset.
"""

DEBUG = 0
CONS_SCHEME = 1
MAX_ID_LEN = 100            # src/params.h:17
MAX_DESC_LEN = 128          # src/params.h:18
CLUSTALW_LINE_WIDTH = 60    # src/params.h:19
FASTA_LINE_WIDTH = 60       # src/params.h:20
MAX_LINE_LEN = 1_000_000    # src/params.h:21
PSSM_DEPTH = 15             # src/params.h:22
SCORE_CUTOFF_BUFFER = 80    # src/params.h:24
FIRST_ROUND_SCORE_CUTOFF = 2000  # src/params.h:25
GOP = 1000                  # gap open penalty, src/params.h:26
GEP = 200                   # gap extension penalty, src/params.h:27
FLAT_MATCH = 200            # src/params.h:28
FLAT_MISMATCH = -600        # src/params.h:29
N_SCORE = -100              # src/params.h:30
NR_SCORE = -10              # score for N in reference, src/params.h:31
TRIM_SCORE_CUT = 1000       # src/params.h:32
MAX_ITER = 30               # src/params.h:33
REALIGN_BUFFER = 50         # src/params.h:34
QUAL_ASCII_OFFSET = 33      # src/params.h:35
DEF_S = 200.0               # src/params.h:36
DEF_N = 0.0                 # src/params.h:37
MIN_ALIGNABLE_LEN = 15      # src/params.h:38
MIN_SCORE_CONS = -399       # src/params.h:41
MIN_SC_DIFF_CONS = 2400     # src/params.h:43
PERC4GAP = 50               # src/params.h:45
INIT_NUM_IDS = 1048576      # src/params.h:51
MAX_INS_LEN = 512           # src/params.h:58
INIT_REF_SEQ_LEN = 32768    # src/params.h:63
INIT_ALN_SEQ_LEN = 256      # max read length, src/params.h:68
INIT_NUM_ALN_SEQS = 16000   # src/params.h:69
MAX_KMER_POS = 128          # src/params.h:75
MAX_KMER_LEN = 14           # src/params.h:76
KMER_SATURATE = 128         # src/params.h:77
ALIGN_MASK_BUFFER = 10      # src/params.h:78

# "Half of INT_MIN": sentinel for masked DP cells that can be subtracted from
# without underflow (src/mia.c:751-753).
HIM = -(2**31) // 2  # == INT_MIN / 2 in C (-1073741824)

# Built-in sequencing adapters (src/mia_main.c:462-463).
NEANDERTAL_ADAPTER = "GTCAGACACGCAACAGGGGATAGGCAAGGCACACAGGGGATAGG"
STANDARD_ADAPTER = "CTGAGACACGCAACAGGGGATAGGCAAGGCACACAGGGGATAGG"

PACKAGE_NAME = "MIA"
PACKAGE_VERSION = "1.0"
PACKAGE_BUGREPORT = "green@eva.mpg.de"
