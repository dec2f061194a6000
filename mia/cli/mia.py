"""mia CLI: iterative assembler entry point (src/mia_main.c:394-989).

Same flag surface as the reference binary, including the no-space -C<tol>
optional-argument quirk.
"""
from __future__ import annotations

import sys

from ..config import MiaConfig, check_switches
from ..constants import FLAT_MATCH, FLAT_MISMATCH, N_SCORE, NEANDERTAL_ADAPTER, STANDARD_ADAPTER
from ..core.assembler import run_assembly


def help_text() -> str:
    return (
        "\n"
        "\n"
        "MIA -- Mapping Iterativ Assembler V 1.0\n"
        "       A tool for creating short read assemblies.\n"
        "\n"
        "Copyright Richard E. Green, Michael Siebauer 2008-2009\n"
        "Report bugs to <green@eva.mpg.de>.\n"
        "===============================+++++++++++++==\n"
        "\n"
        "Usage:\n"
        "mia -r <reference sequence>\n"
        "    -f <fasta or fastq file of fragments to align>\n"
        "    -s <substitution matrix file> (if not supplied an default matrix is used)\n"
        "    -m <root file name for maln output file(s)> (assembly.maln.iter)\n"
        "    \n"
        "FILTER parameters:\n"
        "    -u fasta database has repeat sequences, keep one based on alignment score\n"
        "    -U fasta database has repeat sequences, keep one based on sum of q-scores\n"
        "    -C<tolerance> collapse sequences with same start, end, strand info into a single sequence\n"
        "       Allow <tolerance> bases difference for start and end coordinates\n"
        "       Important: keep NO SPACE between parameter and value: e.g. -C3\n"
        "    -A use adapter presence and coordinate information to more aggressively\n"
        "       remove repeat sequences - suitable only for 454 sequences that have not\n"
        "       already been adapter trimmed\n"
        "    -T fasta database has adapters, trim these\n"
        "    -a <adapter sequence or code>\n"
        "    -k <use kmer filter with kmers of this length>\n"
        "    -I <filename of list of sequence IDs to use, ignoring all others>\n"
        "    \n"
        "ALIGNMENT parameters:\n"
        "    -p <consensus calling code; default = 1>\n"
        "    -c means reference/assembly is circular\n"
        "    -i iterate assembly until convergence (default)\n"
        "    -n do not iterate assembly until convergence\n"
        "    -F <only output the FINAL assembly, not each iteration>\n"
        "    -D <distantly related reference sequence>\n"
        "    -h give special discount for homopolymer gaps\n"
        "    -M <use lower-case soft-masking of kmers>\n"
        "    -H <do not do dynamic score cutoff, instead use this Hard score cutoff>\n"
        "    -S <slope of length/score cutoff line>\n"
        "    -N <intercept of length/score cutoff line>\n"
        "The default substitution matrix used the following parameters:\n"
        "  MATCH=200, MISMATCH=-600, N=-100 for all positions\n"
        "The procedure for removing bad-scoring alignments from the assembly is:\n"
        "Default: fit a line to length versus score and remove reads that are\n"
        "less that SCORE_CUTOFF_BUFFER than the average score for its length.\n"
        "If -H is specified then this hard score cutoff is applied to all reads.\n"
        "This is preferable if all reads are the same length.\n"
        "If -S or -N are specified, then these are used as the slope and intercept\n"
        "of a length/score line. Reads must score above this line to be included.\n"
        "If only one of -S or -N is specified then the default values are used for\n"
        "the other (default S = 200.0; default N = 0.0)\n"
        "The kmer filter requires that a sequence fragment have at least one\n"
        "kmer of the specified length in common with the reference sequence in\n"
        "order to align it. For 36nt Solexa data, a value of 12 works well.\n"
        "The -p option specifies how the new consensus assembly sequence is called\n"
        "at each iteration:\n"
        "1 => Any base whose aggregate score is MIN_SC_DIFF_CONS better than all\n"
        "      others is the assembly base. If none is, then N is the assembly base.\n"
        "2 => The best scoring base whose aggregate score is better than MIN_SCORE_CONS\n"
        "     is the assembly base. If none is, then N is the assembly base.\n"
        "If -T is specified, mia will attempt to find and trim adapters on\n"
        "each sequence. The adapter sequence itself can be specified by a\n"
        "one letter code as argument to -a. N or n => Neandertal adapter\n"
        "                  any other single letter => Standard GS FLX adapter\n"
        "              sequence (less than 127 nt) => user-specified adapter\n"
    )

def _atoi(s: str) -> int:
    """C atoi: optional sign + leading digits, else 0."""
    s = s.lstrip()
    m = __import__("re").match(r"[+-]?\d+", s)
    return int(m.group(0)) if m else 0


def parse_args(argv: list[str]) -> MiaConfig | None:
    cfg = MiaConfig()
    any_arg = False
    i = 0

    def need_val() -> str:
        nonlocal i
        i += 1
        if i >= len(argv):
            sys.stdout.write(help_text()); raise SystemExit(0)
        return argv[i]

    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("-") or arg == "-":
            print(
                "There seems to be some extra cruff on the command line that mia does not understand.",
                file=sys.stderr,
            )
            raise SystemExit(0)
        flag = arg[1]
        inline = arg[2:]
        if flag == "c":
            cfg.circular = True
        elif flag == "q":
            cfg.make_fastq = True
            cfg.fastq_out_fn = inline or need_val()
            # reference falls through 'q' into 'C' (missing break,
            # src/mia_main.c:482-490): -q also enables collapsing, with
            # tolerance = atoi(filename) (usually 0)
            cfg.collapse = True
            cfg.tolerance = _atoi(cfg.fastq_out_fn)
            print(f"setting collapsing tolerance to {cfg.tolerance}", file=sys.stderr)
        elif flag == "C":
            cfg.collapse = True
            if inline:
                cfg.tolerance = int(inline)
            print(f"setting collapsing tolerance to {cfg.tolerance}", file=sys.stderr)
        elif flag == "n":
            cfg.iterate = False
        elif flag == "i":
            cfg.iterate = True
        elif flag == "h":
            cfg.hp_special = True
        elif flag == "u":
            cfg.repeat_filt = True
        elif flag == "A":
            cfg.just_outer_coords = False
        elif flag == "U":
            cfg.repeat_qual_filt = True
        elif flag == "D":
            cfg.distant_ref = True
        elif flag == "p":
            cfg.cons_code = int(inline or need_val())
            any_arg = True
        elif flag == "I":
            cfg.ids_file = inline or need_val()
        elif flag == "H":
            cfg.hard_cut = int(inline or need_val())
            if cfg.hard_cut <= 0:
                print("Hard cutoff (-H) must be positive", file=sys.stderr)
                sys.stdout.write(help_text())
                raise SystemExit(0)
            any_arg = True
        elif flag == "M":
            cfg.soft_mask = True
        elif flag == "s":
            cfg.submat_fn = inline or need_val()
            any_arg = True
        elif flag == "r":
            cfg.ref_fn = inline or need_val()
            any_arg = True
        elif flag == "k":
            cfg.kmer_filt_len = int(inline or need_val())
            any_arg = True
        elif flag == "f":
            cfg.frag_fn = inline or need_val()
            any_arg = True
        elif flag == "m":
            cfg.maln_root = inline or need_val()
            any_arg = True
        elif flag == "T":
            cfg.do_adapter_trimming = True
        elif flag == "a":
            val = inline or need_val()
            if len(val) > 127:
                print(
                    "That adapter is too big!\nMIA will use the standard adapter.",
                    file=sys.stderr,
                )
                cfg.adapter = STANDARD_ADAPTER
            elif len(val) > 1:
                cfg.adapter = val
            elif val and val[0] in "nN":
                cfg.adapter = NEANDERTAL_ADAPTER
            else:
                cfg.adapter = STANDARD_ADAPTER
        elif flag == "S":
            cfg.slope = float(inline or need_val())
            cfg.score_cut_set = True
        elif flag == "N":
            cfg.intercept = float(inline or need_val())
            cfg.score_cut_set = True
        elif flag == "F":
            cfg.final_only = True
        elif flag == "-" and arg == "--engine":
            cfg.engine = need_val()
        elif flag == "-" and arg in ("--dp-devices", "--dp"):
            cfg.dp_devices = int(need_val())
        elif flag == "-" and arg == "--profile":
            cfg.profile = True
        else:
            sys.stdout.write(help_text())
            raise SystemExit(0)
        i += 1

    if not any_arg:
        sys.stdout.write(help_text())
        raise SystemExit(0)
    return cfg


def main(argv: list[str] | None = None) -> int:
    import time

    from ..utils import profiling

    argv = sys.argv[1:] if argv is None else argv
    check_switches()
    cfg = parse_args(argv)
    if cfg is not None and cfg.profile:
        profiling.enable()
    print(
        f"Starting assembly of {cfg.frag_fn}\nusing {cfg.ref_fn}\n"
        f"as reference at {time.asctime()}\n",
        file=sys.stderr,
    )
    with profiling.device_trace():
        run_assembly(cfg)
    if cfg.profile:
        profiling.report()
    print(f"Assembly finished at {time.asctime()}\n", file=sys.stderr)
    # a deferred device-init/warmup thread may still be inside an XLA
    # compile (work-stealing finished the assembly without it); normal
    # interpreter teardown would kill it mid-C++ and abort the process, so
    # skip teardown entirely in that case
    try:
        from ..core import jax_engine

        if jax_engine.background_work_pending():
            sys.stdout.flush()
            sys.stderr.flush()
            import os

            os._exit(0)
    except ImportError:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
