"""ccheck CLI: contamination checker over maln files
(src/ccheck.cc:369-886)."""
from __future__ import annotations

import os
import re
import sys

from ..config import check_switches
from ..core.contamination import LABELS, check_contamination, sanity_check_sequence
from ..io.fasta import read_fasta_ref
from ..io.maln import read_ma
from ..io.pssm_io import DATA_DIR


def usage(pname: str) -> str:
    return (
        f"Usage: {pname} [-r <ref.fa>] [-a] [-t] [-s M-N] [-v] <aln.maln> \n\n"
        "Reads a maln file and tries to quantify contained contamination.\n"
        "Options:\n"
        "  -r, --reference FILE     FASTA file with the likely contaminant (default: builtin mt311)\n"
        "  -a, --ancient            Treat DNA as ancient (i.e. likely deaminated)\n"
        "  -t, --transversions      Treat only transversions as diagnostic\n"
        "  -s, --span M-N           Look only at range from M to N\n"
        "  -n, --numpos N           Require N diagnostic sites in a single read (default: 1)\n"
        "  -f, --force              Do not look for a higher numbered .maln\n"
        "  -T, --table              Output as tables (easier for scripts, harder on the eyes)\n"
        "  -v, --verbose            Increase verbosity level (can be repeated)\n"
        "  -h, --help               Print this help message\n\n"
    )


def load_mt311() -> str:
    path = os.path.join(DATA_DIR, "mt311.fa")
    with open(path) as fh:
        lines = fh.read().split("\n")
    return "".join(l for l in lines[1:] if l and not l.startswith(">"))


def find_maln(fn: str) -> str:
    """Auto-pick the highest-numbered maln iteration file
    (src/ccheck.cc:206-236)."""
    d, base = os.path.split(fn)
    d = d or "."
    while base and base[-1].isdigit():
        base = base[:-1]
    num = 1
    best = fn
    try:
        entries = os.listdir(d)
    except OSError:
        return fn
    for name in entries:
        if len(name) > len(base) and name.startswith(base):
            rest = name[len(base):]
            if rest.isdigit():
                n = int(rest)
                if n > num:
                    num = n
                    best = name if os.path.split(fn)[0] == "" else os.path.join(d, name)
    return best


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    check_switches()
    adna = False
    transversions = False
    be_clever = True
    mktable = False
    really = False
    min_diag_posns = 1
    verbose = 0
    maxd = 0
    span_from, span_to = 0, 2**31 - 1
    ref_seq = None
    engine = "native"
    files: list[str] = []

    long_map = {
        "--reference": "r", "--ancient": "a", "--verbose": "v", "--help": "h",
        "--transversions": "t", "--span": "s", "--maxd": "d", "--table": "T",
        "--shoot": "F", "--foot": "F", "--force": "f", "--numpos": "n",
    }
    needs_arg = set("rsdn")

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "--engine":
            i += 1
            engine = argv[i] if i < len(argv) else "native"
            i += 1
            continue
        if arg.startswith("--"):
            if "=" in arg:
                name, val = arg.split("=", 1)
            else:
                name, val = arg, None
            flag = long_map.get(name)
            if flag is None:
                sys.stderr.write("unknown option\n")
                i += 1
                continue
            if flag in needs_arg and val is None:
                i += 1
                val = argv[i] if i < len(argv) else ""
        elif arg.startswith("-") and len(arg) > 1:
            flag = arg[1]
            val = arg[2:] or None
            if flag in needs_arg and val is None:
                i += 1
                val = argv[i] if i < len(argv) else ""
        else:
            files.append(arg)
            i += 1
            continue

        if flag == "r":
            ref = read_fasta_ref(val)
            ref_seq = ref.seq
        elif flag == "a":
            adna = True
        elif flag == "v":
            verbose += 1
        elif flag == "h":
            print(usage("ccheck"), end="")
            return 1
        elif flag == "t":
            transversions = True
        elif flag == "s":
            m = re.match(r"(\d+)-(\d+)", val or "")
            if m:
                span_from, span_to = int(m.group(1)), int(m.group(2))
                if span_from:
                    span_from -= 1
        elif flag == "n":
            min_diag_posns = int(val)
        elif flag == "d":
            maxd = int(val)
        elif flag == "f":
            be_clever = False
        elif flag == "T":
            mktable = True
        elif flag == "F":
            really = True
        i += 1

    if not files:
        print(usage("ccheck"), end="")
        return 1

    if ref_seq is None:
        ref_seq = load_mt311()

    hum_ref_ok = sanity_check_sequence(ref_seq)
    if not hum_ref_ok:
        sys.stderr.write(
            "FUBAR'ed FastA file: contaminant sequence contains gap symbols.\n"
        )

    if mktable:
        hdr = ["#Filename", "Aln.dist", "#diff", "#weak", "#tv"]
        for g in range(2):
            hdr.append("#eff" if g else "#strong")
            for lab in LABELS:
                hdr.append(lab + ("'" if g else ""))
        sys.stdout.write("\t".join(hdr) + "\n")

    rc = 0
    for fn in files:
        infile = find_maln(fn) if be_clever else fn
        if mktable:
            sys.stdout.write(infile + "\t")
        else:
            sys.stdout.write(infile + "\n\n")
        maln = read_ma(infile)
        maln_ref_ok = sanity_check_sequence(maln.ref.seq)
        if not maln_ref_ok:
            sys.stderr.write(
                "FUBAR'ed maln file: consensus sequence contains gap symbols.\n"
            )
        if not hum_ref_ok or not maln_ref_ok:
            sys.stderr.write(
                "Problem might exist between keyboard and chair.  I give up.\n"
            )
            return 1
        r = check_contamination(
            maln,
            ref_seq,
            adna=adna,
            transversions=transversions,
            min_diag_posns=min_diag_posns,
            span_from=span_from,
            span_to=span_to,
            maxd=maxd,
            mktable=mktable,
            really=really,
            verbose=verbose,
            infile=infile,
            engine=engine,
        )
        if r:
            return r
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
