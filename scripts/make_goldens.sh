#!/bin/bash
# Regenerate tests/golden/* by running the reference C implementation.
#
# Requires the upstream mpieva/mapping-iterative-assembler sources compiled as
# described below; goldens are committed so CI never needs this.
#
#   cp -r <reference-checkout> /tmp/refsrc && cd /tmp/refsrc/src
#   printf '#define PACKAGE_NAME "MIA"\n#define PACKAGE_VERSION "1.0"\n#define PACKAGE_BUGREPORT "green@eva.mpg.de"\n' > config.h
#   gcc -std=gnu89 -O2 -DDATA_PATH='"/tmp/refsrc/share"' -include config.h \
#       -c myers_align.c fsdb.c io.c kmer.c map_align.c map_alignment.c mia.c pssm.c mt311.c mia_main.c map_assembler.c
#   gcc -std=gnu89 -O2 -o mia mia.o pssm.o fsdb.o kmer.o mia_main.o map_align.o io.o map_alignment.o -lm
#   gcc -std=gnu89 -O2 -o ma map_alignment.o map_assembler.o io.o map_align.o -lm
#   mkdir -p /tmp/refsrc/share/matrices && cp ../matrices/*.txt /tmp/refsrc/share/matrices/
set -e
MIA=${MIA:-/tmp/refsrc/src/mia}
FIX=$(dirname "$0")/../tests/fixtures
OUT=$(dirname "$0")/../tests/golden
MAT=/tmp/refsrc/share/matrices

run() {
  name=$1; shift
  mkdir -p "$OUT/$name" && rm -f "$OUT/$name"/*
  tmp=$(mktemp -d)
  (cd "$tmp" && "$MIA" "$@" -m out.maln >/dev/null 2>&1)
  cp "$tmp"/out.maln.* "$OUT/$name/"
  rm -rf "$tmp"
}

run default  -r "$FIX/tr1.fna" -f "$FIX/tf.fna"
run circular -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -c
run hp       -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -h
run trim     -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -T
run kmer     -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -k 12
run p2       -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -p 2
run fastq_UC -r "$FIX/tr1.fna" -f "$FIX/tf.fastq" -U -C2
run distant  -r "$FIX/tr1_distant.fna" -f "$FIX/tf.fna" -D
run sim200   -r "$FIX/mt_sim.fna" -f "$FIX/sim200.fastq" -c -s "$MAT/ancient.submat.txt" -k 12 -u
echo "goldens regenerated"

# dedup/id/cutoff/adapter flag coverage
run hp_k       -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -h -k 12
run A454       -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -T -u -A
run softmask_k -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -M -k 12
run idlist     -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -I "$FIX/ids.txt" -u
run scoreline  -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -u -S 8 -N -300
run adapter    -r "$FIX/tr1.fna" -f "$FIX/tf.fna" -T -a GGCCTTGGAA
