#!/bin/bash
# FILL_JOIN parity config (VERDICT r3 missing #6): the reference with
# its hardcoded FILL_JOIN flag flipped to True (source copied to /tmp
# and rebuilt at -O2) vs this build's --fill_join, on a gappy config
# that gives fillGaps/joinOverlaps real work: low coverage (12x) so
# the small-K graph has captured gaps.
#
#   bash scripts/parity_filljoin.sh /tmp/parity_fj [FJ_BINARY]
set -e
OUT=${1:-/tmp/parity_fj}
BIN=${2:-/tmp/w2rap_fj/bin/w2rap-contigger}
python scripts/make_synth_fastq.py $OUT --glen 200000 --pairs 10000 \
    --rlen 250 --insert 500 --seed 11
mkdir -p $OUT/ref_out $OUT/our_out
$BIN -r $OUT/reads_R1.fastq,$OUT/reads_R2.fastq -o $OUT/ref_out -p pe -K 200 -t 8
JAX_PLATFORMS=${JAX_PLATFORMS:-cpu} python -m w2rap_contigger_tpu \
    -r $OUT/reads_R1.fastq,$OUT/reads_R2.fastq -o $OUT/our_out -p pe -K 200 \
    --fill_join
python scripts/compare_contigs.py $OUT/our_out/a.lines.fasta $OUT/ref_out/a.lines.fasta
