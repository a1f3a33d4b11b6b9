#!/bin/bash
# North-star run (BASELINE.json): E. coli-scale synthetic genome
# (4.6Mbp, 550k PE250 pairs = 30x, seed 42) at K=260, reference vs this
# build, contig-set equality + per-step timing.  Without the reference
# binary, check the contig set against the recorded golden digest:
#   python scripts/compare_contigs.py --golden tests/golden/ecoli_4p6M_K260.json \
#       $OUT/our_out/a.lines.fasta
#
# Verified 2026-08-19 (round 2): VERDICT: BIT-IDENTICAL CONTIG SETS
# (1 contig, 4599920 bp on both sides).
set -e
OUT=${1:-/tmp/ecoli}
python scripts/make_synth_fastq.py $OUT --glen 4600000 --pairs 550000 --rlen 250 --insert 500
mkdir -p $OUT/ref_out $OUT/our_out
/tmp/w2rap_o2/bin/w2rap-contigger -r $OUT/reads_R1.fastq,$OUT/reads_R2.fastq -o $OUT/ref_out -p pe -K 260 -t 8 --dump_perf 1
python -m w2rap_contigger_tpu -r $OUT/reads_R1.fastq,$OUT/reads_R2.fastq -o $OUT/our_out -p pe -K 260 -t 16 --dump_perf
python scripts/compare_contigs.py $OUT/our_out/a.lines.fasta $OUT/ref_out/a.lines.fasta
