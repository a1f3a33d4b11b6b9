#!/bin/bash
# Repeat-rich parity config: 500kb genome with 12 identical 3kb repeat
# copies + 4 coverage-dip windows (85% of fragments displaced), 60k
# PE250 pairs, K=200.  Exercises Unsat clustering + overlap merges,
# AssembleGaps2 blobs, Patch/AddNewStuff and PathFinder — the paths a
# clean random genome never touches.
#
# Verified 2026-08-19 (round 2): VERDICT: BIT-IDENTICAL CONTIG SETS
# (26 contigs; 14 >= 1kb totalling 471,655 bp, N50 35,856 — exact
# canonical match on every contig).
set -e
OUT=${1:-/tmp/rep}
python scripts/make_synth_fastq.py $OUT --glen 500000 --pairs 60000 \
    --rlen 250 --insert 500 --repeats 12 --repeat_len 3000 --dips 4 --seed 7
mkdir -p $OUT/ref_out $OUT/our_out
/tmp/w2rap_o2/bin/w2rap-contigger -r $OUT/reads_R1.fastq,$OUT/reads_R2.fastq \
    -o $OUT/ref_out -p pe -K 200 -t 8
python -m w2rap_contigger_tpu -r $OUT/reads_R1.fastq,$OUT/reads_R2.fastq \
    -o $OUT/our_out -p pe -K 200 -t 16
python scripts/compare_contigs.py $OUT/our_out/a.lines.fasta $OUT/ref_out/a.lines.fasta
