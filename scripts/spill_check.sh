#!/bin/bash
# Routine spill-path exercise (VERDICT r4 ask #8): run steps 1-2 at
# north-star scale twice — forced hash-range disk batching (-d 4 -m 4,
# the createDictOMPDiskBased analogue) vs the unbatched default — and
# assert the resulting small-K graph + read paths are bit-identical.
#
#   bash scripts/spill_check.sh [DATA_DIR] [OUT_DIR]
#
# DATA_DIR must contain reads_R1.fastq/reads_R2.fastq (defaults to the
# north-star dataset at /tmp/ecoli; generate with
#   python scripts/make_synth_fastq.py /tmp/ecoli --glen 4600000 \
#       --pairs 550000 --rlen 250 --insert 500 ).
set -e
DATA=${1:-/tmp/ecoli}
OUT=${2:-/tmp/spill_check}
rm -rf $OUT && mkdir -p $OUT/batched $OUT/plain
export JAX_PLATFORMS=${JAX_PLATFORMS:-cpu}
python -u -m w2rap_contigger_tpu -r $DATA/reads_R1.fastq,$DATA/reads_R2.fastq \
    -o $OUT/batched -p pe -K 260 --to_step 2 -d 4 -m 4 \
    --tmp_dir $OUT/tmp --dump_perf
python -u -m w2rap_contigger_tpu -r $DATA/reads_R1.fastq,$DATA/reads_R2.fastq \
    -o $OUT/plain -p pe -K 260 --to_step 2 --dump_perf
python - "$OUT" << 'EOF'
import sys

import numpy as np

out = sys.argv[1]
for f in ("pe.small_K.hbv.npz", "pe.small_K.paths.npz"):
    a = np.load(f"{out}/batched/{f}")
    b = np.load(f"{out}/plain/{f}")
    assert set(a.files) == set(b.files), f
    for key in a.files:
        assert np.array_equal(a[key], b[key]), f"{f}:{key} differs"
print("SPILL CHECK: batched (-d 4 -m 4) steps 1-2 BIT-IDENTICAL to unbatched")
EOF
grep TIME $OUT/batched/pe.perf $OUT/plain/pe.perf
