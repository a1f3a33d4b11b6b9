"""Compare two assemblies as canonical contig sequence sets, or one
assembly with a recorded golden digest.

The BASELINE.json north star is sequence-set equality of a.lines.fasta
against the reference.  Usage:
    python scripts/compare_contigs.py ours.fasta theirs.fasta [--min-len N]
    python scripts/compare_contigs.py ours.fasta --golden golden.json
    python scripts/compare_contigs.py ours.fasta          # print digest
The first prints per-set stats, the overlap (exact canonical matches),
and containment (contigs that are substrings of the other assembly).
The others use contig_digest over every contig (no length cut).

tests/golden/ecoli_4p6M_K260.json was recorded from the CPU path
(JAX_PLATFORMS=cpu) of the tree that round 5 verified bit-identical to
the reference: make_synth_fastq.py --glen 4600000 --pairs 550000
--rlen 250 --insert 500 --seed 42, then the CLI with -K 260 --shard 0,
then this script's digest mode on a.lines.fasta.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from w2rap_contigger_tpu.core import dna  # noqa: E402


def read_fasta(path):
    seqs = []
    cur = []
    with open(path) as f:
        for line in f:
            if line.startswith(">"):
                if cur:
                    seqs.append("".join(cur))
                    cur = []
            else:
                cur.append(line.strip().upper())
    if cur:
        seqs.append("".join(cur))
    return seqs


def canon(s):
    rc = s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))
    return min(s, rc)


def contig_digest(seqs):
    """Digest of a contig set: count, total bp and the SHA-256 of the
    sorted canonical sequences joined by newlines, so it depends on
    neither contig order nor orientation."""
    cs = sorted(canon(s) for s in seqs)
    return {
        "n_contigs": len(cs),
        "total_bp": sum(len(s) for s in cs),
        "sha256": hashlib.sha256("\n".join(cs).encode()).hexdigest(),
    }


def n50(lens):
    ls = sorted(lens, reverse=True)
    total = sum(ls)
    c = 0
    for l in ls:
        c += l
        if 2 * c >= total:
            return l
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ours")
    ap.add_argument("theirs", nargs="?")
    ap.add_argument("--min-len", type=int, default=1000)
    ap.add_argument("--golden", help="golden digest JSON to check against")
    args = ap.parse_args()

    if args.theirs is None:
        got = contig_digest(read_fasta(args.ours))
        print(json.dumps(got))
        if args.golden:
            with open(args.golden) as f:
                want = json.load(f)
            want = {key: want[key] for key in got}
            if got != want:
                print(f"VERDICT: DIGEST MISMATCH (golden {want})")
                sys.exit(1)
            print("VERDICT: MATCHES GOLDEN DIGEST")
        return

    a = [s for s in read_fasta(args.ours) if len(s) >= args.min_len]
    b = [s for s in read_fasta(args.theirs) if len(s) >= args.min_len]
    ca = {canon(s) for s in a}
    cb = {canon(s) for s in b}
    print(f"ours:   {len(a)} contigs >= {args.min_len}bp, "
          f"{sum(len(s) for s in a)} bp, N50 {n50([len(s) for s in a])}")
    print(f"theirs: {len(b)} contigs >= {args.min_len}bp, "
          f"{sum(len(s) for s in b)} bp, N50 {n50([len(s) for s in b])}")
    inter = ca & cb
    print(f"exact canonical matches: {len(inter)} "
          f"({sum(len(s) for s in inter)} bp)")
    only_a = ca - cb
    only_b = cb - ca
    # containment: our unmatched contigs contained in one of theirs
    big_b = "|".join(cb)
    contained = sum(1 for s in only_a if s in big_b or canon(s) in big_b)
    print(f"ours-only: {len(only_a)} (of which {contained} contained in theirs)")
    big_a = "|".join(ca)
    contained_b = sum(1 for s in only_b if s in big_a or canon(s) in big_a)
    print(f"theirs-only: {len(only_b)} (of which {contained_b} contained in ours)")
    if ca == cb:
        print("VERDICT: BIT-IDENTICAL CONTIG SETS")
    else:
        jac = len(inter) / max(1, len(ca | cb))
        print(f"VERDICT: jaccard {jac:.3f}")


if __name__ == "__main__":
    main()
