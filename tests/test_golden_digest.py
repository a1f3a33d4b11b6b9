"""The contig-set digest that golden files record (scripts/compare_contigs.py)."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from compare_contigs import contig_digest  # noqa: E402


def test_digest_ignores_order_and_orientation():
    a = contig_digest(["ACGTTGCA", "GGGATC"])
    # same set: reordered, second contig reverse-complemented
    b = contig_digest(["GATCCC", "ACGTTGCA"])
    assert a == b
    assert a["n_contigs"] == 2 and a["total_bp"] == 14


def test_digest_sees_one_base():
    a = contig_digest(["ACGTTGCA", "GGGATC"])
    assert contig_digest(["ACGTTGCA", "GGGATA"])["sha256"] != a["sha256"]
    assert contig_digest(["ACGTTGCA"]) != a


def test_golden_file_is_a_digest():
    with open(os.path.join(ROOT, "tests", "golden",
                           "ecoli_4p6M_K260.json")) as f:
        g = json.load(f)
    assert g["n_contigs"] >= 1 and g["total_bp"] > 4_000_000
    assert len(g["sha256"]) == 64 and int(g["sha256"], 16) >= 0
