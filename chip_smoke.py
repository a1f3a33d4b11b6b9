#!/usr/bin/env python3
"""Smoke test of the assembler on one GPU.

    python chip_smoke.py            # one card
    python chip_smoke.py --multi    # steps 2-3 sharded over four cards

Phases (each fails loudly; any failure exits non-zero):
  a. the card's name and power limit, and the JAX devices;
  b. the north-star reads: a 4.6 Mbp genome, 550k PE250 pairs (30x),
     seed 42 (scripts/make_synth_fastq.py);
  c. the CLI on the card (-K 260 --dump_perf --shard 0) in a child
     process: TIME lines, stats, the device's peak memory;
  d. the device count against the native C++ counter on the same reads,
     bit-equal (k=60 through count_kmers_device, K=260 through
     count_kmers_flat), and the time of three ways of counting them:
     whole-stream device count, chunked count_kmers, native spill;
  e. the contig set against tests/golden/ecoli_4p6M_K260.json.
With --multi only a, b and the CLI with --shard 4 (the all-to-all count
of parallel/mesh.py) run, checked against the same golden digest.

The card is held by one process at a time: the parent opens it only
after the CLI child has exited.  The last line of standard output is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "ecoli_4p6M_K260.json")
READS = dict(glen=4_600_000, pairs=550_000, rlen=250, insert=500, seed=42)
LARGE_K = 260
FLAT_SEG, FLAT_STEP = 1000, 250  # K=260 comparison: genome tiles
NATIVE_LIBS = (
    ("w2rapio", ["fastq_loader.cc"], ["z"]),
    ("w2rapcount", ["count_kernel.cc"], ["pthread"]),
    ("w2rapgraph", ["graph_kernel.cc"], ["pthread"]),
    ("w2rappath", ["path_kernel.cc"], ["pthread"]),
)


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def run(cmd, env=None):
    """Run a child, echo its output, fail on a non-zero exit."""
    t0 = time.time()
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True)
    sys.stdout.write(p.stdout)
    sys.stderr.write(p.stderr[-20000:])
    check(p.returncode == 0, f"{cmd[:4]} exited {p.returncode}")
    return p.stdout, time.time() - t0


def probe_devices():
    """Platform, kind and count of the JAX devices, asked of a child so
    that this process does not hold the card while the CLI runs."""
    out, _ = run([sys.executable, "-c",
                  "import json, jax; d = jax.devices(); print(json.dumps("
                  "[d[0].platform, d[0].device_kind, len(d)]))"])
    platform, kind, count = json.loads(out.strip().splitlines()[-1])
    print(f"jax devices: {count} x {kind} ({platform})")
    check(platform != "cpu", "JAX found no accelerator")
    return {"platform": platform, "kind": kind, "count": count}


def phase_card():
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True,
        )
    except FileNotFoundError:
        raise SmokeFailure("nvidia-smi not found") from None
    check(p.returncode == 0, "nvidia-smi failed")
    print(p.stdout.strip().splitlines()[0])


def phase_reads(work, reads=READS):
    _, secs = run([
        sys.executable, "scripts/make_synth_fastq.py", work,
        "--glen", str(reads["glen"]), "--pairs", str(reads["pairs"]),
        "--rlen", str(reads["rlen"]), "--insert", str(reads["insert"]),
        "--seed", str(reads["seed"]),
    ])
    print(f"reads: {reads} in {secs:.1f}s")


# the CLI entry point, then the device's peak memory
CLI_CHILD = """
import runpy, sys
sys.argv = ["w2rap_contigger_tpu"] + sys.argv[1:]
runpy.run_module("w2rap_contigger_tpu", run_name="__main__")
import jax
stats = jax.devices()[0].memory_stats() or {}
print("peak_device_bytes", stats.get("peak_bytes_in_use", "not measured"))
"""


def phase_cli(work, out, shard):
    env = dict(os.environ, W2RAP_TIMELOG="1")
    os.makedirs(out, exist_ok=True)
    _, secs = run([
        sys.executable, "-c", CLI_CHILD,
        "-r", f"{work}/reads_R1.fastq,{work}/reads_R2.fastq", "-o", out,
        "-p", "pe", "-K", str(LARGE_K), "--dump_perf", "--shard", str(shard),
    ], env=env)
    print(f"cli --shard {shard}: {secs:.1f}s wall")
    with open(f"{out}/pe.perf") as f:
        sys.stdout.write(f.read())
    with open(f"{out}/stats") as f:
        sys.stdout.write(f.read())


def phase_golden(out):
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from compare_contigs import contig_digest, read_fasta

    got = contig_digest(read_fasta(f"{out}/a.lines.fasta"))
    with open(GOLDEN) as f:
        want = json.load(f)
    want = {key: want[key] for key in got}
    print(f"contig digest {got}")
    check(got == want, f"contig set differs from the golden {want}")
    print("contig set: MATCHES GOLDEN DIGEST")


def same_dict(a, b, what):
    import numpy as np

    for field in ("words", "counts", "ctx"):
        x, y = getattr(a, field), getattr(b, field)
        check(x.shape == y.shape and np.array_equal(x, y),
              f"{what}: {field} differ")


def timed(fn):
    t0 = time.time()
    r = fn()
    return r, time.time() - t0


def genome_tiles(work, seg=FLAT_SEG, step=FLAT_STEP):
    """Overlapping genome windows as a flat sequence stream."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from compare_contigs import read_fasta

    from w2rap_contigger_tpu.core import dna

    g = dna.seq_to_codes(read_fasta(f"{work}/genome.fasta")[0])
    starts = np.arange(0, len(g) - seg + 1, step)
    flat = g[starts[:, None] + np.arange(seg)[None, :]].reshape(-1)
    offsets = np.arange(len(starts) + 1, dtype=np.int64) * seg
    return flat, offsets


def phase_counts(work, out, k=60, min_freq=4):
    """Device count vs native counter (bit-equal) and the three-way
    count timing, on the reads step 1 stored."""
    import jax
    import numpy as np

    from w2rap_contigger_tpu import native
    from w2rap_contigger_tpu.core.reads import ReadSet
    from w2rap_contigger_tpu.ops import bitkmer as bk
    from w2rap_contigger_tpu.ops import kmer_engine as ke

    for name, srcs, libs in NATIVE_LIBS:
        check(native.load(name, srcs, libs) is not None,
              f"native library {name} did not build or load")
    print(f"native libraries loaded: {[n for n, _, _ in NATIVE_LIBS]}")

    reads = ReadSet.load(f"{out}/frag_reads_orig.npz")
    b, ln, q = reads.bases, reads.lengths, reads.quals
    W = bk.nwords(k)
    lib = ke._native_count_lib(force=True)

    (d_nat, h_nat), t_nat = timed(lambda: ke._count_kmers_spill_native(
        lib, b, ln, q, k, W, 7, min_freq, 2, None))

    def device_count():
        d, h = ke.count_kmers_device(b, ln, q, k, min_freq=min_freq)
        jax.block_until_ready(d.dev["words"])
        return d, h

    (d_dev, h_dev), t_dev_first = timed(device_count)
    (d_dev, h_dev), t_dev = timed(device_count)
    same_dict(d_dev, d_nat, f"k={k} device count vs native")
    check(np.array_equal(h_dev, h_nat), f"k={k} histogram differs")
    print(f"k={k}: {d_nat.size} kmers with count >= {min_freq}, "
          f"{int(h_nat.sum())} distinct; device count BIT-EQUAL to native")

    (d_chk, h_chk), t_chunk = timed(
        lambda: ke.count_kmers(b, ln, q, k, min_freq=min_freq))
    same_dict(d_chk, d_nat, f"k={k} chunked count vs native")
    check(np.array_equal(h_chk, h_nat), f"k={k} chunked histogram differs")
    print(f"count k={k} {reads.n_reads} reads: device whole-stream "
          f"{t_dev:.2f}s (first call {t_dev_first:.2f}s), chunked "
          f"count_kmers {t_chunk:.2f}s, native spill {t_nat:.2f}s")

    flat, seg = genome_tiles(work)
    d_fn, t_fn = timed(lambda: ke.count_kmers_flat(
        flat, seg, LARGE_K, min_freq=1, host=True))
    d_fd, t_fd_first = timed(lambda: ke.count_kmers_flat(
        flat, seg, LARGE_K, min_freq=1))
    d_fd, t_fd = timed(lambda: ke.count_kmers_flat(
        flat, seg, LARGE_K, min_freq=1))
    same_dict(d_fd, d_fn, f"K={LARGE_K} flat device count vs native")
    print(f"K={LARGE_K} flat: {len(seg) - 1} segments, {d_fn.size} kmers; "
          f"device {t_fd:.2f}s (first call {t_fd_first:.2f}s), native "
          f"{t_fn:.2f}s; BIT-EQUAL")

    dev = jax.devices()
    return {"platform": dev[0].platform, "kind": dev[0].device_kind,
            "count": len(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the CLI with --shard 4 over four cards and "
                         "check its contig set; no other phase")
    args = ap.parse_args(argv)

    check(os.path.isdir(os.path.join(ROOT, "w2rap_contigger_tpu"))
          and os.path.exists(GOLDEN),
          "chip_smoke.py must run from a checkout of the repository")
    device = probe_devices()
    phase_card()
    if args.multi:
        check(device["count"] >= 4, "--multi needs four cards")
    work = tempfile.mkdtemp(prefix="w2rap_smoke_")
    try:
        phase_reads(work)
        out = f"{work}/out"
        if args.multi:
            phase_cli(work, out, shard=4)
            phase_golden(out)
        else:
            phase_cli(work, out, shard=0)
            phase_golden(out)
            device = phase_counts(work, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
