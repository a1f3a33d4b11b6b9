"""End-to-end pipeline test: simulated PE reads from a synthetic genome
-> all 7 steps -> contigs that reconstruct the genome."""

import os

import numpy as np
import pytest

from w2rap_contigger_tpu.core import dna
from w2rap_contigger_tpu.core.reads import ReadSet
from w2rap_contigger_tpu.pipeline.driver import run_pipeline


def simulate_pe_reads(rng, genome, n_pairs, rlen=100, insert=300, err=0.003):
    """Innie PE pairs, interleaved (2i fwd, 2i+1 rc of the far end)."""
    glen = len(genome)
    seqs, quals = [], []
    for _ in range(n_pairs):
        s = int(rng.integers(0, glen - insert))
        frag = genome[s : s + insert]
        r1 = frag[:rlen].copy()
        r2 = dna.revcomp_codes(frag[-rlen:])
        for r in (r1, r2):
            if err > 0:
                m = rng.random(rlen) < err
                r[m] = (r[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
            seqs.append(r)
            quals.append(np.full(rlen, 35, dtype=np.uint8))
    return ReadSet.from_sequences(seqs, quals)


@pytest.fixture(scope="module")
def genome_and_reads():
    rng = np.random.default_rng(7)
    genome = rng.integers(0, 4, size=20000).astype(np.uint8)
    reads = simulate_pe_reads(rng, genome, n_pairs=4000)  # 40x coverage
    return genome, reads


def read_contigs(path):
    with open(path) as f:
        contigs = []
        cur = []
        for line in f:
            if line.startswith(">"):
                if cur:
                    contigs.append("".join(cur))
                    cur = []
            else:
                cur.append(line.strip())
        if cur:
            contigs.append("".join(cur))
    return contigs


def test_full_pipeline(tmp_path, genome_and_reads):
    genome, reads = genome_and_reads
    out = str(tmp_path)
    hbv, paths = run_pipeline(
        out_dir=out,
        reads=reads,
        large_k=100,
        min_freq=4,
        min_qual=7,
        dump_all=True,
        chunk_reads=2048, shard_devices=0,
    )
    # outputs exist
    for f in ["a.lines.fasta", "stats", "a_contigs_raw.gfa", "pe_assembly_raw.gfa"]:
        assert os.path.exists(f"{out}/{f}"), f
    # contigs cover the genome: total length close to genome size and the
    # longest contig spans a large fraction
    contigs = read_contigs(f"{out}/a.lines.fasta")
    assert contigs, "no contigs written"
    total = sum(len(c) for c in contigs)
    longest = max(len(c) for c in contigs)
    assert total >= 0.9 * len(genome), f"total contig bases {total}"
    assert longest >= 0.5 * len(genome), f"longest contig {longest}"
    # every long contig piece (split at step-7 scaffold N-gaps) must be a
    # substring of the genome (or its rc)
    gstr = dna.codes_to_seq(genome)
    grc = dna.codes_to_seq(dna.revcomp_codes(genome))
    for c in contigs:
        for piece in c.split("N"):
            if len(piece) >= 2000:
                assert piece in gstr or piece in grc, (
                    "contig piece not a genome substring"
                )


def test_device_path_matches_host_path(tmp_path, genome_and_reads,
                                       monkeypatch):
    """The device forms of steps 2-3 (whole-stream count, device-resident
    dictionary, pointer-doubling unitigs, device pathing), run here on
    the CPU by making the backend rule see a GPU, give the host path's
    contig set."""
    import jax

    _, reads = genome_and_reads
    sets = []
    for backend in ("cpu", "gpu"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        out = str(tmp_path / backend)
        run_pipeline(out_dir=out, reads=reads, large_k=100, min_freq=4,
                     min_qual=7, chunk_reads=2048, shard_devices=0)
        sets.append(sorted(read_contigs(f"{out}/a.lines.fasta")))
    assert sets[0] and sets[0] == sets[1]


def test_checkpoint_resume(tmp_path, genome_and_reads):
    genome, reads = genome_and_reads
    out = str(tmp_path)
    run_pipeline(
        out_dir=out, reads=reads, large_k=100, to_step=3, dump_all=True,
        chunk_reads=2048, shard_devices=0,
    )
    # resume from step 4
    hbv, paths = run_pipeline(
        out_dir=out, reads=reads, large_k=100, from_step=4, chunk_reads=2048,
        shard_devices=0,
    )
    assert os.path.exists(f"{out}/a.lines.fasta")


def test_full_pipeline_k128(tmp_path, genome_and_reads):
    """K % 16 == 0 end-to-end (the reference allows 10 such K values,
    w2rap-contigger.cc:60-62; the canonical dictionary makes the
    all-ones sentinel row unreachable for any k)."""
    genome, reads = genome_and_reads
    out = str(tmp_path)
    run_pipeline(
        out_dir=out, reads=reads, large_k=128, min_freq=4, min_qual=7,
        chunk_reads=2048, shard_devices=0,
    )
    with open(f"{out}/a.lines.fasta") as f:
        contigs = [l.strip() for l in f if not l.startswith(">")]
    total = sum(len(c) for c in contigs)
    assert total >= 0.9 * len(genome)


def test_full_pipeline_k200(tmp_path):
    """Production-K end-to-end (the BASELINE configs use K=200/260;
    in-suite coverage so large-K regressions surface before parity runs)."""
    rng = np.random.default_rng(11)
    genome = rng.integers(0, 4, size=20000).astype(np.uint8)
    reads = simulate_pe_reads(rng, genome, n_pairs=1500, rlen=250, insert=500)
    out = str(tmp_path)
    run_pipeline(
        out_dir=out, reads=reads, large_k=200, min_freq=4, min_qual=7,
        chunk_reads=2048, shard_devices=0,
    )
    with open(f"{out}/a.lines.fasta") as f:
        contigs = [l.strip() for l in f if not l.startswith(">")]
    total = sum(len(c) for c in contigs)
    assert total >= 0.9 * len(genome)
    gstr = dna.codes_to_seq(genome)
    grc = dna.codes_to_seq(dna.revcomp_codes(genome))
    for c in contigs:
        for piece in c.split("N"):
            if len(piece) >= 2000:
                assert piece in gstr or piece in grc
