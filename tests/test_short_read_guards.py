"""Regression tests for the K > read-length class of crashes.

The 16Mbp scale run (round 4) died with `reshape new_sizes must all be
positive, got (-589824, 0)` — a 65536-row chunk kmerized at
P = 250 - 260 + 1 = -9: counting/pathing entry points must return empty
results when reads are shorter than k instead of reshaping to a
negative position count (reference kmerizers simply emit nothing,
BuildReadQGraph.cc:1062-1081).
"""

import numpy as np
import pytest

from w2rap_contigger_tpu.core.reads import ReadSet
from w2rap_contigger_tpu.ops import kmer_engine as ke


@pytest.fixture(scope="module")
def short_reads():
    rng = np.random.default_rng(3)
    seqs = [rng.integers(0, 4, size=250).astype(np.uint8) for _ in range(64)]
    return ReadSet.from_sequences(seqs)


def test_count_kmers_k_above_read_len(short_reads):
    r = short_reads
    d, hist = ke.count_kmers(r.bases, r.lengths, r.quals, 260, min_freq=1)
    assert d.size == 0 and hist.sum() == 0


def test_count_kmers_device_k_above_read_len(short_reads):
    r = short_reads
    d, hist = ke.count_kmers_batched(
        r.bases, r.lengths, r.quals, 260, min_freq=1, force_device=True
    )
    assert d.size == 0 and hist.sum() == 0


def test_count_kmers_sharded_k_above_read_len(short_reads):
    import jax

    from w2rap_contigger_tpu.parallel import mesh as pmesh

    r = short_reads
    mesh = pmesh.make_mesh(len(jax.devices()))
    d, hist = pmesh.count_kmers_sharded(
        r.bases, r.lengths, r.quals, 260, mesh
    )
    assert d.size == 0 and hist.sum() == 0


def test_path_reads_k_above_read_len(short_reads):
    """add_new_stuff-style re-pathing at K=260 over 250bp reads."""
    from w2rap_contigger_tpu.graph import build as gb
    from w2rap_contigger_tpu.paths import pather

    rng = np.random.default_rng(4)
    k = 260
    edge = rng.integers(0, 4, size=800).astype(np.uint8)
    seg = np.array([0, len(edge)], dtype=np.int64)
    d = ke.count_kmers_flat(edge, seg, k, min_freq=1)
    gb.recompute_adjacencies(d)
    eb, es = gb.build_unitigs(d)
    hbv, fx, rx = gb.build_hbv_from_edges(eb, es, k)
    paths = pather.path_reads(short_reads, d, hbv, fx, rx)
    assert paths.n_reads == short_reads.n_reads
    assert len(paths.edges) == 0


def test_raw_parts_k_above_read_len(short_reads):
    from w2rap_contigger_tpu.graph import build as gb, gapfill

    rng = np.random.default_rng(5)
    k = 260
    edge = rng.integers(0, 4, size=800).astype(np.uint8)
    seg = np.array([0, len(edge)], dtype=np.int64)
    d = ke.count_kmers_flat(edge, seg, k, min_freq=1)
    gb.recompute_adjacencies(d)
    eb, es = gb.build_unitigs(d)
    out = gapfill._raw_parts(short_reads, d, es)
    assert all(len(a) == 0 for a in out)


def test_lookup_core_raises_clearly():
    import jax.numpy as jnp

    from w2rap_contigger_tpu.paths import pather

    with pytest.raises(ValueError, match="L >= k"):
        pather._lookup_core(
            jnp.zeros((4, 16), jnp.uint32), jnp.zeros(4, jnp.int32),
            jnp.zeros((1, 8), jnp.uint32), jnp.zeros(8, jnp.int32),
            jnp.zeros(8, jnp.int32), jnp.zeros(8, jnp.uint8),
            jnp.zeros(4, jnp.int32), jnp.zeros(4, jnp.int32),
            jnp.zeros(4, jnp.int32), k=260, n_iters=3, L=250,
        )
