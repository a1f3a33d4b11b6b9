"""Kmer engine parity tests against a brute-force python counter that
follows the reference semantics (BuildReadQGraph.cc:962-1110) literally."""

import numpy as np
import pytest

from w2rap_contigger_tpu.core import dna
from w2rap_contigger_tpu.ops import bitkmer as bk
from w2rap_contigger_tpu.ops import kmer_engine as ke
from w2rap_contigger_tpu.ops import lookup


def brute_good_length(quals, length, k, min_qual):
    """Literal transcription of count_good_lengths semantics."""
    good = 0
    for i in range(length - 1, -1, -1):
        if quals[i] < min_qual:
            good = 0
        else:
            good += 1
            if good == k:
                return i + k
    return 0


def brute_count(bases, lengths, quals, k, min_qual):
    """Canonical kmer -> [count, ctx] with per-occurrence canonical ctx."""
    table = {}
    n = bases.shape[0]
    for r in range(n):
        glen = brute_good_length(quals[r], int(lengths[r]), k, min_qual)
        if glen <= k:
            continue
        codes = bases[r][:glen]
        for p in range(glen - k + 1):
            kmer = codes[p : p + k]
            ctx = 0
            if p > 0:
                ctx |= (1 << int(codes[p - 1])) << 4
            if p + k < glen:
                ctx |= 1 << int(codes[p + k])
            canon, was_rc = dna.canonical_codes(kmer)
            if was_rc:
                pred = (ctx >> 4) & 0xF
                succ = ctx & 0xF

                def rcb(b):
                    return (
                        ((b & 1) << 3)
                        | ((b & 2) << 1)
                        | ((b & 4) >> 1)
                        | ((b & 8) >> 3)
                    )

                ctx = (rcb(succ) << 4) | rcb(pred)
            key = canon.tobytes()
            if key not in table:
                table[key] = [0, 0]
            table[key][0] = min(255, table[key][0] + 1)
            table[key][1] |= ctx
    return table


def make_reads(rng, n, L, with_quals=True):
    bases = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    lengths = rng.integers(L // 2, L + 1, size=n).astype(np.int32)
    if with_quals:
        quals = rng.integers(0, 41, size=(n, L)).astype(np.uint8)
    else:
        quals = np.full((n, L), 35, dtype=np.uint8)
    return bases, lengths, quals


def test_good_lengths_matches_reference(rng):
    k, min_qual = 9, 7
    bases, lengths, quals = make_reads(rng, 200, 60)
    # make some quals low so runs break
    quals = np.where(rng.random((200, 60)) < 0.3, 3, quals).astype(np.uint8)
    import jax.numpy as jnp

    got = np.asarray(
        ke.good_lengths(jnp.asarray(quals), jnp.asarray(lengths), k, min_qual)
    )
    for i in range(200):
        assert got[i] == brute_good_length(quals[i], int(lengths[i]), k, min_qual)


@pytest.mark.parametrize("k", [9, 31, 60])
def test_count_kmers_parity(rng, k):
    L = max(40, k + 20)
    bases, lengths, quals = make_reads(rng, 300, L)
    quals = np.where(rng.random((300, L)) < 0.15, 3, quals).astype(np.uint8)
    # duplicate some reads to get counts > 1
    bases = np.concatenate([bases, bases[:100]], axis=0)
    lengths = np.concatenate([lengths, lengths[:100]])
    quals = np.concatenate([quals, quals[:100]], axis=0)

    d, hist = ke.count_kmers(
        bases, lengths, quals, k, min_qual=7, min_freq=1, chunk_reads=64, pad_quantum=1024
    )
    expect = brute_count(bases, lengths, quals, k, 7)

    got_keys = [
        bk.unpack_words(d.words[i], k).tobytes() for i in range(d.size)
    ]
    assert len(got_keys) == len(expect), (len(got_keys), len(expect))
    # sorted canonical order must match sorted byte order of code strings
    assert got_keys == sorted(expect.keys())
    for i, key in enumerate(got_keys):
        assert int(d.counts[i]) == expect[key][0], f"count mismatch @{i}"
        assert int(d.ctx[i]) == expect[key][1], f"ctx mismatch @{i}"
    # histogram totals
    assert hist.sum() == len(expect)


def test_count_kmers_min_freq_filter(rng):
    k = 15
    bases, lengths, quals = make_reads(rng, 50, 40, with_quals=False)
    bases = np.concatenate([bases] * 5, axis=0)  # every kmer count >= 5
    lengths = np.concatenate([lengths] * 5)
    quals = np.concatenate([quals] * 5, axis=0)
    d_all, _ = ke.count_kmers(bases, lengths, quals, k, min_freq=1, pad_quantum=1024)
    d_filt, _ = ke.count_kmers(bases, lengths, quals, k, min_freq=5, pad_quantum=1024)
    assert d_filt.size <= d_all.size
    assert np.all(d_filt.counts >= 5)
    # every count-5 kmer of d_all survives
    assert d_filt.size == int(np.sum(d_all.counts >= 5))


def test_lookup_words(rng):
    k = 60
    codes = rng.integers(0, 4, size=(500, k)).astype(np.uint8)
    words = bk.pack_codes(codes, k)
    # sort rows lexicographically via bytes
    order = np.argsort([w.tobytes() for w in words.astype(">u4")])
    table = words[order]
    idx, found = lookup.lookup_words(table, table[::7])
    assert bool(np.all(np.asarray(found)))
    np.testing.assert_array_equal(np.asarray(idx), np.arange(500)[::7])
    # queries not in table
    other = bk.pack_codes(rng.integers(0, 4, size=(64, k)).astype(np.uint8), k)
    in_table = np.array(
        [o.tobytes() in {t.tobytes() for t in table} for o in other]
    )
    _, found2 = lookup.lookup_words(table, other)
    np.testing.assert_array_equal(np.asarray(found2), in_table)


@pytest.mark.parametrize("k", [31, 60])
def test_count_kmers_device_parity(rng, k):
    """The on-device pipeline (one sort + collapse_planes, run here on
    the CPU) must reproduce count_kmers exactly: same dict, counts,
    contexts, hist."""
    L = k + 25
    bases, lengths, quals = make_reads(rng, 200, L)
    quals = np.where(rng.random((200, L)) < 0.1, 3, quals).astype(np.uint8)
    bases = np.concatenate([bases, bases[:80]], axis=0)
    lengths = np.concatenate([lengths, lengths[:80]])
    quals = np.concatenate([quals, quals[:80]], axis=0)

    ref_d, ref_hist = ke.count_kmers(
        bases, lengths, quals, k, min_qual=7, min_freq=2, chunk_reads=64
    )
    dev_d, dev_hist = ke.count_kmers_device(
        bases, lengths, quals, k, min_qual=7, min_freq=2,
        chunk_reads=128,
    )
    np.testing.assert_array_equal(dev_d.words, ref_d.words)
    np.testing.assert_array_equal(dev_d.counts, ref_d.counts)
    np.testing.assert_array_equal(dev_d.ctx, ref_d.ctx)
    np.testing.assert_array_equal(dev_hist, ref_hist)


def test_count_kmers_device_range_partition(rng):
    """Hash-range slices partition the dictionary exactly."""
    k = 31
    bases, lengths, quals = make_reads(rng, 150, 60, with_quals=False)
    full_d, _ = ke.count_kmers(bases, lengths, quals, k, min_freq=1)
    parts = []
    for ri in range(4):
        d, _ = ke.count_kmers_device(
            bases, lengths, quals, k, min_freq=1,
            range_bits=2, range_index=ri,
        )
        parts.append(d)
    words = np.concatenate([p.words for p in parts], axis=0)
    counts = np.concatenate([p.counts for p in parts])
    np.testing.assert_array_equal(words, full_d.words)
    np.testing.assert_array_equal(counts, full_d.counts)


@pytest.mark.parametrize("k", [32, 64, 80])
def test_count_kmers_parity_k_mult16(rng, k):
    """K % 16 == 0: no pad bits in the last word; the sentinel stays
    unreachable because dictionaries hold canonical kmers only."""
    L = k + 20
    bases, lengths, quals = make_reads(rng, 150, L)
    # poly-T stretches to stress the all-ones corner
    bases[:10, : k + 4] = 3
    d, hist = ke.count_kmers(
        bases, lengths, quals, k, min_qual=7, min_freq=1, chunk_reads=64
    )
    expect = brute_count(bases, lengths, quals, k, 7)
    got_keys = [
        bk.unpack_words(d.words[i], k).tobytes() for i in range(d.size)
    ]
    assert got_keys == sorted(expect.keys())
    for i, key in enumerate(got_keys):
        assert int(d.counts[i]) == expect[key][0]
        assert int(d.ctx[i]) == expect[key][1]


def test_count_kmers_flat_device_parity(rng):
    """Flat counting via the device pipeline == host path."""
    k = 31
    seqs = [rng.integers(0, 4, size=int(n)).astype(np.uint8)
            for n in rng.integers(20, 200, size=25)]
    seg = np.zeros(len(seqs) + 1, dtype=np.int64)
    seg[1:] = np.cumsum([len(s) for s in seqs])
    flat = np.concatenate(seqs)
    d_host = ke.count_kmers_flat(flat, seg, k, min_freq=2, chunk_pos=512)
    d_dev = ke.count_kmers_flat(flat, seg, k, min_freq=2, chunk_pos=512,
                                force_device=True)
    np.testing.assert_array_equal(d_dev.words, d_host.words)
    np.testing.assert_array_equal(d_dev.counts, d_host.counts)
    np.testing.assert_array_equal(d_dev.ctx, d_host.ctx)


@pytest.mark.parametrize("min_freq", [1, 4])
@pytest.mark.parametrize("k", [31, 60, 100, 200])
def test_device_count_matches_native(rng, k, min_freq):
    """The production entry point's device path (forced on the CPU) is
    bit-equal to its native host path: words, counts, contexts and the
    histogram.  k=31/60 sort with the context in the pad bits or as a
    payload plane, k=200 takes the multi-pass big-W sort."""
    L = k + 30
    bases, lengths, quals = make_reads(rng, 160, L, with_quals=False)
    lengths[:] = L
    quals[rng.random(quals.shape) < 0.005] = 3
    bases = np.concatenate([bases] + [bases[:40]] * 5, axis=0)
    lengths = np.concatenate([lengths] + [lengths[:40]] * 5)
    quals = np.concatenate([quals] + [quals[:40]] * 5, axis=0)
    d_n, h_n = ke.count_kmers_batched(bases, lengths, quals, k,
                                      min_freq=min_freq)
    d_d, h_d = ke.count_kmers_batched(bases, lengths, quals, k,
                                      min_freq=min_freq, force_device=True)
    assert d_n.size > 0
    np.testing.assert_array_equal(d_d.words, d_n.words)
    np.testing.assert_array_equal(d_d.counts, d_n.counts)
    np.testing.assert_array_equal(d_d.ctx, d_n.ctx)
    np.testing.assert_array_equal(h_d, h_n)


def test_pack_rows_host_matches_device(rng):
    import jax.numpy as jnp

    for L in (250, 64, 7):
        bases = rng.integers(0, 4, size=(33, L)).astype(np.uint8)
        np.testing.assert_array_equal(
            ke.pack_rows_host(bases), np.asarray(ke.pack_rows(jnp.asarray(bases)))
        )


def test_count_kmers_batched_spill_and_auto_escalation(rng, tmp_path):
    """The -d / -m multipass machinery (BuildReadQGraph.cc:1120-1250
    analogue): forced disk_batches with tmp_dir spill and the
    max_mem_gb auto-escalation must both reproduce the single-pass
    dictionary and histogram bit for bit."""
    k, L = 21, 100
    bases, lengths, quals = make_reads(rng, 1500, L)
    bases = np.concatenate([bases, bases[:500]], axis=0)
    lengths = np.concatenate([lengths, lengths[:500]])
    quals = np.concatenate([quals, quals[:500]], axis=0)

    d0, h0 = ke.count_kmers_batched(
        bases, lengths, quals, k, min_freq=2, chunk_reads=2048
    )

    # forced hash-range batching with npz spill to tmp_dir
    spill = tmp_path / "spill"
    d1, h1 = ke.count_kmers_batched(
        bases, lengths, quals, k, min_freq=2, chunk_reads=2048,
        disk_batches=4, tmp_dir=str(spill),
    )
    assert np.array_equal(d0.words, d1.words)
    assert np.array_equal(d0.counts, d1.counts)
    assert np.array_equal(d0.ctx, d1.ctx)
    assert np.array_equal(h0, h1)
    # spill files are cleaned up after the merge
    assert list(spill.glob("kmer_range_*.npz")) == []

    # memory-ceiling auto-escalation: a budget below the working set
    # must force range_bits > 0 without changing the result
    W = bk.nwords(k)
    n_rows = bases.shape[0] * (L - k + 1)
    bytes_needed = n_rows * 4 * (W + 1) * 3
    budget_gb = (bytes_needed / 6) / (1 << 30)
    d2, h2 = ke.count_kmers_batched(
        bases, lengths, quals, k, min_freq=2, chunk_reads=2048,
        max_mem_gb=budget_gb,
    )
    assert np.array_equal(d0.words, d2.words)
    assert np.array_equal(d0.counts, d2.counts)
    assert np.array_equal(d0.ctx, d2.ctx)
    assert np.array_equal(h0, h2)


def test_native_count_matches_xla(rng, monkeypatch):
    """The C++ leaf counter (CPU fast path) must be bit-identical to
    the XLA chunk path, including range_bits filtering and the flat
    segment variant."""
    k, L = 21, 80
    bases, lengths, quals = make_reads(rng, 400, L)
    bases = np.concatenate([bases, bases[:150]], axis=0)
    lengths = np.concatenate([lengths, lengths[:150]])
    quals = np.concatenate([quals, quals[:150]], axis=0)

    monkeypatch.setenv("W2RAP_NATIVE_COUNT", "0")
    d_x, h_x = ke.count_kmers(bases, lengths, quals, k, min_freq=1,
                              chunk_reads=256)
    dr_x, _ = ke.count_kmers(bases, lengths, quals, k, min_freq=1,
                             chunk_reads=256, range_bits=2, range_index=1)
    monkeypatch.setenv("W2RAP_NATIVE_COUNT", "1")
    d_n, h_n = ke.count_kmers(bases, lengths, quals, k, min_freq=1,
                              chunk_reads=256)
    dr_n, _ = ke.count_kmers(bases, lengths, quals, k, min_freq=1,
                             chunk_reads=256, range_bits=2, range_index=1)
    for a, b in ((d_x, d_n), (dr_x, dr_n)):
        np.testing.assert_array_equal(a.words, b.words)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.ctx, b.ctx)
    np.testing.assert_array_equal(h_x, h_n)

    # flat variant (multiword large-K): segments of varying lengths
    for kf in (60, 200):
        seqs = [rng.integers(0, 4, size=int(n)).astype(np.uint8)
                for n in rng.integers(10, 900, size=30)]
        seqs += [seqs[0], seqs[3]]  # duplicates for counts
        seg = np.zeros(len(seqs) + 1, dtype=np.int64)
        seg[1:] = np.cumsum([len(s) for s in seqs])
        flat = np.concatenate(seqs)
        monkeypatch.setenv("W2RAP_NATIVE_COUNT", "0")
        f_x = ke.count_kmers_flat(flat, seg, kf, min_freq=1)
        monkeypatch.setenv("W2RAP_NATIVE_COUNT", "1")
        f_n = ke.count_kmers_flat(flat, seg, kf, min_freq=1)
        np.testing.assert_array_equal(f_x.words, f_n.words)
        np.testing.assert_array_equal(f_x.counts, f_n.counts)
        np.testing.assert_array_equal(f_x.ctx, f_n.ctx)


def test_device_resident_dict(monkeypatch, rng):
    """W2RAP_DEV_DICT=1 keeps the dict on device; host mirrors, padded
    views, histogram and size must all match the download path."""
    n, L, k = 64, 120, 60
    bases = rng.integers(0, 4, size=(n, L)).astype(np.uint8)
    # duplicate some reads so counts exceed 1
    bases[n // 2 :] = bases[: n - n // 2]
    lengths = np.full(n, L, np.int32)
    quals = np.full((n, L), 35, np.uint8)
    monkeypatch.delenv("W2RAP_DEV_DICT", raising=False)
    d0, h0 = ke.count_kmers_device(
        bases, lengths, quals, k, min_freq=2
    )
    monkeypatch.setenv("W2RAP_DEV_DICT", "1")
    d1, h1 = ke.count_kmers_device(
        bases, lengths, quals, k, min_freq=2
    )
    assert d1.dev is not None
    assert d1.size == d0.size
    np.testing.assert_array_equal(h0, h1)
    wp, cp, kd, mp = ke.padded_dict_views(d1)
    assert kd is None  # no kdef before graph construction
    assert mp == d1.dev["m_pad"]
    np.testing.assert_array_equal(np.asarray(wp)[: d1.size], d0.words)
    np.testing.assert_array_equal(
        np.asarray(cp)[: d1.size].astype(np.uint32), d0.ctx
    )
    assert np.all(np.asarray(wp)[d1.size :] == 0xFFFFFFFF)
    # lazy host materialization
    np.testing.assert_array_equal(d0.words, d1.words)
    np.testing.assert_array_equal(d0.counts, d1.counts)
    np.testing.assert_array_equal(d0.ctx, d1.ctx)


def test_device_dict_step2_graph_equal(monkeypatch, rng):
    """Full step-2 (adjacencies -> unitigs -> kdef -> padded views) is
    bit-identical between the device-resident and download dict paths."""
    from w2rap_contigger_tpu.graph import build as gb

    k = 60
    genome = rng.integers(0, 4, size=4000).astype(np.uint8)
    rlen = 150
    seqs = [genome[s : s + rlen] for s in range(0, len(genome) - rlen, 11)]
    bases = np.stack(seqs).astype(np.uint8)
    n = bases.shape[0]
    lengths = np.full(n, rlen, np.int32)
    quals = np.full((n, rlen), 35, np.uint8)

    results = []
    for env in ("0", "1"):
        monkeypatch.setenv("W2RAP_DEV_DICT", env)
        d, _ = ke.count_kmers_device(
            bases, lengths, quals, k, min_freq=2
        )
        assert (d.dev is not None) == (env == "1")
        gb.recompute_adjacencies(d)
        edge_bases, edge_start = gb.build_unitigs(d)
        wp, cp, kd, mp = ke.padded_dict_views(d)
        results.append(
            (edge_bases, edge_start, np.asarray(wp), np.asarray(cp),
             tuple(np.asarray(x) for x in kd), mp)
        )
    a, b = results
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3].astype(np.uint32),
                                  b[3].astype(np.uint32))
    for x, y in zip(a[4], b[4]):
        np.testing.assert_array_equal(x, y)
    assert a[5] == b[5]


def test_sort_big_w_matches_variadic(rng):
    """The multi-pass stable 2-key sort must equal the full variadic
    sort whenever no distinct rows tie on the leading 64 bits, and must
    raise the tie flag when they do."""
    import jax
    import jax.numpy as jnp

    W = 17
    N = 4096
    planes_np = [
        rng.integers(0, 2**32, size=N, dtype=np.uint32) for _ in range(W)
    ]
    pay_np = rng.integers(0, 2**16, size=N, dtype=np.uint32)
    planes = [jnp.asarray(p) for p in planes_np]
    pay = jnp.asarray(pay_np)
    sp, flag = ke._sort_big_w(planes, pay, W)
    assert not bool(np.asarray(flag))
    ref = jax.lax.sort(planes + [pay], num_keys=W)
    for a, b in zip(sp, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # adversarial: two distinct rows sharing the leading 64 bits
    planes_np[0][10] = planes_np[0][20]
    planes_np[1][10] = planes_np[1][20]
    planes_np[2][10] = planes_np[2][20] ^ np.uint32(1)
    planes = [jnp.asarray(p) for p in planes_np]
    _, flag = ke._sort_big_w(planes, pay, W)
    assert bool(np.asarray(flag))
