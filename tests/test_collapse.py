"""collapse_planes (the device counting path's collapse) against a numpy
oracle that follows the reference's combine_Entries + root filter
(BuildReadQGraph.cc:948-952,1095-1115) literally."""

import numpy as np
import pytest

from w2rap_contigger_tpu.ops import kmer_engine as ke

FULL = 0xFFFFFFFF


def oracle(words, ctx, cnt, min_freq):
    """Row-by-row collapse of a sorted stream: (words, ctx, cnt, hist)."""
    keys, tot_c, tot_x = [], [], []
    for row, x, c in zip(words, ctx, cnt):
        if np.all(row == FULL):
            continue
        key = tuple(int(v) for v in row)
        if not keys or keys[-1] != key:
            keys.append(key)
            tot_c.append(0)
            tot_x.append(0)
        tot_c[-1] = min(255, tot_c[-1] + int(c))
        tot_x[-1] |= int(x)
    hist = np.zeros(101, np.int64)
    for c in tot_c:
        hist[min(c, 100)] += 1
    keep = [i for i, c in enumerate(tot_c) if c >= min_freq]
    W = words.shape[1]
    return (
        np.array([keys[i] for i in keep], np.uint32).reshape(-1, W),
        np.array([tot_x[i] for i in keep], np.uint32),
        np.array([tot_c[i] for i in keep], np.uint32),
        hist,
    )


def sorted_stream(rng, W, n_keys, max_mult, n_sentinel, big=()):
    """Sorted rows of n_keys distinct keys with random multiplicities
    (keys listed in `big` get that many copies), FULL rows last."""
    keys = rng.integers(0, 2**32, size=(n_keys, W), dtype=np.uint32)
    mult = rng.integers(1, max_mult + 1, size=n_keys)
    for i, m in enumerate(big):
        mult[i] = m
    rows = np.repeat(keys, mult, axis=0)
    rows = rows[np.lexsort(rows.T[::-1])]
    n = rows.shape[0]
    ctx = rng.integers(0, 256, size=n).astype(np.uint32)
    cnt = np.ones(n, np.uint32)
    rows = np.concatenate([rows, np.full((n_sentinel, W), FULL, np.uint32)])
    ctx = np.concatenate([ctx, np.zeros(n_sentinel, np.uint32)])
    cnt = np.concatenate([cnt, np.zeros(n_sentinel, np.uint32)])
    return rows, ctx, cnt


def run_collapse(words, ctx, cnt, min_freq):
    import jax.numpy as jnp

    W = words.shape[1]
    planes = [jnp.asarray(words[:, j]) for j in range(W)]
    pay = jnp.asarray((ctx << np.uint32(8)) | cnt)
    out, octx, ocnt, m, hist = ke._collapse_planes_jit(
        planes, pay, min_freq=min_freq
    )
    m = int(m)
    out_w = np.stack([np.asarray(p) for p in out], axis=1)
    # the tail past m is FULL / 0 padding
    assert np.all(out_w[m:] == FULL)
    assert np.all(np.asarray(octx)[m:] == 0)
    assert np.all(np.asarray(ocnt)[m:] == 0)
    return (out_w[:m], np.asarray(octx)[:m], np.asarray(ocnt)[:m],
            np.asarray(hist).astype(np.int64))


def assert_same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("min_freq", [1, 2, 4])
@pytest.mark.parametrize("W", [4, 13, 17])
def test_collapse_matches_oracle(rng, W, min_freq):
    words, ctx, cnt = sorted_stream(rng, W, 300, 6, 37)
    got = run_collapse(words, ctx, cnt, min_freq)
    want = oracle(words, ctx, cnt, min_freq)
    assert_same(got, want)
    # the low bins (kmers the filter dropped) are still counted
    assert got[3][1:min_freq].sum() > 0 or min_freq == 1
    assert got[3].sum() == 300


def test_collapse_saturates_at_255(rng):
    words, ctx, cnt = sorted_stream(rng, 4, 20, 3, 5, big=(300, 256))
    # partial counts per row add saturating as well
    cnt[:4] = 200
    got = run_collapse(words, ctx, cnt, 4)
    want = oracle(words, ctx, cnt, 4)
    assert_same(got, want)
    assert got[2].max() == 255
    assert got[3][100] >= 2


def test_collapse_all_sentinel():
    words = np.full((64, 4), FULL, np.uint32)
    zeros = np.zeros(64, np.uint32)
    out_w, octx, ocnt, hist = run_collapse(words, zeros, zeros, 1)
    assert out_w.shape == (0, 4) and hist.sum() == 0


def test_collapse_single_segment(rng):
    key = rng.integers(0, 2**32, size=(1, 13), dtype=np.uint32)
    words = np.repeat(key, 50, axis=0)
    ctx = rng.integers(0, 256, size=50).astype(np.uint32)
    cnt = np.ones(50, np.uint32)
    got = run_collapse(words, ctx, cnt, 4)
    assert_same(got, oracle(words, ctx, cnt, 4))
    assert got[0].shape == (1, 13) and int(got[2][0]) == 50
    assert int(got[1][0]) == int(np.bitwise_or.reduce(ctx))
