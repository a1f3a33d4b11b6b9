"""Vectorized multiword binary search into the sorted kmer table.

This is the data-parallel replacement for KmerDict::findEntry hash probes
(src/kmers/ReadPather.h:177, feudal/HashSet.h): the dictionary is a
lexicographically sorted (M, W) uint32 array and lookup is a batched
binary search — log2(M) rounds of 4-word gathers on the VPU, thousands of
queries wide.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import bitkmer as bk


@functools.partial(jax.jit, static_argnames=("n_iters",))
def _search(table_t, q_t, n_iters: int):
    """table_t: (W, M) uint32; q_t: (W, Q) uint32. Returns (idx, found)."""
    W, M = table_t.shape
    Q = q_t.shape[1]
    lo = jnp.zeros(Q, dtype=jnp.int32)
    hi = jnp.full(Q, M, dtype=jnp.int32)

    def body(_, state):
        lo, hi = state
        mid = (lo + hi) >> 1
        midw = table_t[:, mid]  # (W, Q)
        lt = midw[W - 1] < q_t[W - 1]
        for i in range(W - 2, -1, -1):
            lt = (midw[i] < q_t[i]) | ((midw[i] == q_t[i]) & lt)
        lo = jnp.where(lt, mid + 1, lo)
        hi = jnp.where(lt, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_iters, body, (lo, hi))
    idx = jnp.clip(lo, 0, M - 1)
    hitw = table_t[:, idx]
    eq = hitw[0] == q_t[0]
    for i in range(1, W):
        eq = eq & (hitw[i] == q_t[i])
    found = eq & (lo < M)
    return idx, found


def lookup_words(table, queries):
    """Find each query row in the sorted table.

    table: (M, W) uint32 sorted lexicographically; queries: (Q, W) uint32.
    Returns (idx (Q,) int32, found (Q,) bool); idx is the table row when
    found, else the insertion point (clipped).
    """
    M = table.shape[0]
    if M == 0:
        q = queries.shape[0]
        return jnp.zeros(q, jnp.int32), jnp.zeros(q, bool)
    n_iters = max(1, int(np.ceil(np.log2(M + 1))))
    return _search(jnp.asarray(table).T, jnp.asarray(queries).T, n_iters)
