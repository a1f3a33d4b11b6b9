"""Unitig construction + HBV assembly from the sorted kmer dictionary.

Data-parallel redesign of the reference's EdgeBuilder walk + buildHBVFromEdges
(src/paths/long/BuildReadQGraph.cc:99-337, src/paths/long/HBVFromEdges.cc):

* adjacency recompute = 8 batched dictionary lookups per kmer (the
  reference's AdjProc, src/kmers/ReadPather.h:307-342),
* unitig chains = an oriented successor function over 2M oriented nodes
  followed by pointer-doubling list ranking (log-depth gathers on device)
  instead of the sequential spinlocked walk,
* edge emission keeps only FWD/palindromic canonical forms, exactly like
  EdgeBuilder::extend (BuildReadQGraph.cc:246-259); every chain has a
  reverse-complement mirror chain and exactly one of the two is kept,
* smooth circles (kmers left on no chain) are canonicalized by minimum
  kmer and emitted once, like EdgeBuilder::simpleCircle
  (BuildReadQGraph.cc:121-151,156-180).

Link rule (matches upstream/downstreamExtensionPossible,
BuildReadQGraph.cc:195-221): an oriented link u->v exists iff
succ_count(u)==1, pred_count(v)==1, and neither kmer is a palindrome.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bitkmer as bk
from ..ops import context as kctx
from ..ops import lookup
from .hbv import HyperBasevector

U32 = jnp.uint32
FULL = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# adjacency recompute
# ---------------------------------------------------------------------------


def _native_graph_lib(force: bool = False):
    """C++ adjacency/link kernel (native/graph_kernel.cc) — the CPU
    backend's fast path for graph construction's dictionary-lookup
    storms.  Returns the loaded library or None
    (env W2RAP_NATIVE_GRAPH=0 disables).  force=True skips the backend
    gate (blob-local graphs want the host path on any backend)."""
    import os

    if os.environ.get("W2RAP_NATIVE_GRAPH", "1") in ("0", "false", "off"):
        return None
    if not force:
        from ..backend import device_path

        if device_path():
            return None
    from .. import native

    return native.load("w2rapgraph", ["graph_kernel.cc"],
                       libs=["pthread"])


def _graph_threads():
    import os

    return int(os.environ.get("OMP_NUM_THREADS", "0")) or (
        os.cpu_count() or 1
    )


def _prune_ctx_native(lib, d):
    import ctypes

    words = np.ascontiguousarray(d.words, dtype=np.uint32)
    ctx = np.ascontiguousarray(d.ctx, dtype=np.uint32)
    out = np.empty(d.size, dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.w2rap_prune_ctx(
        words.ctypes.data_as(u32p), ctx.ctypes.data_as(u32p),
        ctypes.c_int64(d.size), ctypes.c_int32(d.k),
        ctypes.c_int32(words.shape[1]),
        ctypes.c_int32(_graph_threads()),
        out.ctypes.data_as(u32p),
    )
    d.ctx = out
    return d


def _build_links_native(lib, words, ctx, k):
    import ctypes

    words = np.ascontiguousarray(words, dtype=np.uint32)
    ctx = np.ascontiguousarray(ctx, dtype=np.uint32)
    m = words.shape[0]
    out = np.empty(2 * m, dtype=np.int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.w2rap_build_links(
        words.ctypes.data_as(u32p), ctx.ctypes.data_as(u32p),
        ctypes.c_int64(m), ctypes.c_int32(k),
        ctypes.c_int32(words.shape[1]),
        ctypes.c_int32(_graph_threads()),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _rows_bytes(words):
    """(M, W) uint32 rows -> (M,) big-endian byte keys whose bytewise
    order equals word-wise unsigned lexicographic order."""
    W = words.shape[1]
    return np.ascontiguousarray(words.astype(">u4")).view(f"S{4 * W}").ravel()


def _search_host(table_bytes, query_words):
    """Host binary search of query rows in the sorted table.  Returns
    (idx int32 clipped, found bool) like ops.lookup._search."""
    qb = _rows_bytes(query_words)
    M = len(table_bytes)
    if M == 0:
        return (np.zeros(len(qb), np.int32),
                np.zeros(len(qb), bool))
    pos = np.searchsorted(table_bytes, qb)
    posc = np.minimum(pos, M - 1).astype(np.int64)
    found = (pos < M) & (table_bytes[posc] == qb)
    return posc.astype(np.int32), found


def recompute_adjacencies_host(d):
    """Pure-numpy adjacency pruning for SMALL dictionaries (step-5
    blob-local graphs): the padded device form costs DICT_QUANTUM rows
    of work plus a dispatch per op for a few-thousand-row local dict."""
    words = d.words
    ctx = d.ctx.astype(np.uint32)
    k = d.k
    tb = _rows_bytes(words)
    new_ctx = np.zeros_like(ctx)
    for code in range(4):
        succ_c, _ = bk.canonicalize(
            bk.to_successor(words, np.uint32(code), k), k
        )
        _, found = _search_host(tb, succ_c)
        keep = (((ctx >> code) & 1).astype(bool)) & found
        new_ctx |= keep.astype(np.uint32) << code
        pred_c, _ = bk.canonicalize(
            bk.to_predecessor(words, np.uint32(code), k), k
        )
        _, foundp = _search_host(tb, pred_c)
        keepp = (((ctx >> (code + 4)) & 1).astype(bool)) & foundp
        new_ctx |= keepp.astype(np.uint32) << (code + 4)
    d.ctx = new_ctx
    return d


def _build_links_host(words, ctx, k: int):
    """Numpy mirror of _links_core over the full (unpadded) node space."""
    M = words.shape[0]
    tb = _rows_bytes(words)
    pal = bk.is_palindrome(words, k)
    node_ids = np.arange(2 * M, dtype=np.int64)
    kid_o = node_ids % M
    src_rev = node_ids >= M
    w_k = words[kid_o]
    w_o = np.where(src_rev[:, None], bk.rc_words(w_k, k), w_k)
    ctx_o = np.where(src_rev, kctx.rc_context(ctx[kid_o]), ctx[kid_o])
    pal_o = pal[kid_o]
    succ_bits = kctx.succ_bits(ctx_o)
    scount = kctx.popcount4(succ_bits)
    scode = kctx.single_base(succ_bits)
    succ_words = bk.to_successor(w_o, scode.astype(np.uint32), k)
    succ_canon, succ_isrev = bk.canonicalize(succ_words, k)
    vidx, found = _search_host(tb, succ_canon)
    vidx = vidx.astype(np.int64)
    v = vidx + succ_isrev.astype(np.int64) * M
    vctx_can = ctx[vidx]
    vctx = np.where(succ_isrev, kctx.rc_context(vctx_can), vctx_can)
    vpred = kctx.popcount4(kctx.pred_bits(vctx))
    vpal = pal[vidx]
    hairpin = (vidx == kid_o) & (succ_isrev != src_rev)
    ok = (
        (scount == 1) & found & (~pal_o) & (~vpal) & (vpred == 1)
        & (~hairpin)
    )
    return np.where(ok, v, -1).astype(np.int32)


def _list_rank_native(lib, nxt):
    """C++ sequential chain-walk list ranking (native/graph_kernel.cc):
    O(N) vs pointer doubling's O(N log N) gather passes; identical
    head/rank on linear chains, identical on_cycle mask."""
    import ctypes

    nxt = np.ascontiguousarray(nxt, dtype=np.int32)
    n2 = len(nxt)
    head = np.empty(n2, dtype=np.int32)
    rank = np.empty(n2, dtype=np.int32)
    cyc = np.empty(n2, dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.w2rap_list_rank(
        nxt.ctypes.data_as(i32p), ctypes.c_int64(n2),
        head.ctypes.data_as(i32p), rank.ctypes.data_as(i32p),
        cyc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return head, rank, cyc.astype(bool)


def _list_rank_host(nxt, n_iters: int):
    """Numpy pointer-doubling list ranking (mirror of _list_rank_dev)."""
    N2 = len(nxt)
    M = N2 // 2
    n = np.arange(N2, dtype=np.int32)
    rc_n = np.where(n < M, n + M, n - M)
    nxt_rc = nxt[rc_n].astype(np.int32)
    prev = np.where(
        nxt_rc >= 0, np.where(nxt_rc < M, nxt_rc + M, nxt_rc - M),
        np.int32(-1),
    )
    ptr = np.where(prev >= 0, prev, n).astype(np.int32)
    dist = (prev >= 0).astype(np.int32)
    for _ in range(n_iters):
        dist = dist + dist[ptr]
        ptr = ptr[ptr]
    on_cycle = prev[ptr] >= 0
    return ptr.astype(np.int32), dist.astype(np.int32), on_cycle


def _adjacencies_core(table_words, words, ctx, k: int, n_iters: int):
    """Prune context bits whose neighbor kmer is absent from the dict.

    table_words is the full sorted table; words/ctx may be a row slice
    of it (the multi-chip form shards rows, table replicated)."""
    table_t = table_words.T
    new_ctx = jnp.zeros_like(ctx)
    for code in range(4):
        succ = bk.to_successor(words, np.uint32(code), k)
        succ_c, _ = bk.canonicalize(succ, k)
        _, found = lookup._search(table_t, succ_c.T, n_iters)
        bit = (ctx >> code) & 1  # succ bit for this code
        keep = bit.astype(bool) & found
        new_ctx = new_ctx | (keep.astype(U32) << code)
        pred = bk.to_predecessor(words, np.uint32(code), k)
        pred_c, _ = bk.canonicalize(pred, k)
        _, foundp = lookup._search(table_t, pred_c.T, n_iters)
        bitp = (ctx >> (code + 4)) & 1
        keepp = bitp.astype(bool) & foundp
        new_ctx = new_ctx | (keepp.astype(U32) << (code + 4))
    return new_ctx


@functools.partial(jax.jit, static_argnames=("k", "n_iters"))
def _recompute_adjacencies_dev(words, ctx, k: int, n_iters: int):
    return _adjacencies_core(words, words, ctx, k, n_iters)


@functools.partial(jax.jit, static_argnames=("k", "n_iters"))
def _recompute_adjacencies_rows_dev(table, words, ctx, k: int,
                                    n_iters: int):
    return _adjacencies_core(table, words, ctx, k, n_iters)


def _recompute_adjacencies_dev_auto(wp, cp, k: int, n_iters: int):
    """Row-chunked adjacency pruning for big tables (each dispatch
    materializes ~4 (rows, W) neighbor planes; see LINKS_NODE_CHUNK)."""
    Mp = wp.shape[0]
    if Mp <= 2 * LINKS_NODE_CHUNK:
        return _recompute_adjacencies_dev(wp, cp, k, n_iters)
    parts = []
    for s in range(0, Mp, LINKS_NODE_CHUNK):
        e = min(s + LINKS_NODE_CHUNK, Mp)
        parts.append(
            _recompute_adjacencies_rows_dev(
                wp, wp[s:e], cp[s:e], k, n_iters
            )
        )
    return jnp.concatenate(parts)


def recompute_adjacencies(d, mesh=None, host=False):
    """d: ops.kmer_engine.KmerDict; updates d.ctx in place (host mirror
    or device view).  mesh: optional jax.sharding.Mesh — rows shard
    across chips with the table replicated; bit-identical.  host=True
    runs the pure-numpy form (small blob-local dicts)."""
    if d.size == 0:
        return d
    if mesh is None and d.dev is None:
        # host dict: the native C++ kernel beats both the padded XLA
        # form (quantum-padded rows + search over the padded table) and
        # the numpy form (memcmp searchsorted), and on a device backend
        # it avoids shipping a table the device never otherwise needs
        lib = _native_graph_lib(force=True)
        if lib is not None:
            return _prune_ctx_native(lib, d)
    if host:
        return recompute_adjacencies_host(d)
    from ..ops.kmer_engine import padded_dict_views

    wp, cp, _, mp = padded_dict_views(d)
    n_iters = max(1, int(np.ceil(np.log2(mp + 1))))
    if mesh is not None:
        from ..parallel import mesh as pmesh

        new_ctx = pmesh.recompute_adjacencies_sharded(
            mesh, jnp.asarray(wp), jnp.asarray(cp), d.k, n_iters
        )
    else:
        new_ctx = _recompute_adjacencies_dev_auto(
            jnp.asarray(wp), jnp.asarray(cp), d.k, n_iters
        )
    if d.dev is not None:
        # device-resident dict: the pruned context stays on device
        # (padding rows have empty contexts so theirs is still 0); the
        # host mirror re-materializes lazily if anything asks for it
        d.dev["ctx"] = new_ctx
        d._ctx = None
    else:
        d.ctx = np.asarray(new_ctx)[: d.size]
    return d


# ---------------------------------------------------------------------------
# oriented links + list ranking (device)
# ---------------------------------------------------------------------------


def _links_core(words, ctx, k: int, n_iters: int, node_ids):
    """next[n] for the oriented nodes in node_ids (n = i + o*M; o=0 fwd
    canonical, o=1 rc), against the full table words/ctx.

    Returns next int32 with -1 where no unitig link leaves n.  node_ids
    may be any slice of [0, 2M) — the multi-chip form shards the node
    space with the table replicated.
    """
    M, W = words.shape
    table_t = words.T

    pal = bk.is_palindrome(words, k)

    kid_o = node_ids % M
    src_rev = node_ids >= M
    w_k = words[kid_o]
    w_o = jnp.where(src_rev[:, None], bk.rc_words(w_k, k), w_k)
    c_k = ctx[kid_o]
    ctx_o = jnp.where(src_rev, kctx.rc_context(c_k), c_k)
    pal_o = pal[kid_o]

    succ_bits = kctx.succ_bits(ctx_o)
    scount = kctx.popcount4(succ_bits)
    scode = kctx.single_base(succ_bits)

    succ_words = bk.to_successor(w_o, scode.astype(U32), k)
    succ_canon, succ_isrev = bk.canonicalize(succ_words, k)
    vidx, found = lookup._search(table_t, succ_canon.T, n_iters)
    v = vidx + succ_isrev.astype(jnp.int32) * M  # oriented target node

    vctx_can = ctx[vidx]
    vctx = jnp.where(succ_isrev, kctx.rc_context(vctx_can), vctx_can)
    vpred = kctx.popcount4(kctx.pred_bits(vctx))
    vpal = pal[vidx]

    # hairpin guard: a link u -> rc(u) would put both orientations of one
    # kmer on a single chain; the reference FatalErrs on this pattern
    # ("preoccupied kmers", BuildReadQGraph.cc:296-303) — we break the
    # link instead so the kmers become separate 1-kmer-boundary edges.
    hairpin = (vidx == kid_o) & (succ_isrev != src_rev)

    ok = (scount == 1) & found & (~pal_o) & (~vpal) & (vpred == 1) & (~hairpin)
    return jnp.where(ok, v, -1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "n_iters"))
def _build_links_dev(words, ctx, k: int, n_iters: int):
    M = words.shape[0]
    node_ids = jnp.arange(2 * M, dtype=jnp.int32)
    return _links_core(words, ctx, k, n_iters, node_ids)


@functools.partial(jax.jit, static_argnames=("k", "n_iters", "cnt"))
def _build_links_chunk_dev(words, ctx, k: int, n_iters: int, start,
                           cnt: int):
    node_ids = start + jnp.arange(cnt, dtype=jnp.int32)
    return _links_core(words, ctx, k, n_iters, node_ids)


# one links dispatch materializes ~6 (nodes, W) planes; above this node
# count the intermediates can overflow device memory at big W, so the
# node space is processed in bounded chunks
LINKS_NODE_CHUNK = 1 << 22


def _build_links_dev_auto(wp, cp, k: int, n_iters: int):
    Mp = wp.shape[0]
    if 2 * Mp <= 2 * LINKS_NODE_CHUNK:
        return _build_links_dev(wp, cp, k, n_iters)
    parts = []
    for s in range(0, 2 * Mp, LINKS_NODE_CHUNK):
        cnt = min(LINKS_NODE_CHUNK, 2 * Mp - s)
        parts.append(
            _build_links_chunk_dev(
                wp, cp, k, n_iters, jnp.int32(s), cnt
            )
        )
    return jnp.concatenate(parts)


@functools.partial(jax.jit, static_argnames=("n_iters",))
def _list_rank_dev(nxt, n_iters: int):
    """Pointer-doubling list ranking on prev pointers.

    prev[n] = rc(next[rc(n)]) by orientation symmetry.  Returns
    (head (2M,) int32, rank (2M,) int32, on_cycle (2M,) bool).
    """
    N2 = nxt.shape[0]
    M = N2 // 2
    n = jnp.arange(N2, dtype=jnp.int32)
    rc_n = jnp.where(n < M, n + M, n - M)
    nxt_rc = nxt[rc_n]
    prev = jnp.where(
        nxt_rc >= 0, jnp.where(nxt_rc < M, nxt_rc + M, nxt_rc - M), -1
    )

    ptr = jnp.where(prev >= 0, prev, n)
    dist = (prev >= 0).astype(jnp.int32)

    def body(_, state):
        ptr, dist = state
        dist = dist + dist[ptr]
        ptr = ptr[ptr]
        return ptr, dist

    ptr, dist = jax.lax.fori_loop(0, n_iters, body, (ptr, dist))
    # linear chains: ptr is the head (its prev == -1).  cycles: prev[ptr]>=0.
    on_cycle = prev[ptr] >= 0
    return ptr, dist, on_cycle


# ---------------------------------------------------------------------------
# host assembly
# ---------------------------------------------------------------------------


def _oriented_kmer_words(words, rcw, node_ids, M):
    """Packed words of oriented nodes (gather + orientation select)."""
    kid = node_ids % M
    ori = (node_ids // M).astype(bool)
    return np.where(ori[:, None], rcw[kid], words[kid])


def build_unitigs(d, mesh=None, host=False):
    """Build canonical unitig edge set from the dictionary.

    Returns (edge_bases flat uint8, edge_start (E+1) int64) and fills
    d.edge_id / d.edge_offset / d.edge_rc per kmer (the KDef equivalent,
    reference src/kmers/ReadPather.h:104).

    mesh: optional jax.sharding.Mesh — the link-building lookups (8
    searches per kmer, the phase's device wall) shard the oriented node
    space across chips with the table replicated, and list ranking runs
    row-sharded with one tiled all-gather per doubling round
    (parallel.mesh.list_rank_sharded); both bit-identical.
    """
    M = d.size
    k = d.k
    if M == 0:
        d.edge_id = np.zeros(0, np.int32)
        d.edge_offset = np.zeros(0, np.int32)
        d.edge_rc = np.zeros(0, bool)
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)

    lib = None
    if mesh is None and d.dev is None:
        lib = _native_graph_lib(force=True)
    if lib is not None or host:
        # host forms: no padding, no device dispatches; native C++
        # when the toolchain is available, numpy otherwise
        if lib is not None:
            nxt = _build_links_native(lib, d.words,
                                      d.ctx.astype(np.uint32), k)
            head, rank, on_cycle = _list_rank_native(lib, nxt)
        else:
            nxt = _build_links_host(d.words, d.ctx.astype(np.uint32), k)
            rank_iters = max(1, int(np.ceil(np.log2(2 * M + 1))) + 1)
            head, rank, on_cycle = _list_rank_host(nxt, rank_iters)
    else:
        # device work runs on the quantum-padded dict (stable jit
        # shapes); padded sentinel rows have empty contexts so they form
        # isolated chains that the host filters out below.
        from ..ops.kmer_engine import padded_dict_views

        wp, cp, _, Mp = padded_dict_views(d)
        n_iters = max(1, int(np.ceil(np.log2(Mp + 1))))
        if mesh is not None:
            from ..parallel import mesh as pmesh

            nxt_d = pmesh.build_links_sharded(
                mesh, jnp.asarray(wp), jnp.asarray(cp), k, n_iters
            )
        else:
            nxt_d = _build_links_dev_auto(
                jnp.asarray(wp), jnp.asarray(cp), k, n_iters
            )
        rank_iters = max(1, int(np.ceil(np.log2(2 * Mp + 1))) + 1)
        if mesh is not None:
            from ..parallel import mesh as pmesh

            if (2 * Mp) % (2 * mesh.shape[pmesh.AXIS]) == 0:
                head_d, rank_d, cyc_d = pmesh.list_rank_sharded(
                    mesh, nxt_d, rank_iters
                )
            else:
                head_d, rank_d, cyc_d = _list_rank_dev(nxt_d, rank_iters)
        else:
            head_d, rank_d, cyc_d = _list_rank_dev(nxt_d, rank_iters)

        nxt = np.asarray(nxt_d)
        head = np.asarray(head_d)
        rank = np.asarray(rank_d)
        on_cycle = np.asarray(cyc_d)

        # compact the padded node space (2*Mp) back to 2*M: padded
        # sentinel nodes are isolated singletons and never targets of
        # real links.
        if Mp != M:
            valid_node = (np.arange(2 * Mp) % Mp) < M

            def _remap(n):
                n = np.asarray(n, dtype=np.int64)
                return np.where(n < 0, -1, (n % Mp) + (n // Mp) * M)

            nxt = _remap(nxt[valid_node]).astype(np.int32)
            head = _remap(head[valid_node]).astype(np.int32)
            rank = rank[valid_node]
            on_cycle = on_cycle[valid_node]

    words = d.words
    rcw = bk.rc_words(words, k)
    kmer_last = bk.last_base(words, k).astype(np.uint8)  # (M,)
    rc_last = bk.last_base(rcw, k).astype(np.uint8)

    # ---- linear chains: group oriented nodes by (head, rank) ----------
    lin_mask = ~on_cycle
    node = np.arange(2 * M, dtype=np.int64)
    lin_nodes_u = node[lin_mask]
    order = np.lexsort((rank[lin_mask], head[lin_mask]))
    lin_nodes = lin_nodes_u[order]
    lin_heads = head[lin_mask][order]

    seg_start = np.flatnonzero(
        np.concatenate([[True], lin_heads[1:] != lin_heads[:-1]])
    )
    seg_len = np.diff(np.concatenate([seg_start, [len(lin_nodes)]]))
    n_chains = len(seg_start)
    seg_head = lin_nodes[seg_start]
    seg_tail = lin_nodes[seg_start + seg_len - 1]

    # ---- keep exactly one of each chain/mirror pair -------------------
    # compare the chain's first oriented kmer with the mirror chain's
    # first oriented kmer (= rc of this chain's last kmer); ties fall
    # back to a full sequence comparison (rare).
    head_w = _oriented_kmer_words(words, rcw, seg_head, M)
    tail_w = _oriented_kmer_words(words, rcw, seg_tail, M)
    mirror_head_w = bk.rc_words(tail_w, k)
    lt = bk.words_lt(head_w, mirror_head_w)
    eq = bk.words_eq(head_w, mirror_head_w)
    keep = lt.copy()

    # resolve ties: single-kmer palindromes keep the o==0 copy; longer
    # ties compare full sequences (the mirror emits the other copy).
    tie_idx = np.flatnonzero(eq)
    hori = (seg_head // M).astype(np.int32)

    # ---- materialize all chain sequences (vectorized) -----------------
    # (we materialize for ALL chains, then slice kept ones; memory is
    # 2x the final edge pool which is fine at unitig scale)
    nid = (lin_nodes % M).astype(np.int64)
    nori = (lin_nodes // M).astype(bool)
    lastb = np.where(nori, rc_last[nid], kmer_last[nid])

    chain_lens = seg_len + k - 1
    cstart = np.zeros(n_chains + 1, dtype=np.int64)
    cstart[1:] = np.cumsum(chain_lens)
    flat_all = np.zeros(int(cstart[-1]), dtype=np.uint8)
    # prefixes: first k-1 bases of each chain's oriented head kmer
    head_codes = bk.unpack_words(head_w, k)[:, : k - 1]
    flat_all[cstart[:-1][:, None] + np.arange(k - 1)[None, :]] = head_codes
    # last bases of every node, laid out after the prefix
    pos_chain = np.repeat(np.arange(n_chains), seg_len)
    pos_rank = np.arange(len(lin_nodes)) - np.repeat(seg_start, seg_len)
    flat_all[cstart[pos_chain] + (k - 1) + pos_rank] = lastb

    for ci in tie_idx:
        seq = flat_all[cstart[ci] : cstart[ci + 1]]
        rcseq = (3 - seq)[::-1]
        a, b = seq.tobytes(), rcseq.tobytes()
        if a < b:
            keep[ci] = True
        elif a == b:
            keep[ci] = hori[ci] == 0  # palindrome: keep one copy

    kept_idx = np.flatnonzero(keep)
    n_lin_edges = len(kept_idx)
    chain_eid = np.full(n_chains, -1, dtype=np.int64)
    chain_eid[kept_idx] = np.arange(n_lin_edges)

    # kept flat pool
    kept_lens = chain_lens[kept_idx]
    edge_start = np.zeros(n_lin_edges + 1, dtype=np.int64)
    edge_start[1:] = np.cumsum(kept_lens)
    edge_bases = np.zeros(int(edge_start[-1]), dtype=np.uint8)
    # copy chain slices (vectorized via repeat-based index arithmetic)
    src_pos = np.repeat(cstart[kept_idx], kept_lens) + _ragged_arange(kept_lens)
    edge_bases[:] = flat_all[src_pos]

    # ---- per-kmer KDef assignment -------------------------------------
    edge_id = np.full(M, -1, dtype=np.int32)
    edge_offset = np.zeros(M, dtype=np.int32)
    edge_rc = np.zeros(M, dtype=bool)
    sel = chain_eid[pos_chain] >= 0
    kmer_sel = nid[sel]
    if np.any(edge_id[kmer_sel] >= 0) or len(np.unique(kmer_sel)) != len(kmer_sel):
        raise RuntimeError("preoccupied kmer — broken unitig links")
    edge_id[kmer_sel] = chain_eid[pos_chain[sel]]
    edge_offset[kmer_sel] = pos_rank[sel]
    edge_rc[kmer_sel] = nori[sel]

    edges_list = None
    # ---- cycles (host walk; rare) -------------------------------------
    if on_cycle.any():
        extra_edges, extra_kdef = _emit_cycles(
            nxt, on_cycle, words, rcw, kmer_last, rc_last, k, M, n_lin_edges
        )
        if extra_edges:
            add_flat, add_start = HyperBasevector.from_edge_list(k, extra_edges)
            edge_bases = np.concatenate([edge_bases, add_flat])
            edge_start = np.concatenate(
                [edge_start, edge_start[-1] + add_start[1:]]
            )
            for i, e, j, o in extra_kdef:
                if edge_id[i] >= 0:
                    raise RuntimeError("preoccupied kmer in cycle")
                edge_id[i] = e
                edge_offset[i] = j
                edge_rc[i] = bool(o)

    if np.any(edge_id < 0):
        raise RuntimeError("kmers not covered by any edge")
    d.edge_id = edge_id
    d.edge_offset = edge_offset
    d.edge_rc = edge_rc
    return edge_bases, edge_start


def _ragged_arange(lens):
    """concat([arange(l) for l in lens]) without a python loop."""
    total = int(lens.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    return out - np.repeat(starts, lens)


def _emit_cycles(nxt, on_cycle, words, rcw, kmer_last, rc_last, k, M, eid0):
    """Smooth circles: walk each cycle once, canonicalize by minimum
    oriented kmer + FWD form (EdgeBuilder::canonicalizeCircle)."""
    edges = []
    kdef = []
    todo = set(np.flatnonzero(on_cycle[:M]).tolist())

    def okmer_bytes(n):
        kid = n % M
        w = rcw[kid] if n >= M else words[kid]
        return bk.unpack_words(w[None], k)[0].tobytes()

    while todo:
        i = min(todo)
        chain = []
        n = i
        while True:
            chain.append(n)
            n = int(nxt[n])
            assert n >= 0, "cycle node with no successor"
            if n % M == i:
                break
        for c in chain:
            todo.discard(c % M)

        def build_seq(ch):
            first = np.frombuffer(okmer_bytes(ch[0]), dtype=np.uint8)[: k - 1]
            lb = np.array(
                [
                    rc_last[c % M] if c >= M else kmer_last[c % M]
                    for c in ch
                ],
                dtype=np.uint8,
            )
            return np.concatenate([first, lb])

        def min_rotate(ch):
            mp = min(range(len(ch)), key=lambda j: okmer_bytes(ch[j]))
            return ch[mp:] + ch[:mp]

        chain = min_rotate(chain)
        seq = build_seq(chain)
        rcseq = (3 - seq)[::-1]
        if rcseq.tobytes() < seq.tobytes():
            chain = [(c + M) % (2 * M) for c in reversed(chain)]
            chain = min_rotate(chain)
            seq = build_seq(chain)
        eid = eid0 + len(edges)
        edges.append(seq)
        for j, c in enumerate(chain):
            kdef.append((c % M, eid, j, 1 if c >= M else 0))
    return edges, kdef


# ---------------------------------------------------------------------------
# HBV from canonical edges
# ---------------------------------------------------------------------------


def build_hbv_from_edges(edge_bases, edge_start, k: int):
    """Canonical edges -> HyperBasevector with fwd+rc edge copies.

    Mirrors buildHBVFromEdges (src/paths/long/HBVFromEdges.cc:78-160):
    vertices are the distinct (k-1)-mer edge ends over both orientations;
    per input edge i the fwd copy is added, then the rc copy unless the
    edge is palindromic.  Returns (hbv, fwd_xlat (E,), rev_xlat (E,)).
    """
    E = len(edge_start) - 1
    if E == 0:
        return (
            HyperBasevector(
                k,
                np.zeros(0, np.uint8),
                np.zeros(1, np.int64),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                0,
            ),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
        )
    ko = k - 1
    W = bk.nwords(ko)
    lens = np.diff(edge_start)

    # the four (k-1)-mer ends of each edge (vectorized gather)
    prox_pos = edge_start[:-1][:, None] + np.arange(ko)[None, :]
    dist_pos = (edge_start[1:] - ko)[:, None] + np.arange(ko)[None, :]
    prox = edge_bases[prox_pos]
    dist = edge_bases[dist_pos]
    prox_w = bk.pack_codes(prox, ko)
    dist_w = bk.pack_codes(dist, ko)
    rc_prox_w = bk.rc_words(dist_w, ko)  # rc edge's proximal end
    rc_dist_w = bk.rc_words(prox_w, ko)

    is_pal = _palindromic_edges(edge_bases, edge_start)

    allw = np.ascontiguousarray(
        np.concatenate([prox_w, dist_w, rc_prox_w, rc_dist_w], axis=0)
    )
    # vertex ids = rank in the words-lexicographic unique order — the
    # same numbering np.unique on a structured view produced, but via
    # lexsort (the structured unique memcmp-compares per element and
    # was superlinear at north-star scale)
    n_all = allw.shape[0]
    sorder = np.lexsort(tuple(allw[:, c] for c in range(W - 1, -1, -1)))
    sa = allw[sorder]
    new_grp = np.empty(n_all, dtype=bool)
    new_grp[0] = True
    new_grp[1:] = (sa[1:] != sa[:-1]).any(axis=1)
    grp_sorted = np.cumsum(new_grp) - 1
    vid = np.empty(n_all, dtype=np.int32)
    vid[sorder] = grp_sorted.astype(np.int32)
    n_vertices = int(grp_sorted[-1]) + 1
    fw_v1, fw_v2 = vid[:E], vid[E : 2 * E]
    rc_v1, rc_v2 = vid[2 * E : 3 * E], vid[3 * E :]

    # emit edges: fwd then rc (unless palindrome), like the reference
    n_out = int(2 * E - is_pal.sum())
    fwd_xlat = np.cumsum(np.concatenate([[0], 2 - is_pal[:-1]])).astype(
        np.int32
    )
    rev_xlat = np.where(is_pal, fwd_xlat, fwd_xlat + 1).astype(np.int32)

    to_left = np.zeros(n_out, dtype=np.int32)
    to_right = np.zeros(n_out, dtype=np.int32)
    inv = np.zeros(n_out, dtype=np.int32)
    to_left[fwd_xlat] = fw_v1
    to_right[fwd_xlat] = fw_v2
    inv[fwd_xlat] = rev_xlat
    to_left[rev_xlat] = np.where(is_pal, fw_v1, rc_v1)
    to_right[rev_xlat] = np.where(is_pal, fw_v2, rc_v2)
    inv[rev_xlat] = fwd_xlat

    # base pool: fwd seq at fwd slot, rc seq at rev slot
    out_lens = np.zeros(n_out, dtype=np.int64)
    out_lens[fwd_xlat] = lens
    out_lens[rev_xlat] = lens
    out_start = np.zeros(n_out + 1, dtype=np.int64)
    out_start[1:] = np.cumsum(out_lens)
    flat = np.zeros(int(out_start[-1]), dtype=np.uint8)
    # fwd copies
    src = np.repeat(edge_start[:-1], lens) + _ragged_arange(lens)
    dst = np.repeat(out_start[fwd_xlat], lens) + _ragged_arange(lens)
    flat[dst] = edge_bases[src]
    # rc copies (skip palindromes — same slot already written)
    np_pal = ~is_pal
    if np_pal.any():
        lens_r = lens[np_pal]
        src_r = np.repeat(edge_start[:-1][np_pal], lens_r) + _ragged_arange(
            lens_r
        )
        # reversed positions within each edge
        rev_off = np.repeat(lens_r, lens_r) - 1 - _ragged_arange(lens_r)
        dst_r = np.repeat(out_start[rev_xlat[np_pal]], lens_r) + rev_off
        flat[dst_r] = 3 - edge_bases[src_r]

    hbv = HyperBasevector(
        k, flat, out_start, to_left, to_right, inv, int(n_vertices)
    )
    return hbv, fwd_xlat, rev_xlat


def _palindromic_edges(edge_bases, edge_start):
    """Vectorized per-edge palindrome (seq == rc seq) test."""
    E = len(edge_start) - 1
    lens = np.diff(edge_start)
    out = np.zeros(E, dtype=bool)
    cand = lens % 2 == 0  # odd-length DNA rc-palindromes are impossible
    for i in np.flatnonzero(cand):
        s = edge_bases[edge_start[i] : edge_start[i + 1]]
        out[i] = np.array_equal(s, (3 - s)[::-1])
    return out
