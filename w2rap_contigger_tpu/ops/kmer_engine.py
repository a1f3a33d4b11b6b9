"""The sorted-kmer engine — the replacement for the reference's
concurrent hash dictionary build (createDictOMPRecursive,
src/paths/long/BuildReadQGraph.cc:1015-1110).

Design: sorting is the hash table.

  reads (N,L) --pack--> 2-bit rows --window-shift--> canonical kmer words
      --lax.sort (W x uint32 lexicographic keys)--> runs of equal kmers
      --segmented scan + index-sort compaction--> (kmer, count, context)

Where it runs is decided by backend.device_path(): the device path
kmerizes chunks on the accelerator and sorts the whole stream once
(count_kmers_device); the host path runs the native C++ counter
(_count_kmers_spill_native / _count_kmers_flat_native).  Counts
saturate at 255 exactly like the reference's uint8 KMerNodeFreq::count
(BuildReadQGraph.cc:948-952 combine_Entries).

Quality gating reproduces count_good_lengths (BuildReadQGraph.cc:962-987):
a read is truncated at the end of its RIGHTMOST window of K consecutive
bases with qual >= minQual; reads whose truncated length is not > K
contribute no kmers.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import device_path
from . import bitkmer as bk
from . import context as kctx

U32 = jnp.uint32
FULL = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# quality gating
# ---------------------------------------------------------------------------


def good_lengths(quals, lengths, k: int, min_qual: int):
    """Per-read usable prefix length (vectorized count_good_lengths).

    quals: (N, L) uint8; lengths: (N,) int32.  Returns (N,) int32.
    """
    n, L = quals.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    good = (quals >= np.uint8(min_qual)) & (pos < lengths[:, None])
    # next_bad[i] = smallest j >= i with a bad base (L if none)
    badpos = jnp.where(good, jnp.int32(L), pos)
    next_bad = jax.lax.cummin(badpos, axis=1, reverse=True)
    run = next_bad - pos  # good-run length starting at i
    ok = run >= k
    i_max = jnp.max(jnp.where(ok, pos, -1), axis=1)
    return jnp.where(i_max >= 0, i_max + k, 0).astype(jnp.int32)


# ---------------------------------------------------------------------------
# kmerization
# ---------------------------------------------------------------------------


def pack_rows(bases):
    """(N, L) uint8 codes -> (N, ceil(L/16)) uint32 big-endian 2-bit rows."""
    n, L = bases.shape
    W = (L + 15) // 16
    padded = jnp.zeros((n, W * 16), dtype=U32).at[:, :L].set(bases.astype(U32))
    shifts = (30 - 2 * np.arange(16)).astype(np.uint32)
    # shifted 2-bit fields occupy disjoint bits, so sum == bitwise or
    return jnp.sum(
        padded.reshape(n, W, 16) << shifts[None, None, :],
        axis=-1,
        dtype=U32,
    )


def pack_rows_host(bases):
    """numpy mirror of pack_rows: (N, L) u8 -> (N, ceil(L/16)) u32."""
    bases = np.asarray(bases, dtype=np.uint32)
    n, L = bases.shape
    Wr = (L + 15) // 16
    padded = np.zeros((n, Wr * 16), dtype=np.uint32)
    padded[:, :L] = bases
    shifts = (30 - 2 * np.arange(16)).astype(np.uint32)
    return np.bitwise_or.reduce(
        padded.reshape(n, Wr, 16) << shifts[None, None, :], axis=-1
    ).astype(np.uint32)


def kmer_windows(packed, k: int, n_pos: int):
    """Extract packed kmer words for every window position.

    packed: (N, WR) uint32 rows; returns (N, n_pos, W) uint32 where window
    p covers bases [p, p+k).

    Implementation note: positions are processed in 16 phases (p = 16q+r)
    so every access is a static SLICE of the packed rows combined with a
    fixed shift — XLA compiles this to pure vector ops, whereas the naive
    static-index gather blows up compile time superlinearly.
    """
    n, WR = packed.shape
    W = bk.nwords(k)
    Pq = (n_pos + 15) // 16
    need = Pq + W + 1
    if WR < need:
        packed = jnp.concatenate(
            [packed, jnp.zeros((n, need - WR), dtype=packed.dtype)], axis=1
        )
    # word lane j of window at q-word offset: packed[:, q+j]
    lanes = [packed[:, j : j + Pq] for j in range(W + 1)]  # each (N, Pq)
    per_w = []
    for j in range(W):
        hi, lo = lanes[j], lanes[j + 1]
        per_r = []
        for r in range(16):
            if r == 0:
                per_r.append(hi)
            else:
                s = np.uint32(2 * r)
                per_r.append(((hi << s) | (lo >> np.uint32(32 - 2 * r))) & bk.FULL)
        per_w.append(jnp.stack(per_r, axis=2))  # (N, Pq, 16)
    combined = jnp.stack(per_w, axis=3)  # (N, Pq, 16, W)
    combined = combined.reshape(n, Pq * 16, W)[:, :n_pos]
    # zero the pad bits below base k-1 in the last word
    pad = 2 * (16 * W - k)
    if pad:
        mask = np.uint32((0xFFFFFFFF >> pad) << pad)
        combined = combined.at[:, :, W - 1].set(combined[:, :, W - 1] & mask)
    return combined


@functools.partial(jax.jit, static_argnames=("k", "min_qual"))
def kmerize_chunk(bases, lengths, quals, k: int, min_qual: int):
    """Per-chunk kmerization + canonicalization.

    Returns (words (N*P, W) uint32 canonical [sentinel FULL where invalid],
             ctx   (N*P,)  uint32 context byte,
             valid (N*P,)  bool).
    """
    n, L = bases.shape
    P = L - k + 1
    glen = good_lengths(quals, lengths, k, min_qual)

    packed = pack_rows(bases)
    words = kmer_windows(packed, k, P)  # (N, P, W)

    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    # reference: only reads with glen > k emit kmers, positions 0..glen-k
    n_kmers = jnp.where(glen > k, glen - k + 1, 0)[:, None]
    valid = pos < n_kmers

    # context bases: pred = bases[pos-1] (pos>0), succ = bases[pos+k] (pos+k<glen)
    has_pred = (pos > 0) & valid
    succ_idx = jnp.broadcast_to(jnp.minimum(pos + k, L - 1), (n, P))
    has_succ = (pos + k < glen[:, None]) & valid
    pred_idx = jnp.broadcast_to(jnp.maximum(pos - 1, 0), (n, P))
    pred_code = jnp.take_along_axis(bases, pred_idx, axis=1).astype(U32)
    succ_code = jnp.take_along_axis(bases, succ_idx, axis=1).astype(U32)
    ctx = kctx.make_context(
        pred_code, succ_code, has_pred.astype(U32), has_succ.astype(U32)
    )

    canon, is_rev = bk.canonicalize(words, k)
    ctx = jnp.where(is_rev, kctx.rc_context(ctx), ctx)

    W = canon.shape[-1]
    canon = jnp.where(valid[:, :, None], canon, FULL)
    ctx = jnp.where(valid, ctx, 0)
    return (
        canon.reshape(n * P, W),
        ctx.reshape(n * P),
        valid.reshape(n * P),
    )


# ---------------------------------------------------------------------------
# sort + collapse
# ---------------------------------------------------------------------------


def _seg_scan(pay, is_start):
    """Segmented inclusive scan of (ctx << 8) | count payloads over the
    runs marked by is_start: contexts OR, counts add saturating at 255
    (the reference's uint8 KMerNodeFreq::count,
    BuildReadQGraph.cc:948-952).  Saturating addition is associative, so
    the scan equals the reference's sequential combine."""

    def combine(a, b):
        av, af = a
        bv, bf = b
        cnt = jnp.minimum((av & 0xFF) + (bv & 0xFF), 255)
        v = ((av | bv) & ~np.uint32(0xFF)) | cnt
        return jnp.where(bf, bv, v), af | bf

    return jax.lax.associative_scan(combine, (pay, is_start))[0]


def collapse_planes(planes, pay, min_freq: int = 1):
    """Collapse a sorted kmer stream into a compact dictionary.

    planes: W (n,) uint32 word planes in lexicographic order, all-FULL
    sentinel rows last; pay: (n,) uint32 (ctx << 8) | count per row
    (count 0 on sentinel rows).

    Returns (W word planes (n,), ctx (n,), cnt (n,) uint32, m,
    hist (101,) int32): the first m rows are the distinct kmers with
    count >= min_freq in sorted order and the tail is FULL / 0; hist[c]
    counts the distinct kmers with min(count, 100) == c before the
    min_freq filter (the small_K.freqs histogram,
    BuildReadQGraph.cc:1095-1115).  Each run's total lands on its last
    row, which is kept if the run passes the filter.
    """
    n = pay.shape[0]
    neq = planes[0][1:] != planes[0][:-1]
    for p in planes[1:]:
        neq = neq | (p[1:] != p[:-1])
    one = jnp.ones(1, dtype=bool)
    tot = _seg_scan(pay, jnp.concatenate([one, neq]))
    sent = planes[0] == FULL
    for p in planes[1:]:
        sent = sent & (p == FULL)
    seg_end = jnp.concatenate([neq, one]) & ~sent
    cnt = tot & np.uint32(0xFF)
    keep = seg_end & (cnt >= np.uint32(min_freq))

    binned = jnp.where(seg_end, jnp.minimum(cnt, 100).astype(jnp.int32), -1)
    hist = jnp.sum(
        binned[:, None] == jnp.arange(101, dtype=jnp.int32)[None, :],
        axis=0, dtype=jnp.int32,
    )

    # compaction: one int32 sort puts the kept rows' indices first, in
    # order (on the H100 this beat a prefix-sum scatter, PERF.md)
    i = jnp.arange(n, dtype=jnp.int32)
    src = jnp.minimum(jax.lax.sort(jnp.where(keep, i, i + n)), n - 1)
    m = jnp.sum(keep.astype(jnp.int32))
    tail = i >= m

    def take(x, fill):
        return jnp.where(tail, fill, x[src])

    out = [take(p, FULL) for p in planes]
    return out, take(tot >> np.uint32(8), 0), take(cnt, 0), m, hist


_collapse_planes_jit = functools.partial(
    jax.jit, static_argnames=("min_freq",)
)(collapse_planes)


def _collapse_sorted(sw, sctx, scnt, w):
    """Collapse equal adjacent keys of already-sorted (M, w) rows.
    Returns (unique words (M, w) [tail FULL], ctx, counts int32,
    n_unique)."""
    pay = (sctx.astype(U32) << np.uint32(8)) | scnt.astype(U32)
    out, ctx, cnt, m, _ = collapse_planes([sw[:, j] for j in range(w)], pay)
    return jnp.stack(out, axis=-1), ctx, cnt.astype(jnp.int32), m


def _sort_collapse_leaf_impl(words, ctx, w: int):
    """Leaf-level sort+collapse: every row has implicit count 1 (invalid
    rows are all-FULL sentinels and count as 0).  One fewer sort operand
    than the merge form — the leaf sorts dominate total work."""
    M = words.shape[0]
    ops = [words[:, i] for i in range(w)] + [ctx]
    sorted_ops = jax.lax.sort(ops, num_keys=w)
    sw = jnp.stack(sorted_ops[:w], axis=-1)
    sctx = sorted_ops[w]
    sentinel = bk.words_eq(sw, jnp.full((1, w), FULL, dtype=jnp.uint32))
    scnt = (~sentinel).astype(jnp.int32)
    return _collapse_sorted(sw, sctx, scnt, w)


sort_collapse_leaf = functools.partial(jax.jit, static_argnames=("w",))(
    _sort_collapse_leaf_impl
)


@functools.partial(jax.jit, static_argnames=("w",))
def sort_collapse(words, ctx, counts, w: int):
    """Sort kmer rows and collapse equal keys.

    words: (M, w) uint32 (invalid rows must be all-FULL sentinels)
    ctx:   (M,) uint32 context bytes
    counts:(M,) int32 partial counts (0 for invalid rows)

    Returns (sorted unique words (M, w) [tail = sentinel], ctx, counts,
    n_unique:int32).  Counts saturate at 255.
    """
    ops = [words[:, i] for i in range(w)] + [ctx, counts.astype(jnp.int32)]
    sorted_ops = jax.lax.sort(ops, num_keys=w)
    sw = jnp.stack(sorted_ops[:w], axis=-1)
    return _collapse_sorted(sw, sorted_ops[w], sorted_ops[w + 1], w)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------


class KmerDict:
    """Sorted canonical kmer dictionary (host mirror).

    Replaces KmerDict<K>/HashSet (src/kmers/ReadPather.h:177): the table is
    a lexicographically sorted array of canonical kmers; lookup is binary
    search (ops.lookup).  Fields edge_id/edge_offset/edge_rc are filled by
    graph construction (graph.build), mirroring KDef (ReadPather.h:104).
    """

    def __init__(self, words, counts, ctx, k, dev=None):
        self._words = words  # (M, W) uint32 sorted
        self._counts = counts  # (M,) int32
        self._ctx = ctx  # (M,) uint8/uint32 context bytes
        self.k = k
        self.edge_id = None  # (M,) int32
        self.edge_offset = None  # (M,) int32
        self.edge_rc = None  # (M,) bool: canonical kmer appears RC on edge
        # device-resident padded views (device counting path): dict
        # with 'words' (m_pad, W) u32 FULL-padded, 'ctx'/'cnt' (m_pad,)
        # u32, 'm', 'm_pad' ints, optionally 'kdef' (eid, eoff, erc)
        # device arrays.  Host mirrors above materialize lazily from
        # these, so the counting -> adjacency -> unitig -> pathing chain
        # never re-uploads the table.
        self.dev = dev

    def _materialize(self):
        m = self.dev["m"]
        if self._words is None:
            self._words = np.asarray(self.dev["words"])[:m]
        if self._counts is None:
            self._counts = np.asarray(self.dev["cnt"])[:m].astype(np.int32)
        if self._ctx is None:
            self._ctx = np.asarray(self.dev["ctx"])[:m].astype(np.uint32)

    @property
    def words(self):
        if self._words is None and self.dev is not None:
            self._materialize()
        return self._words

    @words.setter
    def words(self, v):
        self._words = v

    @property
    def counts(self):
        if self._counts is None and self.dev is not None:
            self._materialize()
        return self._counts

    @counts.setter
    def counts(self, v):
        self._counts = v

    @property
    def ctx(self):
        if self._ctx is None and self.dev is not None:
            self._materialize()
        return self._ctx

    @ctx.setter
    def ctx(self, v):
        self._ctx = v
        # keep the device view coherent if a host write lands on a
        # device-resident dict (recompute_adjacencies' dev branch
        # updates self.dev["ctx"] directly and skips this)
        if self.dev is not None and v is not None:
            import jax.numpy as _jnp

            pad = np.zeros(self.dev["m_pad"], dtype=np.uint32)
            pad[: self.dev["m"]] = v
            self.dev["ctx"] = _jnp.asarray(pad)

    @property
    def size(self):
        if self.dev is not None:
            return self.dev["m"]
        return self._words.shape[0]


PAD_QUANTUM = 1 << 21  # row-count quantum for padded device buffers


def _quantize(n: int, q: int = PAD_QUANTUM) -> int:
    return max(q, ((n + q - 1) // q) * q)


def _pad_rows(words, ctx, cnt, n_valid: int, cap: int):
    """Pad compacted arrays (valid prefix n_valid) to capacity cap."""
    cur = words.shape[0]
    if cur == cap:
        return words, ctx, cnt
    if cur > cap:
        return words[:cap], ctx[:cap], cnt[:cap]
    pw = jnp.full((cap - cur, words.shape[1]), FULL, dtype=U32)
    pc = jnp.zeros(cap - cur, dtype=ctx.dtype)
    pn = jnp.zeros(cap - cur, dtype=cnt.dtype)
    return (
        jnp.concatenate([words, pw], axis=0),
        jnp.concatenate([ctx, pc], axis=0),
        jnp.concatenate([cnt, pn], axis=0),
    )


def _vview(words):
    """(M, W) uint32 -> (M,) big-endian void view (memcmp == lexicographic)."""
    be = np.ascontiguousarray(words.astype(">u4"))
    return be.view(f"V{4 * words.shape[1]}").reshape(-1)


def host_merge_sorted(a, b):
    """Merge two sorted-unique (words, ctx, cnt) runs on host (numpy).

    The device does the heavy leaf sorts at one fixed shape; merging
    sorted unique runs is O(n) memory moves + binary searches, which the
    host does without any fresh XLA compiles.  Counts saturate at 255
    like the reference's combine_Entries (BuildReadQGraph.cc:948).
    """
    wA, cA, nA = a
    wB, cB, nB = b
    if wA.shape[0] == 0:
        return wB, cB, nB
    if wB.shape[0] == 0:
        return wA, cA, nA
    vA = _vview(wA)
    vB = _vview(wB)
    pos = np.searchsorted(vA, vB)
    posc = np.minimum(pos, len(vA) - 1)
    eq = (pos < len(vA)) & (vA[posc] == vB)

    ctxA = cA.copy()
    cntA = nA.copy()
    hit = posc[eq]
    ctxA[hit] |= cB[eq]
    cntA[hit] = np.minimum(cntA[hit].astype(np.int64) + nB[eq], 255).astype(
        cntA.dtype
    )

    unm = ~eq
    n_un = int(unm.sum())
    if n_un == 0:
        return wA, ctxA, cntA
    posu = pos[unm]  # nondecreasing
    a_dst = np.arange(len(vA)) + np.searchsorted(
        posu, np.arange(len(vA)), side="right"
    )
    b_dst = posu + np.arange(n_un)
    n_out = len(vA) + n_un
    wO = np.empty((n_out, wA.shape[1]), dtype=np.uint32)
    cO = np.empty(n_out, dtype=cA.dtype)
    nO = np.empty(n_out, dtype=nA.dtype)
    wO[a_dst] = wA
    cO[a_dst] = ctxA
    nO[a_dst] = cntA
    wO[b_dst] = wB[unm]
    cO[b_dst] = cB[unm]
    nO[b_dst] = nB[unm]
    return wO, cO, nO


def _host_merge_all(runs):
    """Balanced pairwise host merge of sorted-unique runs."""
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(host_merge_sorted(runs[i], runs[i + 1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def _native_count_lib(force: bool = False):
    """C++ leaf counter (native/count_kernel.cc) — the host path's
    counter.  Returns the loaded library or None (env
    W2RAP_NATIVE_COUNT=0 disables).  force=True skips the backend rule
    (blob-local counting wants the host path on any backend)."""
    if os.environ.get("W2RAP_NATIVE_COUNT", "1") in ("0", "false", "off"):
        return None
    if not force and device_path():
        return None
    from .. import native

    return native.load("w2rapcount", ["count_kernel.cc"], libs=["pthread"])


def _native_count_leaf(lib, cb, cl, cq, k, W, min_qual, range_bits,
                       range_index):
    """One C++ leaf: kmerize+canonicalize+sort+collapse a read chunk.
    Returns (words (m, W) u32, ctx u8, cnt u8)."""
    import ctypes

    cb = np.ascontiguousarray(cb, dtype=np.uint8)
    cq = np.ascontiguousarray(cq, dtype=np.uint8)
    cl = np.ascontiguousarray(cl, dtype=np.int32)
    n, L = cb.shape
    cap = max(1, n * max(0, L - k + 1))
    out_w = np.empty((cap, W), dtype=np.uint32)
    out_x = np.empty(cap, dtype=np.uint8)
    out_c = np.empty(cap, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.w2rap_count_leaf.restype = ctypes.c_int64
    m = lib.w2rap_count_leaf(
        cb.ctypes.data_as(u8p), cq.ctypes.data_as(u8p),
        cl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n), ctypes.c_int64(L), ctypes.c_int32(k),
        ctypes.c_int32(W), ctypes.c_int32(min_qual),
        ctypes.c_int32(range_bits), ctypes.c_uint32(range_index),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_x.ctypes.data_as(u8p), out_c.ctypes.data_as(u8p),
    )
    return out_w[:m].copy(), out_x[:m].copy(), out_c[:m].copy()


def count_kmers(
    bases,
    lengths,
    quals,
    k: int,
    min_qual: int = 7,
    min_freq: int = 4,
    chunk_reads: int = 65536,
    pad_quantum: int = PAD_QUANTUM,
    range_bits: int = 0,
    range_index: int = 0,
):
    """Count canonical kmers with quality gating; returns (KmerDict, hist).

    hist is the small_K.freqs histogram: hist[c] = number of distinct
    kmers with (saturated) count c binned at min(100, count)
    (reference BuildReadQGraph.cc:1095-1115).
    min_freq filters the dictionary but not the histogram.

    Chunks of reads are kmerized + sorted + collapsed on device at ONE
    fixed shape (compile-cache friendly); the sorted unique runs are then
    merged on host (the analogue of the reference's OMP merge tree,
    BuildReadQGraph.cc:1018-1048, and of its disk-batch k-way merge).
    """
    n = bases.shape[0]
    W = bk.nwords(k)
    L = bases.shape[1]
    if L < k:
        # reads shorter than k emit no kmers (reference kmerization
        # loops from 0 to len-K, BuildReadQGraph.cc:1062-1081); without
        # this the per-chunk kmerize would reshape to a negative
        # position count (seen in the wild as `reshape (-589824, 0)` =
        # 65536-row chunk x (250-260+1) when counting 250bp reads at
        # K=260).
        empty = np.zeros((0, W), dtype=np.uint32)
        return (
            KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k),
            np.zeros(101, dtype=np.int64),
        )

    # Sequential per-chunk dispatch: queueing many big chunks degrades
    # badly on latency-bound backends; downloads use quantized slices so
    # transfer programs hit the compile cache.
    n_chunks = max(1, -(-n // chunk_reads))
    runs = []
    SLICE_Q = 1 << 18
    native_lib = _native_count_lib()
    kmerize = functools.partial(kmerize_chunk, k=k, min_qual=min_qual)
    for ci in range(n_chunks):
        start = ci * chunk_reads
        stop = min(start + chunk_reads, n)
        if native_lib is not None:
            # C++ leaf (no shape padding needed — host code is not
            # compile-cached)
            ow, octx, ocnt = _native_count_leaf(
                native_lib, bases[start:stop], lengths[start:stop],
                quals[start:stop], k, W, min_qual, range_bits, range_index,
            )
            runs.append((ow, octx, ocnt))
            if os.environ.get("W2RAP_VERBOSE"):
                print(
                    f"count_kmers chunk {ci+1}/{n_chunks}: "
                    f"{ow.shape[0]} unique (native)",
                    flush=True,
                )
            continue
        cb = np.zeros((chunk_reads, L), dtype=np.uint8)
        cl = np.zeros(chunk_reads, dtype=np.int32)
        cq = np.zeros((chunk_reads, L), dtype=np.uint8)
        cb[: stop - start] = bases[start:stop]
        cl[: stop - start] = lengths[start:stop]
        cq[: stop - start] = quals[start:stop]
        cw, cctx, cvalid = kmerize(
            jnp.asarray(cb), jnp.asarray(cl), jnp.asarray(cq)
        )
        if range_bits:
            # keep only kmers in this hash-range slice (disk-batch /
            # shard analogue, BuildReadQGraph.cc:1120-1250)
            shift = np.uint32(32 - range_bits)
            in_range = (cw[:, 0] >> shift) == np.uint32(range_index)
            cw = jnp.where(in_range[:, None], cw, FULL)
            cctx = jnp.where(in_range, cctx, 0)
        ow, octx, ocnt, nu_d = sort_collapse_leaf(cw, cctx, W)
        nu = int(nu_d)
        nq = min(ow.shape[0], ((nu + SLICE_Q - 1) // SLICE_Q) * SLICE_Q)
        runs.append(
            (
                np.asarray(ow[:nq])[:nu],
                np.asarray(octx[:nq])[:nu],
                np.asarray(ocnt[:nq])[:nu],
            )
        )
        if os.environ.get("W2RAP_VERBOSE"):
            print(
                f"count_kmers chunk {ci+1}/{n_chunks}: {nu} unique",
                flush=True,
            )

    if not runs:
        empty = np.zeros((0, W), dtype=np.uint32)
        return (
            KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k),
            np.zeros(101, dtype=np.int64),
        )
    words, ctx, cnt = _host_merge_all(runs)

    hist = np.zeros(101, dtype=np.int64)
    if cnt.size:
        np.add.at(hist, np.minimum(cnt, 100), 1)
    hist[0] = 0

    keep = cnt >= min_freq
    d = KmerDict(
        words[keep], cnt[keep].astype(np.int32), ctx[keep].astype(np.uint32), k
    )
    return d, hist


# ---------------------------------------------------------------------------
# flat-layout counting (for step 3's place sequences of arbitrary length)
# ---------------------------------------------------------------------------


def _kmerize_flat_impl(bases, valid, has_pred, has_succ, pred_code, succ_code, k: int):
    """Kmerize a flat base chunk.

    bases: (C + 16*ceil(k/16),) uint8 — positions p in [0, C) use window
    [p, p+k); validity/context masks are computed by the host caller from
    segment boundaries.  Returns (words (C,W), ctx (C,), valid).
    """
    C = valid.shape[0]
    packed = pack_rows(bases[None, :])  # (1, WR)
    words = kmer_windows(packed, k, C)[0]  # (C, W)
    ctx = kctx.make_context(
        pred_code.astype(U32),
        succ_code.astype(U32),
        has_pred.astype(U32),
        has_succ.astype(U32),
    )
    canon, is_rev = bk.canonicalize(words, k)
    ctx = jnp.where(is_rev, kctx.rc_context(ctx), ctx)
    canon = jnp.where(valid[:, None], canon, FULL)
    ctx = jnp.where(valid, ctx, 0)
    return canon, ctx, valid


kmerize_flat_chunk = functools.partial(jax.jit, static_argnames=("k",))(
    _kmerize_flat_impl
)


def count_kmers_flat(
    flat_bases,
    seg_offsets,
    k: int,
    min_freq: int = 1,
    chunk_pos: int | None = None,
    pad_quantum: int = PAD_QUANTUM,
    mesh=None,
    host: bool = False,
    force_device: bool = False,
):
    """Count canonical kmers over concatenated sequences.

    host=True forces the native C++ leaf even on a device backend
    (blob-local counting: tiny inputs where device dispatch round
    trips dominate); falls through to the normal path if the native
    toolchain is unavailable.  force_device=True takes the device path
    on any backend (tests use it to run that path on the CPU).

    flat_bases: (T,) uint8 codes of all sequences back to back;
    seg_offsets: (S+1,) int64 boundaries.  Equivalent semantics to the
    reference's BigDict fill over a read set (kmers/BigKPather.cc:461-537)
    but with exact multiword kmers instead of hashed BigKMers.

    chunk_pos defaults shrink with k so that a chunk's (chunk_pos, W)
    kmer block stays a few tens of MB at W=13-17.

    mesh: optional jax.sharding.Mesh — position chunks are farmed out
    D at a time, one per chip (kmerize + leaf sort+collapse run per-chip
    under shard_map; the sorted unique runs are host-merged exactly like
    the single-chip path, so the result is bit-identical).  This is the
    multi-chip analogue of the reference's OMP task tree in the K2
    rebuild (BigKPather.cc:461-537 omp fill).
    """
    if chunk_pos is None:
        chunk_pos = (1 << 21) if k <= 64 else (1 << 19)
    T = len(flat_bases)
    W = bk.nwords(k)
    if T < k:
        empty = np.zeros((0, W), dtype=np.uint32)
        return KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k)

    if mesh is None and not force_device:
        _nlib = _native_count_lib(force=host)
        if _nlib is not None:
            return _count_kmers_flat_native(
                _nlib, flat_bases, seg_offsets, k, W, min_freq
            )

    n_pos = T - k + 1
    # small inputs: shrink the chunk onto the octave grid instead of
    # padding a tiny sequence pool to the full chunk (the pad rows cost
    # as much as real rows in the sort)
    chunk_pos = min(chunk_pos, _quantize_octave(n_pos, 4096))
    # segment id per position (host, vectorized)
    seg_of = np.searchsorted(seg_offsets, np.arange(T), side="right") - 1
    seg_end = seg_offsets[seg_of + 1]
    seg_start = seg_offsets[seg_of]

    device_pipeline = force_device or (mesh is None and device_path())

    halo = 16 * ((k + 15) // 16)

    def chunk_inputs(st):
        C = min(chunk_pos, n_pos - st)
        Cpad = chunk_pos
        cb = np.zeros(Cpad + halo, dtype=np.uint8)
        avail = min(T - st, Cpad + halo)
        cb[:avail] = flat_bases[st : st + avail]
        pos = np.arange(Cpad) + st
        posc = np.minimum(pos, T - 1)
        valid = (pos < st + C) & (pos + k <= seg_end[posc])
        hp = valid & (pos > seg_start[posc])
        hs = valid & (pos + k < seg_end[posc])
        pc = flat_bases[np.maximum(posc - 1, 0)]
        sc = flat_bases[np.minimum(posc + k, T - 1)]
        return cb, valid, hp, hs, pc, sc

    starts_all = list(range(0, n_pos, chunk_pos))

    if mesh is not None:
        from ..parallel import mesh as pmesh

        runs = []
        D = mesh.shape[pmesh.AXIS]
        for gi in range(0, len(starts_all), D):
            group = starts_all[gi : gi + D]
            ins = [chunk_inputs(st) for st in group]
            while len(ins) < D:  # pad group with all-invalid chunks
                z = chunk_inputs(group[-1])
                ins.append((z[0], np.zeros_like(z[1]), np.zeros_like(z[2]),
                            np.zeros_like(z[3]), z[4], z[5]))
            stacked = [np.stack([c[j] for c in ins]) for j in range(6)]
            ow, octx, ocnt, nu = pmesh.flat_leaf_sharded(
                mesh, *[jnp.asarray(s) for s in stacked], k=k
            )
            nu = np.asarray(nu).reshape(-1)
            ow = np.asarray(ow)
            octx = np.asarray(octx)
            ocnt = np.asarray(ocnt)
            for di in range(len(group)):
                m = int(nu[di])
                runs.append((ow[di, :m], octx[di, :m], ocnt[di, :m]))
        if not runs:
            empty = np.zeros((0, W), dtype=np.uint32)
            return KmerDict(
                empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k
            )
        words, ctx, cnt = _host_merge_all(runs)
        keep = cnt >= min_freq
        return KmerDict(
            words[keep], cnt[keep].astype(np.int32),
            ctx[keep].astype(np.uint32), k,
        )

    runs = []
    word_parts = [[] for _ in range(W)]
    payload_parts = []
    n_rows_total = 0
    for st in starts_all:
        cb, valid, hp, hs, pc, sc = chunk_inputs(st)
        cw, cctx, cvalid = kmerize_flat_chunk(
            jnp.asarray(cb),
            jnp.asarray(valid),
            jnp.asarray(hp),
            jnp.asarray(hs),
            jnp.asarray(pc),
            jnp.asarray(sc),
            k,
        )
        if device_pipeline:
            payload = jnp.where(
                cvalid, (cctx << np.uint32(8)) | np.uint32(1), 0
            )
            for j in range(W):
                word_parts[j].append(cw[:, j])
            payload_parts.append(payload)
            n_rows_total += cw.shape[0]
            continue
        ow, octx, ocnt, nu = sort_collapse_leaf(cw, cctx, W)
        nu = int(nu)
        runs.append(
            (np.asarray(ow)[:nu], np.asarray(octx)[:nu], np.asarray(ocnt)[:nu])
        )
        if os.environ.get("W2RAP_VERBOSE"):
            print(f"count_kmers_flat chunk @{st}: {nu} unique", flush=True)

    if device_pipeline:
        if n_rows_total == 0:
            empty = np.zeros((0, W), dtype=np.uint32)
            return KmerDict(
                empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k
            )
        d, _hist = _device_count_epilogue(
            word_parts, payload_parts, n_rows_total, W, k, min_freq
        )
        return d

    if not runs:
        empty = np.zeros((0, W), dtype=np.uint32)
        return KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k)
    words, ctx, cnt = _host_merge_all(runs)
    keep = cnt >= min_freq
    return KmerDict(
        words[keep], cnt[keep].astype(np.int32), ctx[keep].astype(np.uint32), k
    )


def _count_kmers_flat_native(lib, flat_bases, seg_offsets, k, W, min_freq):
    """CPU fast path of count_kmers_flat: C++ leaf counting over
    segment batches + the usual host merge (bit-identical to the
    device/XLA path; kmers never span segments so batching by whole
    segments is exact)."""
    import ctypes

    flat = np.ascontiguousarray(flat_bases, dtype=np.uint8)
    seg = np.ascontiguousarray(seg_offsets, dtype=np.int64)
    seg_len = np.diff(seg)
    pos = np.maximum(seg_len - k + 1, 0).astype(np.int64)
    S = len(seg) - 1
    MAXP = 4 << 20
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.w2rap_count_leaf_flat.restype = ctypes.c_int64
    runs = []
    i = 0
    while i < S:
        j = i
        tot = 0
        while j < S and (tot == 0 or tot + pos[j] <= MAXP):
            tot += int(pos[j])
            j += 1
        if tot == 0:
            i = j
            continue
        base = int(seg[i])
        lseg = (seg[i : j + 1] - base).astype(np.int64)
        sub = np.ascontiguousarray(flat[base : int(seg[j])])
        cap = tot
        out_w = np.empty((cap, W), dtype=np.uint32)
        out_x = np.empty(cap, dtype=np.uint8)
        out_c = np.empty(cap, dtype=np.uint8)
        m = lib.w2rap_count_leaf_flat(
            sub.ctypes.data_as(u8p),
            lseg.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(j - i), ctypes.c_int32(k), ctypes.c_int32(W),
            out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            out_x.ctypes.data_as(u8p), out_c.ctypes.data_as(u8p),
        )
        runs.append((out_w[:m].copy(), out_x[:m].copy(), out_c[:m].copy()))
        i = j
    if not runs:
        empty = np.zeros((0, W), dtype=np.uint32)
        return KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k)
    words, ctx, cnt = _host_merge_all(runs)
    keep = cnt >= min_freq
    return KmerDict(
        words[keep], cnt[keep].astype(np.int32), ctx[keep].astype(np.uint32), k
    )


# ---------------------------------------------------------------------------
# fully on-device counting: kmerize chunks on the device, one global sort
# of the whole stream, one collapse — the dictionary never crosses to the
# host unless asked for.  Reference hot loop: createDictOMPRecursive
# (src/paths/long/BuildReadQGraph.cc:1015-1110).
# ---------------------------------------------------------------------------


def _quantize_octave(n: int, align: int, steps: int = 8) -> int:
    """Round n up onto a coarse grid: `steps` points per power of two,
    aligned to `align`.  Bounds padding at 1/steps (12.5% by default)
    while collapsing the infinite family of dataset-dependent sizes onto
    a handful of shapes, so jitted programs hit the persistent compile
    cache across datasets."""
    n = max(n, align)
    p = 1 << (n.bit_length() - 1)  # largest pow2 <= n
    step = max(align, p // steps)
    return ((n + step - 1) // step) * step


def _payload_mask_core(words, ctx, W, range_bits, range_index):
    """valid-row mask + (ctx<<8)|1 payload; invalid rows become FULL
    sentinels (range_bits restricts to one canonical hash range)."""
    valid = ~bk.words_eq(words, jnp.full((1, W), FULL, dtype=jnp.uint32))
    if range_bits:
        shift = np.uint32(32 - range_bits)
        in_range = (words[:, 0] >> shift) == np.uint32(range_index)
        valid = valid & in_range
    payload = jnp.where(valid, (ctx << np.uint32(8)) | np.uint32(1), 0)
    wout = tuple(
        jnp.where(valid, words[:, j], FULL) for j in range(W)
    )
    return wout, payload


_payload_mask_jit = functools.partial(
    jax.jit, static_argnames=("W", "range_bits", "range_index")
)(_payload_mask_core)


def _concat_pad(parts, n_pad, fill):
    flat = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
    return jnp.concatenate(
        [flat, jnp.full(n_pad - flat.shape[0], fill, dtype=jnp.uint32)]
    )


@functools.partial(
    jax.jit, static_argnames=("W", "n_pad", "pad_bits", "min_freq")
)
def _sort_collapse_small_w(word_parts, payload_parts, W, n_pad, pad_bits,
                           min_freq):
    """Concatenate+pad the chunk planes, sort, collapse — one executable
    for W <= 8.  The context byte rides in the last word's pad bits when
    >= 8 of them are free (one sort operand fewer; equal kmers stay
    adjacent because the 2k kmer bits are most significant).

    word_parts: tuple of W tuples of per-chunk planes; payload_parts:
    tuple of per-chunk payload planes."""
    if pad_bits >= 8:
        planes = [_concat_pad(word_parts[j], n_pad, FULL) for j in range(W - 1)]
        last = _concat_pad(word_parts[W - 1], n_pad, FULL)
        pay = _concat_pad(payload_parts, n_pad, np.uint32(0))
        planes.append(last | ((pay >> np.uint32(8)) & np.uint32(0xFF)))
        sp = list(jax.lax.sort(planes, num_keys=W))
        ctx_sorted = sp[W - 1] & np.uint32(0xFF)
        w_last = sp[W - 1] & ~np.uint32(0xFF)
        sent = sp[0] == FULL
        for j in range(1, W - 1):
            sent = sent & (sp[j] == FULL)
        sent = sent & (w_last == (FULL & ~np.uint32(0xFF)))
        w_last = jnp.where(sent, FULL, w_last)
        payload_sorted = jnp.where(
            sent, np.uint32(0), (ctx_sorted << np.uint32(8)) | np.uint32(1)
        )
        words, pay = sp[: W - 1] + [w_last], payload_sorted
    else:
        planes = [_concat_pad(word_parts[j], n_pad, FULL) for j in range(W)]
        planes.append(_concat_pad(payload_parts, n_pad, np.uint32(0)))
        sp = list(jax.lax.sort(planes, num_keys=W))
        words, pay = sp[:W], sp[W]
    return collapse_planes(words, pay, min_freq)


def count_kmers_device(
    bases,
    lengths,
    quals,
    k: int,
    min_qual: int = 7,
    min_freq: int = 4,
    chunk_reads: int = 65536,
    range_bits: int = 0,
    range_index: int = 0,
):
    """Count canonical kmers entirely on device; returns (KmerDict, hist).

    Pipeline: kmerize (per <= chunk_reads block, the next block's host
    slice + upload overlapped on a worker thread) -> one octave-padded
    stream -> lax.sort -> collapse_planes -> a padded dictionary table
    that stays on the device (or is downloaded, see _use_device_dict).
    Counts saturate at 255 and the histogram matches count_kmers
    (reference BuildReadQGraph.cc:1095-1115).

    range_bits/range_index optionally restrict counting to kmers whose
    top word falls in one of 2**range_bits equal slices of the canonical
    kmer space — the memory-bounded multipass analogue of the
    reference's disk batches (BuildReadQGraph.cc:1120-1250).
    """
    n = bases.shape[0]
    L = bases.shape[1]
    W = bk.nwords(k)
    if L < k:
        # no kmers at all (see count_kmers: negative-P reshape guard)
        empty = np.zeros((0, W), dtype=np.uint32)
        return (
            KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k),
            np.zeros(101, dtype=np.int64),
        )

    def host_chunk(start):
        stop = min(start + chunk_reads, n)
        cb = np.asarray(bases[start:stop])
        cl = np.asarray(lengths[start:stop])
        cq = np.asarray(quals[start:stop])
        # pad partial chunks onto the octave grid (not just full chunks):
        # the kmerize program's shape must not depend on the dataset size
        # or every new dataset pays a fresh XLA compile
        n_rows_target = min(chunk_reads, _quantize_octave(cb.shape[0], 1024))
        if cb.shape[0] < n_rows_target:
            padn = n_rows_target - cb.shape[0]
            cb = np.concatenate([cb, np.zeros((padn, L), np.uint8)])
            cl = np.concatenate([cl, np.zeros(padn, np.int32)])
            cq = np.concatenate([cq, np.zeros((padn, L), np.uint8)])
        return jnp.asarray(cb), jnp.asarray(cl), jnp.asarray(cq)

    starts = list(range(0, n, chunk_reads))
    word_parts = [[] for _ in range(W)]
    payload_parts = []
    n_kmers_total = 0
    if starts:
        # double-buffer: chunk i+1's host slice + upload runs on a worker
        # thread while chunk i's kernels are in flight (the reference
        # streams reads into the kmerizer the same way,
        # BuildReadQGraph.cc:1062-1081)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(host_chunk, starts[0])
            for ci, start in enumerate(starts):
                cb_d, cl_d, cq_d = fut.result()
                if ci + 1 < len(starts):
                    fut = pool.submit(host_chunk, starts[ci + 1])
                words, ctx, _ = kmerize_chunk(cb_d, cl_d, cq_d, k, min_qual)
                wout, payload = _payload_mask_jit(
                    words, ctx, W, range_bits, range_index
                )
                for j in range(W):
                    word_parts[j].append(wout[j])
                payload_parts.append(payload)
                n_kmers_total += payload.shape[0]

    if n_kmers_total == 0:
        empty = np.zeros((0, W), dtype=np.uint32)
        return (
            KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k),
            np.zeros(101, dtype=np.int64),
        )
    return _device_count_epilogue(
        word_parts, payload_parts, n_kmers_total, W, k, min_freq
    )


def _device_count_epilogue(word_parts, payload_parts, n_kmers_total, W, k,
                           min_freq):
    """Shared tail of the on-device counting pipelines: concatenate the
    kmerized chunk planes, sort, collapse with the min_freq filter on
    device, and build the dictionary table."""
    # pad onto the octave grid so the sort program's shape is reused
    # across datasets (compile-cache hits)
    n_pad = _quantize_octave(n_kmers_total, 4096)
    pad_bits = 2 * (16 * W - k)
    if W <= 8:
        collapsed = _sort_collapse_small_w(
            tuple(tuple(p) for p in word_parts), tuple(payload_parts),
            W, n_pad, pad_bits, min_freq,
        )
        return _dict_from_collapsed(collapsed, k)

    # big W sorts as ceil((W-1)/2) 2-key stable passes (_sort_big_w)
    # instead of one (W+1)-operand variadic sort
    planes = [_concat_pad(word_parts[j], n_pad, FULL) for j in range(W)]
    pay = _concat_pad(payload_parts, n_pad, np.uint32(0))
    sorted_planes, tie_flag = _sort_big_w(planes, pay, W)
    if bool(np.asarray(tie_flag)):
        # adjacent rows equal in the first 64 bits but distinct beyond:
        # the 2-key passes cannot have fully sorted the stream — recount
        # with the exact variadic sort (astronomically rare on real
        # sequence)
        sorted_planes = list(jax.lax.sort(planes + [pay], num_keys=W))
    collapsed = _collapse_planes_jit(
        sorted_planes[:W], sorted_planes[W], min_freq=min_freq
    )
    return _dict_from_collapsed(collapsed, k)


def _sort_big_w(planes, pay, W):
    """Sort a big-W kmer stream without a W+1-operand variadic sort.  A
    STABLE sort's permutation is a pure function of its keys, so
    ceil((W-1)/2) separate 2-key stable sorts — each carrying two
    payload planes — all apply the SAME permutation; the result is
    fully sorted iff no two DISTINCT rows tie on the leading 64 bits.
    Returns (sorted planes [W words + payload], tie flag); a raised
    flag means the caller must recount with the exact sort."""
    k0, k1 = planes[0], planes[1]
    rest = planes[2:] + [pay]
    s0 = s1 = None
    out_rest = []
    for i in range(0, len(rest), 2):
        ops = [k0, k1] + rest[i : i + 2]
        sp = jax.lax.sort(ops, num_keys=2, is_stable=True)
        if s0 is None:
            s0, s1 = sp[0], sp[1]
        out_rest.extend(sp[2:])
    if s0 is None:  # W == 2: single sort, fully ordered by its keys
        s0, s1 = jax.lax.sort([k0, k1], num_keys=2, is_stable=True)
        out_rest = []
    sorted_planes = [s0, s1] + out_rest
    eq01 = (s0[1:] == s0[:-1]) & (s1[1:] == s1[:-1])
    full_eq = eq01
    for j in range(2, W):
        p = sorted_planes[j]
        full_eq = full_eq & (p[1:] == p[:-1])
    # any >=2-row leading-64-bit tie group containing distinct rows has
    # an adjacent distinct pair
    tie_flag = jnp.any(eq01 & ~full_eq)
    return sorted_planes, tie_flag


def _use_device_dict() -> bool:
    """Keep the counted dictionary resident on device (padded views the
    adjacency/unitig/pathing kernels consume directly).  On for the
    device path; W2RAP_DEV_DICT=0/1 overrides (tests force it on the
    CPU)."""
    env = os.environ.get("W2RAP_DEV_DICT")
    if env is not None:
        return env not in ("0", "false", "off")
    return device_path()


@functools.partial(jax.jit, static_argnames=("m_pad",))
def _dict_table(planes, ctx, cnt, m_pad: int):
    """The collapse outputs cut or FULL/0-padded to m_pad rows, words
    stacked to (m_pad, W)."""
    n = ctx.shape[0]

    def fit(x, fill):
        if n >= m_pad:
            return x[:m_pad]
        return jnp.concatenate([x, jnp.full(m_pad - n, fill, x.dtype)])

    words = jnp.stack([fit(p, FULL) for p in planes], axis=1)
    return words, fit(ctx, np.uint32(0)), fit(cnt, np.uint32(0))


def _dict_from_collapsed(collapsed, k):
    """(KmerDict, hist) from collapse_planes outputs.  Only the row
    count and the 101-bin histogram cross to the host; the padded table
    stays on the device (host mirrors materialize lazily) unless
    _use_device_dict() says to download it."""
    planes, ctx, cnt, m_d, hist_d = collapsed
    m = int(m_d)
    hist = np.asarray(hist_d).astype(np.int64)
    m_pad = max(DICT_QUANTUM, -(-m // DICT_QUANTUM) * DICT_QUANTUM)
    words2d, ctx_p, cnt_p = _dict_table(tuple(planes), ctx, cnt, m_pad)
    if _use_device_dict():
        dev = {"words": words2d, "ctx": ctx_p, "cnt": cnt_p,
               "m": m, "m_pad": m_pad}
        return KmerDict(None, None, None, k, dev=dev), hist
    words_h, ctx_h, cnt_h = jax.device_get((words2d, ctx_p, cnt_p))
    return (
        KmerDict(words_h[:m], cnt_h[:m].astype(np.int32),
                 ctx_h[:m].astype(np.uint32), k),
        hist,
    )


def count_kmers_batched(
    bases,
    lengths,
    quals,
    k: int,
    min_qual: int = 7,
    min_freq: int = 4,
    chunk_reads: int = 65536,
    disk_batches: int = 0,
    tmp_dir: str | None = None,
    max_mem_gb: int = 10000,
    force_device: bool = False,
):
    """Production counting entry point.

    On the device path (backend.device_path(), or force_device=True,
    which tests use to run it on the CPU) counting runs fully on device
    (count_kmers_device); on the host path the native spill counter
    (_count_kmers_spill_native).  disk_batches > 1 — or a working set
    exceeding max_mem_gb (the SetMaxMemory analogue, System.cc:1027) —
    splits the canonical kmer space into 2^b equal hash ranges counted
    in separate passes over the reads, each range optionally spilled to
    tmp_dir as npz; ranges are disjoint and ascending so the final dict
    is their concatenation.  This mirrors createDictOMPDiskBased's
    batch files + k-way merge (BuildReadQGraph.cc:1120-1250).
    """
    W = bk.nwords(k)
    n_rows = int(bases.shape[0]) * max(0, int(bases.shape[1]) - k + 1)
    bytes_needed = n_rows * 4 * (W + 1) * 3  # stream + sort ping/pong
    budget = float(max_mem_gb) * (1 << 30)
    n_batches = max(1, int(disk_batches))
    while n_batches < 256 and bytes_needed / n_batches > budget:
        n_batches *= 2
    range_bits = max(0, int(n_batches - 1).bit_length())

    use_device = force_device or device_path()

    if not force_device and (not use_device or range_bits):
        # host path always; device path when a memory ceiling forces
        # range batching (the native spill kmerizes ONCE and bounds
        # memory by range, where the device multipass would re-kmerize
        # per range AND could not shrink its sort footprint)
        _nlib = _native_count_lib(force=bool(range_bits))
        if _nlib is not None:
            # one kmerize pass spilling per-range batch files + per-range
            # C++ collapse — even when no memory ceiling forces batching:
            # the chunked-leaf alternative spends more time in the host
            # merge tree (memcmp searchsorted over void rows) than the
            # spill pays in disk IO
            return _count_kmers_spill_native(
                _nlib, bases, lengths, quals, k, W, min_qual, min_freq,
                max(range_bits, 2), tmp_dir,
            )

    def run_range(rb, ri):
        if use_device and (rb == 0 or force_device):
            return count_kmers_device(
                bases, lengths, quals, k, min_qual=min_qual,
                min_freq=min_freq, range_bits=rb, range_index=ri,
            )
        # memory-ceiling range passes: the one-shot device epilogue
        # masks out-of-range rows but cannot REMOVE them before the
        # global sort, so its footprint is the full stream regardless of
        # the range count.  The chunked leaf-sort + host-merge path
        # keeps device memory chunk-bounded — the same trade the
        # reference's disk batches make (BuildReadQGraph.cc:1120-1250).
        return count_kmers(
            bases, lengths, quals, k, min_qual=min_qual,
            min_freq=min_freq, chunk_reads=chunk_reads,
            range_bits=rb, range_index=ri,
        )

    if range_bits == 0:
        return run_range(0, 0)

    hist = np.zeros(101, dtype=np.int64)
    spills = []
    parts = []
    for ri in range(1 << range_bits):
        d, h = run_range(range_bits, ri)
        hist += h
        if tmp_dir:
            os.makedirs(tmp_dir, exist_ok=True)
            path = os.path.join(tmp_dir, f"kmer_range_{ri:04d}.npz")
            np.savez(path, words=d.words, counts=d.counts, ctx=d.ctx)
            spills.append(path)
        else:
            parts.append((d.words, d.counts, d.ctx))
    if tmp_dir:
        for path in spills:
            z = np.load(path)
            parts.append((z["words"], z["counts"], z["ctx"]))
            os.remove(path)
    words = np.concatenate([p[0] for p in parts], axis=0)
    counts = np.concatenate([p[1] for p in parts])
    ctx = np.concatenate([p[2] for p in parts])
    return KmerDict(words, counts.astype(np.int32), ctx.astype(np.uint32), k), hist


def _count_kmers_spill_native(lib, bases, lengths, quals, k, W, min_qual,
                              min_freq, range_bits, tmp_dir):
    """Native disk-batched counting: ONE kmerize pass spills rows to
    2^range_bits per-range batch files, then each range is sorted +
    collapsed independently (bounded memory).  This is the faithful
    createDictOMPDiskBased design (batch files + per-batch merge,
    BuildReadQGraph.cc:1120-1250) — unlike the device multipass, reads
    are only kmerized once."""
    import ctypes
    import tempfile

    bases = np.ascontiguousarray(bases, dtype=np.uint8)
    quals = np.ascontiguousarray(quals, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, L = bases.shape
    own_tmp = tmp_dir is None
    if own_tmp:
        tmp_dir = tempfile.mkdtemp(prefix="w2rap_spill_")
    else:
        os.makedirs(tmp_dir, exist_ok=True)
    R = 1 << range_bits
    range_counts = np.zeros(R, dtype=np.int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    nt = int(os.environ.get("OMP_NUM_THREADS", "0")) or (os.cpu_count() or 1)
    lib.w2rap_spill_ranges.restype = ctypes.c_int64
    rc = lib.w2rap_spill_ranges(
        bases.ctypes.data_as(u8p), quals.ctypes.data_as(u8p),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(n), ctypes.c_int64(L), ctypes.c_int32(k),
        ctypes.c_int32(W), ctypes.c_int32(min_qual),
        ctypes.c_int32(range_bits), tmp_dir.encode(),
        range_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(nt),
    )
    if rc != 0:
        raise OSError(f"native spill to {tmp_dir} failed")
    lib.w2rap_collapse_batch.restype = ctypes.c_int64
    hist = np.zeros(101, dtype=np.int64)

    def collapse_range(ri):
        # ctypes releases the GIL during the C call, so ranges sort in
        # parallel on the worker pool (omp-parallel batch collapse,
        # BuildReadQGraph.cc:1210-1250)
        path = os.path.join(tmp_dir, f"kmer_batch_{ri:04d}.bin")
        n_rows = int(range_counts[ri])
        if n_rows == 0:
            os.remove(path)
            return None
        out_w = np.empty((n_rows, W), dtype=np.uint32)
        out_x = np.empty(n_rows, dtype=np.uint8)
        out_c = np.empty(n_rows, dtype=np.uint8)
        m = lib.w2rap_collapse_batch(
            path.encode(), ctypes.c_int64(n_rows), ctypes.c_int32(W),
            out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            out_x.ctypes.data_as(u8p), out_c.ctypes.data_as(u8p),
            ctypes.c_int32(range_bits),
        )
        if m < 0:
            raise OSError(f"native batch collapse of {path} failed")
        os.remove(path)
        cnt = out_c[:m]
        h = np.zeros(101, dtype=np.int64)
        np.add.at(h, np.minimum(cnt, 100), 1)
        keep = cnt >= min_freq
        return (out_w[:m][keep].copy(), cnt[keep].copy(),
                out_x[:m][keep].copy(), h)

    parts = []
    try:
        from concurrent.futures import ThreadPoolExecutor

        nt = int(os.environ.get("OMP_NUM_THREADS", "0")) or (
            os.cpu_count() or 1
        )
        with ThreadPoolExecutor(max_workers=max(1, min(nt, R))) as pool:
            results = list(pool.map(collapse_range, range(R)))
        for res in results:  # range order => ascending, deterministic
            if res is None:
                continue
            parts.append(res[:3])
            hist += res[3]
    except BaseException:
        # don't leak the per-range batch files (or an owned tmp dir) if
        # a collapse fails partway
        for rj in range(R):
            p = os.path.join(tmp_dir, f"kmer_batch_{rj:04d}.bin")
            try:
                os.remove(p)
            except OSError:
                pass
        if own_tmp:
            try:
                os.rmdir(tmp_dir)
            except OSError:
                pass
        raise
    hist[0] = 0
    if own_tmp:
        try:
            os.rmdir(tmp_dir)
        except OSError:
            pass
    if not parts:
        empty = np.zeros((0, W), dtype=np.uint32)
        return (
            KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k),
            hist,
        )
    words = np.concatenate([p[0] for p in parts], axis=0)
    counts = np.concatenate([p[1] for p in parts])
    ctx = np.concatenate([p[2] for p in parts])
    return (
        KmerDict(words, counts.astype(np.int32), ctx.astype(np.uint32), k),
        hist,
    )


DICT_QUANTUM = 1 << 20


def padded_dict_views(d, quantum: int = DICT_QUANTUM):
    """Device views of the dictionary padded to a size quantum.

    Padding rows are all-FULL sentinels (they sort after every valid kmer
    and can never equal a query, so binary search is unaffected), with
    ctx 0 and kdef fields 0.  Keeps jit cache keys stable across datasets,
    so the lookup programs compile once per size quantum.
    Returns (words_pad, ctx_pad, kdef_pad tuple or None, m_pad).

    Device-resident dicts (d.dev, the device counting path) return their
    on-device padded views directly — no host copies; the
    kdef planes are uploaded once the first time they're requested
    after graph construction fills them.
    """
    if d.dev is not None:
        dev = d.dev
        if d.edge_id is not None and "kdef" not in dev:
            import jax.numpy as _jnp

            m_, mp_ = dev["m"], dev["m_pad"]
            eid = np.zeros(mp_, dtype=np.int32)
            eid[:m_] = d.edge_id
            eoff = np.zeros(mp_, dtype=np.int32)
            eoff[:m_] = d.edge_offset
            erc = np.zeros(mp_, dtype=bool)
            erc[:m_] = d.edge_rc
            dev["kdef"] = (
                _jnp.asarray(eid), _jnp.asarray(eoff), _jnp.asarray(erc)
            )
        return dev["words"], dev["ctx"], dev.get("kdef"), dev["m_pad"]
    m = d.size
    W = d.words.shape[1] if d.words.ndim == 2 else bk.nwords(d.k)
    m_pad = max(quantum, ((m + quantum - 1) // quantum) * quantum)
    words = np.full((m_pad, W), FULL, dtype=np.uint32)
    words[:m] = d.words
    ctx = np.zeros(m_pad, dtype=np.uint32)
    ctx[:m] = d.ctx
    kdef = None
    if d.edge_id is not None:
        eid = np.zeros(m_pad, dtype=np.int32)
        eid[:m] = d.edge_id
        eoff = np.zeros(m_pad, dtype=np.int32)
        eoff[:m] = d.edge_offset
        erc = np.zeros(m_pad, dtype=bool)
        erc[:m] = d.edge_rc
        kdef = (eid, eoff, erc)
    return words, ctx, kdef, m_pad
