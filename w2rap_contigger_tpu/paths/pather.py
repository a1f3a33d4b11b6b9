"""Read pathing: dense batched lookup + run-length decode.

Replaces the reference's seed-and-extend BRQ_Pather + path_reads_OMP
(src/paths/long/BuildReadQGraph.cc:494-560,829-940) with a data-parallel
formulation: every kmer position of every read is looked up in the sorted
dictionary at once; PathParts are recovered as maximal runs of
consecutive (edge, offset) hits.  This is exactly equivalent to the
reference's matchLen-based extension because unitig edges are chains of
dictionary kmers: bases match the edge through position p+len iff the
kmers at p..p+len-1 are that edge's kmers at consecutive offsets.

Reproduced quirks (deliberately, for parity):
* the hanging-seed-to-gap conversion is dead code in the reference
  (path_reads_OMP fills both toLeft AND toRight from hbv.ToLeft,
  BuildReadQGraph.cc:838-840, making its condition unsatisfiable), so we
  skip it;
* isJoinable compares the LAST K-1 bases of both edges
  (BuildReadQGraph.cc:552-558) — not prev-tail vs next-head — so
  captured gaps spanning distinct edges are usually judged unjoinable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bitkmer as bk
from ..ops import kmer_engine as ke
from ..ops import lookup
from .read_paths import ReadPathVec

MAX_JITTER = 3  # BuildReadQGraph.cc:831


def _lookup_core(
    packed, lengths, table_t, kdef_edge, kdef_off, kdef_rc,
    fwd_xlat, rev_xlat, ekm, k: int, n_iters: int, L: int,
):
    """Per-position oriented-edge lookup from 2-bit packed read rows.

    Returns (hbv_edge (N,P) int32 [-1 miss, -2 invalid], off (N,P) int32
    kmer-unit offset on the oriented edge, ekm_at (N,P) int32).
    """
    n = packed.shape[0]
    P = L - k + 1
    if P <= 0:
        # callers must pre-filter (path_reads/_raw_parts return empty
        # paths when max_len < k); a negative P here would surface as an
        # opaque `reshape new_sizes must all be positive` deep in XLA
        raise ValueError(f"pather lookup needs L >= k (L={L}, k={k})")
    words = ke.kmer_windows(packed, k, P)
    canon, is_rev = bk.canonicalize(words, k)

    flat = canon.reshape(n * P, -1)
    idx, found = lookup._search(table_t, flat.T, n_iters)
    idx = idx.reshape(n, P)
    found = found.reshape(n, P)

    e0 = kdef_edge[idx]
    off0 = kdef_off[idx]
    erc = kdef_rc[idx]
    rc = is_rev ^ erc
    hbv_e = jnp.where(rc, rev_xlat[e0], fwd_xlat[e0]).astype(jnp.int32)
    ekm_e = ekm[e0].astype(jnp.int32)
    off = jnp.where(rc, ekm_e - 1 - off0, off0).astype(jnp.int32)

    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    hbv_e = jnp.where(found, hbv_e, -1)
    hbv_e = jnp.where(valid, hbv_e, -2)
    return hbv_e, off, ekm_e


@functools.partial(jax.jit, static_argnames=("k", "n_iters"))
def _lookup_chunk(
    bases,
    lengths,
    table_t,
    kdef_edge,
    kdef_off,
    kdef_rc,
    fwd_xlat,
    rev_xlat,
    ekm,
    k: int,
    n_iters: int,
):
    """Dense-plane lookup from byte codes (fallback path)."""
    return _lookup_core(
        ke.pack_rows(bases), lengths, table_t, kdef_edge, kdef_off,
        kdef_rc, fwd_xlat, rev_xlat, ekm, k, n_iters, bases.shape[1],
    )


RUN_SLOTS = 24  # per-read run-start capacity of the compact download


def _lookup_compact_impl(
    packed,
    lengths,
    table_t,
    kdef_edge,
    kdef_off,
    kdef_rc,
    fwd_xlat,
    rev_xlat,
    ekm,
    k: int,
    n_iters: int,
    L: int,
):
    """Lookup + on-device run-start compaction, from 2-bit packed rows.

    The dense (N, P) lookup planes are ~50x larger than the run-start
    parts they decode to (reads have a handful of PathParts each,
    BuildReadQGraph.cc:497-560), so the decode's boundary detection runs
    on device and only the first RUN_SLOTS run starts per read are
    downloaded; the reads ride up as packed rows (4x smaller than byte
    codes).
    Returns (pos_s, e_s, off_s, ekm_s (N, S) int32, nruns (N,) int32);
    a read with nruns > slots signals the caller to fall back to the
    dense path for the chunk.
    """
    hbv_e, off, ekm_e = _lookup_core(
        packed, lengths, table_t, kdef_edge, kdef_off, kdef_rc,
        fwd_xlat, rev_xlat, ekm, k, n_iters, L,
    )
    n, P = hbv_e.shape
    prev_e = jnp.concatenate(
        [jnp.full((n, 1), -3, jnp.int32), hbv_e[:, :-1]], axis=1
    )
    prev_o = jnp.concatenate(
        [jnp.zeros((n, 1), jnp.int32), off[:, :-1]], axis=1
    )
    in_range = hbv_e != -2
    new_run = in_range & (
        (hbv_e != prev_e) | ((hbv_e >= 0) & (off != prev_o + 1))
    )
    nruns = jnp.sum(new_run.astype(jnp.int32), axis=1)
    # first S run starts per read: descending key <=> ascending position
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    key = jnp.where(new_run, P - pos, 0)
    _, idx_s = jax.lax.top_k(key, min(RUN_SLOTS, P))  # (N, S)
    pos_s = idx_s.astype(jnp.int32)
    e_s = jnp.take_along_axis(hbv_e, idx_s, axis=1)
    off_s = jnp.take_along_axis(off, idx_s, axis=1)
    ekm_s = jnp.take_along_axis(ekm_e, idx_s, axis=1)
    return pos_s, e_s, off_s, ekm_s, nruns


_lookup_compact_chunk = functools.partial(
    jax.jit, static_argnames=("k", "n_iters", "L")
)(_lookup_compact_impl)


def _decode_chunk(hbv_e, off, ekm, lengths, k, tail_words, tail_W):
    """Run-length decode + reference heuristics -> per-read paths.

    All numpy, vectorized over the flattened parts table.
    Returns (list of edge-arrays, list of offsets) for the chunk.
    """
    n, P = hbv_e.shape
    # run starts: first valid position of each read, edge change, or
    # non-consecutive offset within the same edge
    prev_e = np.concatenate([np.full((n, 1), -3, np.int32), hbv_e[:, :-1]], 1)
    prev_o = np.concatenate([np.zeros((n, 1), np.int32), off[:, :-1]], 1)
    in_range = hbv_e != -2
    new_run = in_range & (
        (hbv_e != prev_e) | ((hbv_e >= 0) & (off != prev_o + 1))
    )

    rid_m, pos_m = np.nonzero(new_run)
    part_edge = hbv_e[rid_m, pos_m]
    part_off = off[rid_m, pos_m]
    part_ekm = ekm[rid_m, pos_m]
    return _parts_to_paths(
        rid_m, pos_m, part_edge, part_off, part_ekm,
        lengths, k, tail_words, n,
    )


def _decode_compact(pos_s, e_s, off_s, ekm_s, nruns, lengths, k, tail_words):
    """Decode from the compact per-read run-start slots (numpy)."""
    n, S = pos_s.shape
    slot = np.arange(S)[None, :]
    m = slot < nruns[:, None]
    rid_m, slot_m = np.nonzero(m)  # row-major: sorted by (read, slot=pos)
    return _parts_to_paths(
        rid_m,
        pos_s[rid_m, slot_m],
        e_s[rid_m, slot_m],
        off_s[rid_m, slot_m],
        ekm_s[rid_m, slot_m],
        lengths, k, tail_words, n,
    )


def _parts_to_paths(
    rid_m, pos_m, part_edge, part_off, part_ekm, lengths, k, tail_words, n
):
    """Shared decode tail: flat parts table (sorted by read, position) ->
    ReadPath arrays, with the reference's captured-gap conformance,
    isJoinable and weak-seed heuristics (BuildReadQGraph.cc:845-940)."""
    if len(rid_m) == 0:
        return (
            np.zeros(0, np.int32),
            np.zeros(n + 1, np.int64),
            np.zeros(n, np.int32),
        )
    # run length: next run start (or end of valid region) - start
    n_valid = np.maximum(lengths - k + 1, 0)
    next_start = np.concatenate([pos_m[1:], [0]])
    last_of_read = np.concatenate([rid_m[1:] != rid_m[:-1], [True]])
    part_len = np.where(
        last_of_read, n_valid[rid_m] - pos_m, next_start - pos_m
    ).astype(np.int64)

    is_seed = part_edge >= 0

    # per-read part segmentation
    first_of_read = np.concatenate([[True], rid_m[1:] != rid_m[:-1]])
    read_first_idx = np.flatnonzero(first_of_read)
    pcount = np.diff(np.concatenate([read_first_idx, [len(rid_m)]]))
    local_idx = np.arange(len(rid_m)) - np.repeat(read_first_idx, pcount)
    reads_with_parts = rid_m[read_first_idx]

    # ---- 3b: captured-gap conformance + joinability ------------------
    nparts = len(rid_m)
    interior = (
        (local_idx > 0)
        & (np.concatenate([local_idx[1:] > 0, [False]]))  # not last of read
        & ~is_seed
        & (part_edge == -1)
    )
    # neighbors are flat i-1, i+1 (same read guaranteed by interior mask)
    im1 = np.clip(np.arange(nparts) - 1, 0, nparts - 1)
    ip1 = np.clip(np.arange(nparts) + 1, 0, nparts - 1)
    interior &= is_seed[im1] & is_seed[ip1]
    same_edge = part_edge[im1] == part_edge[ip1]
    graph_dist = part_off[ip1] - (part_off[im1] + part_len[im1])
    graph_dist = graph_dist + np.where(same_edge, 0, part_ekm[im1])
    conforming = np.abs(part_len - graph_dist) <= MAX_JITTER
    # isJoinable (reference quirk: last K-1 bases of BOTH edges)
    e1 = np.clip(part_edge[im1], 0, None)
    e2 = np.clip(part_edge[ip1], 0, None)
    joinable = same_edge | np.all(
        tail_words[e1] == tail_words[e2], axis=1
    )
    bad = interior & ~(conforming & joinable)

    # first bad junction per read (reference `break` after handling one)
    INF = np.int64(1 << 60)
    first_bad = np.full(n, INF, dtype=np.int64)
    np.minimum.at(first_bad, rid_m[bad], local_idx[bad])

    # seeds strictly before the bad junction
    seed_cum = np.cumsum(is_seed)  # inclusive prefix over flat parts
    base_cum = np.repeat(
        seed_cum[read_first_idx] - is_seed[read_first_idx], pcount
    )
    seeds_before_flat = seed_cum - base_cum - is_seed  # seeds with idx < this
    # at the bad part (a gap), seeds_before = seeds seen before it
    bad_flags = bad & (local_idx == first_bad[rid_m])
    cutoff = np.full(n, INF, dtype=np.int64)
    # keep local parts with idx < cutoff
    cut_rid = rid_m[bad_flags]
    cut_seeds = seeds_before_flat[bad_flags]
    cut_j = local_idx[bad_flags]
    cutoff[cut_rid] = np.where(cut_seeds > 1, cut_j - 1, cut_j)

    keep = local_idx < cutoff[rid_m]

    # ---- 3c: weak terminal seed backoff ------------------------------
    kept_seed = keep & is_seed
    # last kept seed per read
    last_seed_idx = np.full(n, -1, dtype=np.int64)
    np.maximum.at(last_seed_idx, rid_m[kept_seed], np.flatnonzero(kept_seed))
    ls = last_seed_idx[last_seed_idx >= 0]
    weak = (part_off[ls] == 0) & (part_len[ls] <= 5)
    drop_flat = ls[weak]
    keep[drop_flat] = False

    # ---- ReadPath assembly -------------------------------------------
    kept = keep & is_seed
    # dedupe: same hbv edge as previous kept seed of the same read
    kidx = np.flatnonzero(kept)
    if len(kidx):
        krid = rid_m[kidx]
        kedge = part_edge[kidx]
        same_as_prev = np.concatenate(
            [[False], (krid[1:] == krid[:-1]) & (kedge[1:] == kedge[:-1])]
        )
        kidx = kidx[~same_as_prev]

    # offsets: based on (possibly truncated) parts list
    start_off = np.zeros(n, dtype=np.int32)
    # first kept part per read == first part (truncation only cuts tails;
    # cutoff >= 1 always because bad junctions have local_idx >= 1)
    fp = read_first_idx
    fp_seed = is_seed[fp]
    # seed case: offset = first part's edge offset
    start_off[reads_with_parts[fp_seed]] = part_off[fp[fp_seed]]
    # gap-first case: offset = parts[1].off - gap_len (if parts[1] kept+seed)
    gap_first = ~fp_seed
    gf = fp[gap_first]
    gf_rid = reads_with_parts[gap_first]
    has_second = (gf + 1 < nparts) & (
        np.concatenate([rid_m[1:], [-1]])[gf] == gf_rid
    )
    sec = np.clip(gf + 1, 0, nparts - 1)
    sec_kept_seed = has_second & keep[sec] & is_seed[sec]
    start_off[gf_rid[sec_kept_seed]] = (
        part_off[sec[sec_kept_seed]] - part_len[gf[sec_kept_seed]]
    )

    # build ragged outputs
    path_edges = part_edge[kidx] if len(kidx) else np.zeros(0, np.int32)
    path_rid = rid_m[kidx] if len(kidx) else np.zeros(0, np.int64)
    counts = np.bincount(path_rid, minlength=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts)
    # reads with empty path get offset 0 (reference ReadPath default)
    start_off[counts == 0] = 0
    return path_edges.astype(np.int32), offs, start_off


def edge_tail_words(hbv):
    """(E, W) packed last-(K-1)-bases of every HBV edge (isJoinable aid)."""
    k = hbv.k
    ko = k - 1
    E = hbv.n_edges
    tails = np.zeros((E, ko), dtype=np.uint8)
    for e in range(E):
        s = hbv.edge_start[e + 1]
        tails[e] = hbv.edge_bases[s - ko : s]
    return bk.pack_codes(tails, ko)


def _native_path_lib(force: bool = False):
    """C++ pathing lookup (native/path_kernel.cc) — the CPU backend's
    fast path (XLA-CPU's batched dictionary binary search was the
    parity-mode wall after counting went native).  Returns the loaded
    library or None (env W2RAP_NATIVE_PATH=0 disables)."""
    import os

    if os.environ.get("W2RAP_NATIVE_PATH", "1") in ("0", "false", "off"):
        return None
    if not force:
        from ..backend import device_path

        if device_path():
            return None
    from .. import native

    return native.load("w2rappath", ["path_kernel.cc"], libs=["pthread"])


def _path_reads_native(lib, reads, d, hbv, fwd_xlat, rev_xlat, k,
                       tail_words) -> ReadPathVec:
    """One C++ pass over all reads producing the same compact run-start
    slots as _lookup_compact_impl; decode is the shared numpy tail, so
    paths are bit-identical to the device path."""
    import ctypes
    import os

    n = reads.n_reads
    L = reads.max_len
    bases = np.ascontiguousarray(reads.bases, dtype=np.uint8)
    lengths = np.ascontiguousarray(reads.lengths, dtype=np.int32)
    words = np.ascontiguousarray(d.words, dtype=np.uint32)
    m = d.size
    eid = np.ascontiguousarray(d.edge_id, dtype=np.int32)
    eoff = np.ascontiguousarray(d.edge_offset, dtype=np.int32)
    erc = np.ascontiguousarray(d.edge_rc, dtype=np.uint8)
    fx = np.ascontiguousarray(fwd_xlat, dtype=np.int32)
    rx = np.ascontiguousarray(rev_xlat, dtype=np.int32)
    ekm = np.ascontiguousarray(
        (np.diff(hbv.edge_start) - k + 1)[fwd_xlat].astype(np.int32)
    )
    nt = int(os.environ.get("OMP_NUM_THREADS", "0")) or (os.cpu_count() or 1)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.w2rap_path_leaf.restype = ctypes.c_int32

    S = RUN_SLOTS
    while True:
        pos_s = np.zeros((n, S), dtype=np.int32)
        e_s = np.zeros((n, S), dtype=np.int32)
        off_s = np.zeros((n, S), dtype=np.int32)
        ekm_s = np.zeros((n, S), dtype=np.int32)
        nruns = np.zeros(n, dtype=np.int32)
        mx = lib.w2rap_path_leaf(
            bases.ctypes.data_as(u8p), lengths.ctypes.data_as(i32p),
            ctypes.c_int64(n), ctypes.c_int64(L), ctypes.c_int32(k),
            ctypes.c_int32(words.shape[1] if words.ndim == 2 else 1),
            words.ctypes.data_as(u32p), ctypes.c_int64(m),
            eid.ctypes.data_as(i32p), eoff.ctypes.data_as(i32p),
            erc.ctypes.data_as(u8p), fx.ctypes.data_as(i32p),
            rx.ctypes.data_as(i32p), ekm.ctypes.data_as(i32p),
            ctypes.c_int64(len(ekm)), ctypes.c_int32(S),
            ctypes.c_int32(nt),
            pos_s.ctypes.data_as(i32p), e_s.ctypes.data_as(i32p),
            off_s.ctypes.data_as(i32p), ekm_s.ctypes.data_as(i32p),
            nruns.ctypes.data_as(i32p),
        )
        if mx <= S:
            break
        # rare: a read overflowed the slots; re-run with room for it
        S = 8 * ((int(mx) + 7) // 8)
    pe, offs, so = _decode_compact(
        pos_s, e_s, off_s, ekm_s, nruns, lengths, k, tail_words
    )
    return ReadPathVec(offs, pe.astype(np.int32), so)


def path_reads(
    reads, d, hbv, fwd_xlat, rev_xlat, chunk_reads: int = 262144,
    force_dense: bool = False, mesh=None,
) -> ReadPathVec:
    """Path every read through the HBV (step-2 read pathing).

    reads: core.reads.ReadSet; d: KmerDict with edge_id/offset/rc filled;
    hbv + xlat from graph.build.build_hbv_from_edges.

    mesh: optional jax.sharding.Mesh — pathing is embarrassingly
    data-parallel over reads (the reference's path_reads_OMP,
    BuildReadQGraph.cc:829-940): each chip looks up its read shard
    against the replicated dictionary under shard_map; the compact
    run-start decode stays on host and is order-identical, so the
    resulting paths are bit-identical to single-chip.
    """
    k = d.k
    n = reads.n_reads
    L = reads.max_len
    if L < k:
        # reads shorter than k contain no kmer at all: every path is
        # empty (the reference's pather finds no seed for them either,
        # BuildReadQGraph.cc:497-505).  Hit in practice by AddNewStuff's
        # re-pathing when K exceeds the read length (K=260 on 250bp
        # reads), which otherwise crashes on a negative position count.
        return ReadPathVec(
            np.zeros(n + 1, dtype=np.int64),
            np.zeros(0, dtype=np.int32),
            np.zeros(n, dtype=np.int32),
        )
    if mesh is None and not force_dense:
        # host dicts route to the native C++ pather on any backend (a
        # device lookup would first have to upload the whole table)
        nlib = _native_path_lib(force=d.dev is None)
        if nlib is not None:
            return _path_reads_native(
                nlib, reads, d, hbv, fwd_xlat, rev_xlat, k,
                edge_tail_words(hbv),
            )

    wp, cp, kdef, mp = ke.padded_dict_views(d)
    n_iters = max(1, int(np.ceil(np.log2(mp + 1))))

    table_t = jnp.asarray(wp).T
    kdef_edge = jnp.asarray(kdef[0])
    kdef_off = jnp.asarray(kdef[1])
    kdef_rc = jnp.asarray(kdef[2])
    fwd_x = jnp.asarray(fwd_xlat)
    rev_x = jnp.asarray(rev_xlat)
    ekm_canon = jnp.asarray(
        (np.diff(hbv.edge_start) - k + 1)[fwd_xlat].astype(np.int32)
    )
    tail_words = edge_tail_words(hbv)

    lookup_fn = None
    if mesh is not None:
        from ..parallel import mesh as pmesh

        D = mesh.shape[pmesh.AXIS]
        lookup_fn = pmesh.make_lookup_compact_sharded(mesh, k, n_iters, L)

    all_edges = []
    all_offs = []
    all_start = []
    for start in range(0, n, chunk_reads):
        stop = min(start + chunk_reads, n)
        # pad partial chunks onto the octave grid so the lookup
        # program's shape is dataset-independent (compile-cache hits)
        nb = min(chunk_reads, ke._quantize_octave(stop - start, 1024))
        cb = np.zeros((nb, L), dtype=np.uint8)
        cl = np.zeros(nb, dtype=np.int32)
        cb[: stop - start] = reads.bases[start:stop]
        cl[: stop - start] = reads.lengths[start:stop]
        dp = jnp.asarray(ke.pack_rows_host(cb))
        dl = jnp.asarray(cl)
        if lookup_fn is not None and nb % D == 0:
            pos_s, e_s, off_s, ekm_s, nruns = lookup_fn(
                dp, dl, table_t, kdef_edge, kdef_off, kdef_rc,
                fwd_x, rev_x, ekm_canon,
            )
        else:
            pos_s, e_s, off_s, ekm_s, nruns = _lookup_compact_chunk(
                dp, dl, table_t, kdef_edge, kdef_off, kdef_rc,
                fwd_x, rev_x, ekm_canon, k, n_iters, L,
            )
        nruns = np.asarray(nruns)
        if not force_dense and int(nruns.max(initial=0)) <= int(
            pos_s.shape[1]
        ):
            pe, offs, so = _decode_compact(
                np.asarray(pos_s), np.asarray(e_s), np.asarray(off_s),
                np.asarray(ekm_s), nruns, cl, k, tail_words,
            )
        else:
            # a read overflowed the compact slots: dense fallback
            he, off, ekm_at = _lookup_chunk(
                jnp.asarray(cb), dl, table_t, kdef_edge, kdef_off, kdef_rc,
                fwd_x, rev_x, ekm_canon, k, n_iters,
            )
            pe, offs, so = _decode_chunk(
                np.asarray(he),
                np.asarray(off),
                np.asarray(ekm_at),
                cl,
                k,
                tail_words,
                tail_words.shape[1],
            )
        real = stop - start
        all_edges.append(pe[: offs[real]])
        all_offs.append(np.diff(offs[: real + 1]))
        all_start.append(so[:real])

    flat = np.concatenate(all_edges) if all_edges else np.zeros(0, np.int32)
    lens = np.concatenate(all_offs) if all_offs else np.zeros(0, np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)
    starts = (
        np.concatenate(all_start) if all_start else np.zeros(0, np.int32)
    )
    return ReadPathVec(offsets, flat, starts)
