"""Pathing of exact sequences (flat layout) through an HBV.

Used by step 3 to walk each place sequence through the freshly built
large-K graph — the data-parallel replacement for the reference's KmerPath
interval-database translation (Repath.cc:140-196): since every place
sequence is by construction a walk in the graph, a dense per-position
lookup run-decodes directly into the edge list + start/stop offsets.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import bitkmer as bk
from ..ops import kmer_engine as ke
from ..ops import lookup


def _lookup_flat_core(
    bases, table_t, kdef_edge, kdef_off, kdef_rc, fwd_xlat, rev_xlat, ekm,
    k: int, n_iters: int,
):
    C = bases.shape[0] - 16 * ((k + 15) // 16)
    packed = ke.pack_rows(bases[None, :])
    words = ke.kmer_windows(packed, k, C)[0]
    canon, is_rev = bk.canonicalize(words, k)
    idx, found = lookup._search(table_t, canon.T, n_iters)
    e0 = kdef_edge[idx]
    off0 = kdef_off[idx]
    erc = kdef_rc[idx]
    rc = is_rev ^ erc
    hbv_e = jnp.where(rc, rev_xlat[e0], fwd_xlat[e0]).astype(jnp.int32)
    ekm_e = ekm[e0].astype(jnp.int32)
    off = jnp.where(rc, ekm_e - 1 - off0, off0).astype(jnp.int32)
    hbv_e = jnp.where(found, hbv_e, -1)
    return hbv_e, off


_lookup_flat_chunk = functools.partial(
    jax.jit, static_argnames=("k", "n_iters")
)(_lookup_flat_core)


def _path_flat_native_fill(lib, flat_bases, seg_offsets, d, hbv,
                           fwd_xlat, rev_xlat, k, all_e, all_o):
    """One C++ pass over all segments filling the (n_pos,) oriented
    edge/offset planes (native/path_kernel.cc:w2rap_path_flat)."""
    import ctypes
    import os

    flat = np.ascontiguousarray(flat_bases, dtype=np.uint8)
    seg = np.ascontiguousarray(seg_offsets, dtype=np.int64)
    words = np.ascontiguousarray(d.words, dtype=np.uint32)
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
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.w2rap_path_flat.restype = ctypes.c_int64
    lib.w2rap_path_flat(
        flat.ctypes.data_as(u8p), seg.ctypes.data_as(i64p),
        ctypes.c_int64(len(seg) - 1), ctypes.c_int32(k),
        ctypes.c_int32(words.shape[1] if words.ndim == 2 else 1),
        words.ctypes.data_as(u32p), ctypes.c_int64(d.size),
        eid.ctypes.data_as(i32p), eoff.ctypes.data_as(i32p),
        erc.ctypes.data_as(u8p), fx.ctypes.data_as(i32p),
        rx.ctypes.data_as(i32p), ekm.ctypes.data_as(i32p),
        ctypes.c_int64(len(ekm)), ctypes.c_int32(nt),
        all_e.ctypes.data_as(i32p), all_o.ctypes.data_as(i32p),
    )


def path_flat_sequences(
    flat_bases, seg_offsets, d, hbv, fwd_xlat, rev_xlat,
    chunk_pos: int | None = None, host: bool = False, mesh=None,
):
    """Walk each segment through the graph.

    Returns (paths: list of np.int32 arrays, starts (S,) int32,
    stops (S,) int32) where starts = base offset of the segment on its
    first edge, stops = bases of the last edge after the segment's final
    kmer (Repath.cc starts/stops semantics, Repath.cc:196-200).
    Segments shorter than k or containing missing kmers get empty paths.

    host=True runs the per-position lookup in pure numpy (blob-local
    graphs: tiny inputs where per-op device dispatch dominates).

    mesh: optional jax.sharding.Mesh — position chunks are decoded D at
    a time, one per chip, with the dictionary replicated (the multi-chip
    form of Repath.cc:140-196's translation loop); bit-identical to
    single-chip.
    """
    k = d.k
    if chunk_pos is None:
        chunk_pos = (1 << 21) if k <= 64 else (1 << 19)
    T = len(flat_bases)
    S = len(seg_offsets) - 1
    n_pos = max(T - k + 1, 0)
    native_done = False
    all_e = np.full(n_pos, -1, dtype=np.int32)
    all_o = np.zeros(n_pos, dtype=np.int32)
    if mesh is None and n_pos > 0:
        # native C++ pather (same predictor+search machinery as read
        # pathing) — the XLA per-position lookup was 15s of the
        # north-star step-3 wall, the host numpy fallback similar
        from . import pather as _pather

        nlib = _pather._native_path_lib(force=d.dev is None or host)
        if nlib is not None:
            _path_flat_native_fill(
                nlib, flat_bases, seg_offsets, d, hbv, fwd_xlat,
                rev_xlat, k, all_e, all_o,
            )
            native_done = True
    if mesh is not None and n_pos > 0:
        from ..parallel import mesh as pmesh

        # clamp the chunk to the octave-quantized per-chip load so every
        # chip gets work even on small inputs (cf. mesh.count_kmers_sharded)
        D = mesh.shape[pmesh.AXIS]
        chunk_pos = min(
            chunk_pos, ke._quantize_octave(max(1, -(-n_pos // D)), 1024)
        )
    if native_done:
        pass
    elif host:
        from ..graph.build import _rows_bytes, _search_host

        tb = _rows_bytes(d.words)
        kd_e = np.asarray(d.edge_id)
        kd_o = np.asarray(d.edge_offset)
        kd_r = np.asarray(d.edge_rc)
        fxh = np.asarray(fwd_xlat)
        rxh = np.asarray(rev_xlat)
        ekm_h = (np.diff(hbv.edge_start) - k + 1)[fwd_xlat].astype(np.int32)
        if n_pos > 0:
            win = np.lib.stride_tricks.sliding_window_view(
                np.asarray(flat_bases), k
            )[:n_pos]
            words = bk.pack_codes(np.ascontiguousarray(win), k)
            canon, is_rev = bk.canonicalize(words, k)
            idx, found = _search_host(tb, canon)
            e0 = kd_e[idx]
            rc = is_rev ^ kd_r[idx]
            he = np.where(rc, rxh[e0], fxh[e0]).astype(np.int32)
            ekm_e = ekm_h[e0].astype(np.int32)
            all_o[:] = np.where(
                rc, ekm_e - 1 - kd_o[idx], kd_o[idx]
            ).astype(np.int32)
            all_e[:] = np.where(found, he, -1).astype(np.int32)
    else:
        wp, cp, kdef, mp = ke.padded_dict_views(d)
        n_iters = max(1, int(np.ceil(np.log2(mp + 1))))
        halo = 16 * ((k + 15) // 16)

        table_t = jnp.asarray(wp).T
        kdef_edge = jnp.asarray(kdef[0])
        kdef_off = jnp.asarray(kdef[1])
        kdef_rc = jnp.asarray(kdef[2])
        fx = jnp.asarray(fwd_xlat)
        rx = jnp.asarray(rev_xlat)
        ekm_canon = jnp.asarray(
            (np.diff(hbv.edge_start) - k + 1)[fwd_xlat].astype(np.int32)
        )

        starts_list = list(range(0, n_pos, chunk_pos))
        if mesh is not None and len(starts_list) > 1:
            from ..parallel import mesh as pmesh

            D = mesh.shape[pmesh.AXIS]
            lookup_sh = pmesh.make_lookup_flat_sharded(mesh, k, n_iters)
            for g in range(0, len(starts_list), D):
                grp = starts_list[g : g + D]
                cbs = np.zeros((D, chunk_pos + halo), dtype=np.uint8)
                for i, s in enumerate(grp):
                    avail = min(T - s, chunk_pos + halo)
                    cbs[i, :avail] = flat_bases[s : s + avail]
                he, off = lookup_sh(
                    jnp.asarray(cbs), table_t, kdef_edge, kdef_off,
                    kdef_rc, fx, rx, ekm_canon,
                )
                he = np.asarray(he)
                off = np.asarray(off)
                for i, s in enumerate(grp):
                    C = min(chunk_pos, n_pos - s)
                    all_e[s : s + C] = he[i, :C]
                    all_o[s : s + C] = off[i, :C]
            starts_list = []
        for s in starts_list:
            C = min(chunk_pos, n_pos - s)
            cb = np.zeros(chunk_pos + halo, dtype=np.uint8)
            avail = min(T - s, chunk_pos + halo)
            cb[:avail] = flat_bases[s : s + avail]
            he, off = _lookup_flat_chunk(
                jnp.asarray(cb), table_t, kdef_edge, kdef_off, kdef_rc,
                fx, rx, ekm_canon, k, n_iters,
            )
            all_e[s : s + C] = np.asarray(he[:C])
            all_o[s : s + C] = np.asarray(off[:C])

    # ---- segment decode, vectorized over all segments at once ---------
    kmers_b = np.diff(hbv.edge_start) - k + 1
    starts = np.zeros(S, dtype=np.int32)
    stops = np.zeros(S, dtype=np.int32)
    seg_a = seg_offsets[:-1].astype(np.int64)
    seg_np = np.maximum(seg_offsets[1:] - seg_a - k + 1, 0)
    # flat index ranges of each segment's positions
    tot = int(seg_np.sum())
    if tot == 0:
        return [np.zeros(0, np.int32) for _ in range(S)], starts, stops
    sid = np.repeat(np.arange(S), seg_np)
    within = np.arange(tot) - np.repeat(np.cumsum(seg_np) - seg_np, seg_np)
    gpos = np.repeat(seg_a, seg_np) + within
    e = all_e[gpos]
    o = all_o[gpos]
    # a segment is walkable iff every position hit the dictionary
    seg_ok = np.ones(S, dtype=bool)
    np.logical_and.at(seg_ok, sid, e >= 0)
    first = within == 0
    newrun = first | (
        np.concatenate([[True], (e[1:] != e[:-1]) | (o[1:] != o[:-1] + 1)])
    )
    runs = newrun & seg_ok[sid]
    run_idx = np.flatnonzero(runs)
    pool = e[run_idx].astype(np.int32)
    pc = np.zeros(S, dtype=np.int64)
    np.add.at(pc, sid[run_idx], 1)
    poff = np.zeros(S + 1, dtype=np.int64)
    poff[1:] = np.cumsum(pc)
    paths = [pool[poff[si] : poff[si + 1]] for si in range(S)]
    # starts/stops from each valid segment's first/last position
    lastpos = np.cumsum(seg_np) - 1
    firstpos = lastpos - seg_np + 1
    has = (seg_np > 0) & seg_ok
    starts[has] = o[firstpos[has]]
    e_last = e[lastpos[has]]
    stops[has] = kmers_b[e_last] - 1 - o[lastpos[has]]
    return paths, starts, stops
