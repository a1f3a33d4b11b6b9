"""Multi-chip scaling: kmer-space sharding over a jax.sharding.Mesh.

The reference is single-node OpenMP (SURVEY.md §5.8); the multi-device
equivalent shards reads data-parallel across chips, counts kmers locally,
then exchanges kmers by hash range (NVLink all-to-all) so each chip owns a disjoint
canonical-kmer range — the all-to-all analogue of the reference's
disk-batch k-way merge (BuildReadQGraph.cc:1120-1250).

Design (shard_map over mesh axis "d"):
  1. per-chip kmerize+canonicalize local read shard,
  2. bucket kmers by hash(first word) >> bits == target chip,
  3. ragged all-to-all via fixed-capacity buckets (psum-validated),
  4. per-chip sort+collapse of its owned range,
  5. psum for the global frequency histogram.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import bitkmer as bk
from ..ops import kmer_engine as ke

AXIS = "d"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def auto_mesh(shard_devices: int = -1) -> Mesh | None:
    """Production mesh selection for the pipeline driver.

    shard_devices: -1 = auto (shard over all devices when more than one
    is visible), 0 = force single-chip, N>1 = force an N-device mesh.
    The env var W2RAP_SHARD overrides (same encoding).  Device counts
    are clamped to the largest power of two <= available so read-chunk
    quanta (multiples of 1024) always divide evenly.
    """
    import os

    env = os.environ.get("W2RAP_SHARD")
    if env is not None:
        shard_devices = int(env)
    if shard_devices == 0:
        return None
    avail = len(jax.devices())
    want = avail if shard_devices < 0 else min(shard_devices, avail)
    if want <= 1:
        return None
    d = 1 << (want.bit_length() - 1)  # largest pow2 <= want
    return make_mesh(d) if d > 1 else None


def _bucket_of(words, n_buckets):
    """Cheap mixing hash of the leading kmer word -> bucket id.

    Leading bases are biased (real sequence), so mix with a Murmur-style
    finalizer before taking the top bits.
    """
    h = words[..., 0]
    h = (h ^ (h >> 16)) * np.uint32(0x7FEB352D)
    h = (h ^ (h >> 15)) * np.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return (h % np.uint32(n_buckets)).astype(jnp.int32)


def count_kmers_sharded(
    bases,
    lengths,
    quals,
    k: int,
    mesh: Mesh,
    min_qual: int = 7,
    min_freq: int = 4,
    chunk_reads: int = 16384,
    cap_factor: float = 2.0,
):
    """Production multi-chip counting: returns (KmerDict, hist) equal to
    ops.kmer_engine.count_kmers on the same reads.

    Per chunk of D*chunk_reads reads: each chip kmerizes its read shard,
    kmers travel to their hash-owner chip via one all-to-all, and
    each chip sort+collapses what it owns.  Bucket capacity overflow is
    DETECTED (psum of per-bucket loads) and the chunk retried at twice
    the capacity — kmers are never silently dropped.  Host-side, the
    per-chip sorted unique runs (disjoint within a chunk) are merged by
    the same balanced merge tree the single-chip path uses; counts
    saturate at 255 and min_freq filters only the final dictionary
    (reference semantics: createDictOMPDiskBased + root filter,
    BuildReadQGraph.cc:1095-1250).
    """
    D = mesh.shape[AXIS]
    n = bases.shape[0]
    L = bases.shape[1]
    W = bk.nwords(k)
    if L < k:
        # no kmers (see ke.count_kmers: negative-P reshape guard)
        empty = np.zeros((0, W), dtype=np.uint32)
        return (
            ke.KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k),
            np.zeros(101, dtype=np.int64),
        )
    P_pos = L - k + 1
    # clamp the per-chip chunk to the (octave-quantized) actual load so
    # small inputs don't pad to the full production chunk
    chunk_reads = min(
        chunk_reads, ke._quantize_octave(max(1, -(-n // D)), 128)
    )
    chunk = chunk_reads * D

    runs = []
    for start in range(0, max(n, 1), chunk):
        stop = min(start + chunk, n)
        if stop <= start:
            break
        cb = np.zeros((chunk, L), dtype=np.uint8)
        cl = np.zeros(chunk, dtype=np.int32)
        cq = np.zeros((chunk, L), dtype=np.uint8)
        cb[: stop - start] = bases[start:stop]
        cl[: stop - start] = lengths[start:stop]
        cq[: stop - start] = quals[start:stop]
        cap = max(128, int(cap_factor * chunk_reads * P_pos / D))
        while True:
            ow, octx, ocnt, nu, over = _sharded_chunk_step(
                jnp.asarray(cb), jnp.asarray(cl), jnp.asarray(cq),
                k, mesh, min_qual, cap,
            )
            if int(np.asarray(over)[0]) == 0:
                break
            cap *= 2  # retry: capacity was exceeded on some chip
        ow = np.asarray(ow)
        octx = np.asarray(octx)
        ocnt = np.asarray(ocnt)
        nu = np.asarray(nu)
        per_rows = ow.shape[0] // D
        for d_ in range(D):
            m = int(nu[d_])
            lo = d_ * per_rows
            runs.append(
                (ow[lo : lo + m], octx[lo : lo + m], ocnt[lo : lo + m])
            )

    if not runs:
        empty = np.zeros((0, W), dtype=np.uint32)
        return (
            ke.KmerDict(empty, np.zeros(0, np.int32), np.zeros(0, np.uint32), k),
            np.zeros(101, dtype=np.int64),
        )
    words, ctx, cnt = ke._host_merge_all(runs)
    hist = np.zeros(101, dtype=np.int64)
    if cnt.size:
        np.add.at(hist, np.minimum(cnt, 100), 1)
    hist[0] = 0
    keep = cnt >= min_freq
    d = ke.KmerDict(
        words[keep], cnt[keep].astype(np.int32), ctx[keep].astype(np.uint32), k
    )
    return d, hist


def _sharded_chunk_step(bases, lengths, quals, k, mesh, min_qual, cap):
    """One all-to-all counting chunk.  Returns per-chip (sorted unique
    words (D*rows, W), ctx, cnt, n_unique (D,), overflow (D,) [replicated
    psum — nonzero iff any bucket anywhere exceeded cap])."""
    return _chunk_step_fn(mesh, k, min_qual, cap)(bases, lengths, quals)


# The sharded steps below are jitted whole and cached per mesh and static
# arguments: a shard_map called outside jit runs its body op by op, one
# compiled program per operation.
@functools.lru_cache(maxsize=None)
def _chunk_step_fn(mesh, k, min_qual, cap):
    D = mesh.shape[AXIS]
    W = bk.nwords(k)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.P(AXIS), jax.P(AXIS), jax.P(AXIS)),
        out_specs=(
            jax.P(AXIS), jax.P(AXIS), jax.P(AXIS), jax.P(AXIS), jax.P(AXIS),
        ),
    )
    def step(b, l, q):
        words, ctx, valid = ke.kmerize_chunk(b, l, q, k, min_qual)
        M = words.shape[0]
        bucket = _bucket_of(words, D)
        bucket = jnp.where(valid, bucket, D)  # invalid -> dropped

        order = jnp.argsort(bucket, stable=True)
        sw = words[order]
        sctx = ctx[order]
        sb = bucket[order]
        counts = jnp.bincount(sb, length=D + 1)[:D]
        overflow = jnp.sum((counts > cap).astype(jnp.int32))
        overflow = jax.lax.psum(overflow, AXIS)
        starts = jnp.concatenate(
            [jnp.zeros(1, jnp.int32), jnp.cumsum(counts).astype(jnp.int32)[:-1]]
        )

        idx = starts[:, None] + jnp.arange(cap)[None, :]
        within = jnp.arange(cap)[None, :] < counts[:, None]
        idxc = jnp.clip(idx, 0, M - 1)
        send_w = jnp.where(within[..., None], sw[idxc], ke.FULL)
        send_c = jnp.where(within, sctx[idxc], 0)
        send_n = within.astype(jnp.int32)

        recv_w = jax.lax.all_to_all(send_w, AXIS, 0, 0, tiled=False)
        recv_c = jax.lax.all_to_all(send_c, AXIS, 0, 0, tiled=False)
        recv_n = jax.lax.all_to_all(send_n, AXIS, 0, 0, tiled=False)

        rw = recv_w.reshape(D * cap, W)
        rc = recv_c.reshape(D * cap)
        rn = recv_n.reshape(D * cap)
        ow, octx, ocnt, nu = ke.sort_collapse(rw, rc, rn, W)
        return ow, octx, ocnt, nu[None], overflow[None]

    return jax.jit(step)


def flat_leaf_sharded(mesh: Mesh, cb, valid, hp, hs, pc, sc, k: int):
    """One group of D flat-position chunks, kmerized + leaf-sorted one
    per chip (step-3 K2 counting fan-out; the host merges the returned
    runs).  Inputs are stacked (D, ...) host arrays; returns per-chip
    (sorted unique words (D, C, W), ctx (D, C), counts (D, C),
    n_unique (D,))."""
    return _flat_leaf_fn(mesh, k)(cb, valid, hp, hs, pc, sc)


@functools.lru_cache(maxsize=None)
def _flat_leaf_fn(mesh, k):
    W = bk.nwords(k)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.P(AXIS),) * 6,
        out_specs=(jax.P(AXIS),) * 4,
        check_vma=False,  # per-chip only; no collectives inside
    )
    def step(b, v, p_, s_, pcd, scd):
        cw, cctx, _ = ke._kmerize_flat_impl(
            b[0], v[0], p_[0], s_[0], pcd[0], scd[0], k
        )
        ow, octx, ocnt, nu = ke._sort_collapse_leaf_impl(cw, cctx, W)
        return ow[None], octx[None], ocnt[None], nu[None, None]

    return jax.jit(step)


def build_links_sharded(mesh: Mesh, words, ctx, k: int, n_iters: int):
    """Unitig link construction sharded over the oriented node space
    (graph.build._links_core slices; table replicated) — the multi-chip
    form of the EdgeBuilder adjacency walk's lookup storm
    (BuildReadQGraph.cc:195-337).  Bit-identical to single-chip: chips
    compute disjoint contiguous slices of next[] that concatenate along
    the mesh axis."""
    D = mesh.shape[AXIS]
    assert (2 * words.shape[0]) % D == 0  # quantum-padded, D a power of 2
    return _links_fn(mesh, k, n_iters)(words, ctx)


@functools.lru_cache(maxsize=None)
def _links_fn(mesh, k, n_iters):
    from ..graph import build as gb

    D = mesh.shape[AXIS]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.P(), jax.P()),
        out_specs=jax.P(AXIS),
        check_vma=False,  # per-chip disjoint slices; no collectives
    )
    def step(w, c):
        per = (2 * w.shape[0]) // D
        di = jax.lax.axis_index(AXIS)
        node_ids = di * per + jnp.arange(per, dtype=jnp.int32)
        return gb._links_core(w, c, k, n_iters, node_ids)

    return jax.jit(step)


def recompute_adjacencies_sharded(mesh: Mesh, words, ctx, k: int,
                                  n_iters: int):
    """Adjacency pruning (8 dictionary searches per kmer) with rows
    sharded across chips and the table replicated (the AdjProc loop,
    kmers/ReadPather.h:307-342).  Bit-identical to single-chip."""
    assert words.shape[0] % mesh.shape[AXIS] == 0
    return _adjacencies_fn(mesh, k, n_iters)(words, words, ctx)


@functools.lru_cache(maxsize=None)
def _adjacencies_fn(mesh, k, n_iters):
    from ..graph import build as gb

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.P(), jax.P(AXIS), jax.P(AXIS)),
        out_specs=jax.P(AXIS),
        check_vma=False,  # per-chip disjoint rows; no collectives
    )
    def step(w_full, w_rows, c_rows):
        return gb._adjacencies_core(w_full, w_rows, c_rows, k, n_iters)

    return jax.jit(step)


def list_rank_sharded(mesh: Mesh, nxt, n_iters: int):
    """Pointer-doubling list ranking with node rows sharded and one
    tiled all-gather per doubling round (graph.build._list_rank_dev's
    multi-chip form).

    Each round reads ptr/dist at arbitrary node indices, so chips
    exchange their shard (all_gather) and then gather locally: the
    random-access gather bandwidth — the phase's actual wall — splits D
    ways while the all-gather moves ~2 x array bytes per round.
    Bit-identical to single-chip: integer pointer jumping with a
    deterministic schedule.  Returns (head, rank, on_cycle) sharded
    along the mesh axis (concatenating = the single-chip result).
    """
    # quantum-padded node space, D a power of 2
    assert nxt.shape[0] % (2 * mesh.shape[AXIS]) == 0
    return _rank_fn(mesh, n_iters)(nxt)


@functools.lru_cache(maxsize=None)
def _rank_fn(mesh, n_iters):
    D = mesh.shape[AXIS]

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(jax.P(),),
        out_specs=(jax.P(AXIS),) * 3,
    )
    def step(nxt_full):
        N2 = nxt_full.shape[0]
        M = N2 // 2
        per = N2 // D
        di = jax.lax.axis_index(AXIS)
        n = (di * per + jnp.arange(per, dtype=jnp.int32)).astype(jnp.int32)
        rc_n = jnp.where(n < M, n + M, n - M)
        nxt_rc = nxt_full[rc_n]
        prev_sh = jnp.where(
            nxt_rc >= 0, jnp.where(nxt_rc < M, nxt_rc + M, nxt_rc - M), -1
        )
        ptr_sh = jnp.where(prev_sh >= 0, prev_sh, n)
        dist_sh = (prev_sh >= 0).astype(jnp.int32)

        def body(_, state):
            ptr_s, dist_s = state
            ptr_full = jax.lax.all_gather(ptr_s, AXIS, tiled=True)
            dist_full = jax.lax.all_gather(dist_s, AXIS, tiled=True)
            dist_s = dist_s + dist_full[ptr_s]
            ptr_s = ptr_full[ptr_s]
            return ptr_s, dist_s

        ptr_sh, dist_sh = jax.lax.fori_loop(
            0, n_iters, body, (ptr_sh, dist_sh)
        )
        # on_cycle: the final pointer still has a predecessor
        rc_p = jnp.where(ptr_sh < M, ptr_sh + M, ptr_sh - M)
        nxt_rc_p = nxt_full[rc_p]
        prev_of_ptr = jnp.where(
            nxt_rc_p >= 0,
            jnp.where(nxt_rc_p < M, nxt_rc_p + M, nxt_rc_p - M),
            -1,
        )
        return ptr_sh, dist_sh, prev_of_ptr >= 0

    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def make_lookup_flat_sharded(mesh: Mesh, k: int, n_iters: int):
    """Step-3 place-walk translation lookups, D position-chunks at a
    time, one per chip, dictionary + translation tables replicated (the
    multi-chip form of the reference's KmerPath translation loop,
    Repath.cc:140-196).  Bit-identical: each chip decodes a disjoint
    contiguous chunk of the flat position space."""
    from ..paths import flat_pather as _fp

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            jax.P(AXIS),
            jax.P(), jax.P(), jax.P(), jax.P(), jax.P(), jax.P(), jax.P(),
        ),
        out_specs=(jax.P(AXIS),) * 2,
        check_vma=False,  # per-chip disjoint chunks; no collectives
    )
    def step(cb, table_t, kdef_edge, kdef_off, kdef_rc, fwd_x, rev_x, ekm):
        he, off = _fp._lookup_flat_core(
            cb[0], table_t, kdef_edge, kdef_off, kdef_rc, fwd_x, rev_x,
            ekm, k, n_iters,
        )
        return he[None], off[None]

    return jax.jit(step)


@functools.lru_cache(maxsize=None)
def make_lookup_compact_sharded(mesh: Mesh, k: int, n_iters: int, L: int):
    """Sharded read-pathing lookup: reads data-parallel on the mesh,
    dictionary + translation tables replicated (the multi-chip form of
    path_reads_OMP, BuildReadQGraph.cc:829-940).  Returns a function with
    the same signature/outputs as pather._lookup_compact_chunk minus the
    static args."""
    from ..paths import pather as _pather

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            jax.P(AXIS), jax.P(AXIS),
            jax.P(), jax.P(), jax.P(), jax.P(), jax.P(), jax.P(), jax.P(),
        ),
        out_specs=(jax.P(AXIS),) * 5,
        check_vma=False,  # scan carries start replicated; no collectives
    )
    def step(packed, lengths, table_t, kdef_edge, kdef_off, kdef_rc,
             fwd_x, rev_x, ekm):
        return _pather._lookup_compact_impl(
            packed, lengths, table_t, kdef_edge, kdef_off, kdef_rc,
            fwd_x, rev_x, ekm, k, n_iters, L,
        )

    return jax.jit(step)
