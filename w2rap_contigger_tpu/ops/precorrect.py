"""Pre-correction — the K=25 center-base voting corrector.

Reference: pre_correct_parallel over naif_kmer's KernelPreCorrector
(src/paths/FindErrorsCore.cc:57, src/kmers/naif_kmer/KernelPreCorrector.h)
with PC_Params defaults (FindErrorsCore.h:19-37): n_kmers_min=6,
q_high=20, n_q_high_max_to_lose=1, q_sum_min_to_win=60, ratio_loser=0.25.

Semantics: every read position p contributes its 25-mer; occurrences are
grouped by the canonical 24-base FLANK (center base excluded, rc-aware);
per group, the center-base column is voted by quality sums; a base loses
(gets corrected to the winner) when the winner's q_sum >= 60, the loser
has <= 1 quality>=20 observation, and q_sum[loser] < 0.25 * winner.
Flank-palindromic groups and groups smaller than 6 are skipped.

Data-parallel design: the flank is packed into 2 uint32 words (24 bases);
one lax.sort groups all occurrences; per-base q_sum / n_q_high come from
segmented-cumsum differences; the fix mask and winner are elementwise.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import bitkmer as bk
from . import kmer_engine as ke

from ..config import DEFAULT as _H

PC_K = _H.PC_K
CENTER = PC_K // 2  # 12
FLANK = PC_K - 1  # 24 bases -> 2 uint32 words
N_KMERS_MIN = _H.PC_N_KMERS_MIN
Q_HIGH = _H.PC_Q_HIGH
N_Q_HIGH_MAX_TO_LOSE = _H.PC_N_Q_HIGH_MAX_TO_LOSE
Q_SUM_MIN_TO_WIN = _H.PC_Q_SUM_MIN_TO_WIN
RATIO_LOSER = _H.PC_RATIO_LOSER

FULL = np.uint32(0xFFFFFFFF)


@functools.partial(jax.jit, static_argnames=())
def _flank_windows(bases, lengths):
    """Per-position canonical flank words + center base/qual payloads.

    bases: (N, L) uint8.  Returns (words (N*P, 2) uint32 canonical flank
    [FULL sentinel when invalid], payload (N*P,) uint32 packed
    [read-local row data are returned separately], center (N*P,) uint32,
    qual handled by caller).
    """
    n, L = bases.shape
    P = L - PC_K + 1
    packed = ke.pack_rows(bases)
    w25 = ke.kmer_windows(packed, PC_K, P)  # (N, P, 2) since 25<=32
    # 25 bases span 2 words; flank = remove center base (position 12).
    # word0 holds bases 0..15 (bits 31..0), word1 bases 16..24 (top 18 bits).
    w0 = w25[:, :, 0]
    w1 = w25[:, :, 1]
    # center base = base 12 of word0: bits (30-24)..(31-24) -> shift 6
    center = (w0 >> np.uint32(6)) & np.uint32(3)
    # flank packing: bases 0..11 keep their bits; bases 13..15 of w0 shift
    # up by 2; then base 16.. follow from w1.
    top12 = w0 & np.uint32(0xFFFFFF00)  # bases 0..11 (24 bits)
    mid3 = (w0 << np.uint32(2)) & np.uint32(0x000000FC)  # bases 13..15
    f0 = top12 | mid3 | (w1 >> np.uint32(30))  # + base 16 in low 2 bits
    f1 = (w1 << np.uint32(2)) & FULL  # bases 17..24 at top 16 bits
    # flank has 24 bases -> words (f0 full 32 bits = 16 bases, f1 top 16
    # bits = 8 bases); pad bits must be zero:
    f1 = f1 & np.uint32(0xFFFF0000)
    flank = jnp.stack([f0, f1], axis=-1)  # (N, P, 2)
    canon, is_rev = bk.canonicalize(flank, FLANK)
    pal = bk.is_palindrome(flank, FLANK)
    center_canon = jnp.where(is_rev, center ^ np.uint32(3), center)
    return canon, center_canon, is_rev, pal


@functools.partial(jax.jit, static_argnames=())
def _vote(words, center, qual, valid):
    """Group by sorted flank; vote center column; return fix info.

    words: (M, 2) uint32 canonical flanks (sentinel FULL when invalid)
    center: (M,) uint32 canonical-orientation center base
    qual: (M,) uint32
    valid: (M,) bool
    Returns (row_id sorted-order originals, fix mask, winner base) —
    caller maps back via the returned permutation.
    """
    M = words.shape[0]
    iota = jnp.arange(M, dtype=jnp.int32)
    ops = [words[:, 0], words[:, 1], center, qual, iota.astype(jnp.uint32)]
    s = jax.lax.sort(ops, num_keys=2)
    sw = jnp.stack(s[:2], axis=-1)
    sc = s[2]
    sq = s[3]
    sid = s[4].astype(jnp.int32)

    prev = jnp.roll(sw, 1, axis=0)
    is_start = ~bk.words_eq(sw, prev)
    is_start = is_start.at[0].set(True)
    jidx = jnp.arange(M, dtype=jnp.int32)
    seg_start_idx = jax.lax.cummax(jnp.where(is_start, jidx, 0), axis=0)

    sentinel = bk.words_eq(sw, jnp.full((1, 2), FULL, dtype=jnp.uint32))
    vrow = ~sentinel

    def seg_total(x):
        cs = jnp.cumsum(x)
        scan = cs - cs[seg_start_idx] + x[seg_start_idx]
        # segment end index: next segment's start - 1
        rep = jnp.zeros(M, dtype=jnp.int32).at[
            jnp.cumsum(is_start.astype(jnp.int32)) - 1
        ].max(jidx)
        seg_of = jnp.cumsum(is_start.astype(jnp.int32)) - 1
        return scan[rep[seg_of]]

    nrows = seg_total(vrow.astype(jnp.int32))
    qsums = []
    nqhigh = []
    for b in range(4):
        sel = (sc == b) & vrow
        qsums.append(seg_total(jnp.where(sel, sq, 0).astype(jnp.int32)))
        nqhigh.append(
            seg_total((sel & (sq >= Q_HIGH)).astype(jnp.int32))
        )
    qsum = jnp.stack(qsums, axis=-1)  # (M, 4) per-row segment totals
    nqh = jnp.stack(nqhigh, axis=-1)

    winner = jnp.argmax(qsum, axis=-1).astype(jnp.uint32)
    # argmax picks lowest index on ties == reference's > comparisons
    qwin = jnp.max(qsum, axis=-1)
    own = jnp.take_along_axis(qsum, sc[:, None].astype(jnp.int32), axis=1)[:, 0]
    own_qh = jnp.take_along_axis(nqh, sc[:, None].astype(jnp.int32), axis=1)[:, 0]
    fix = (
        vrow
        & (nrows >= N_KMERS_MIN)
        & (qwin >= Q_SUM_MIN_TO_WIN)
        & (sc != winner)
        & (own_qh <= N_Q_HIGH_MAX_TO_LOSE)
        & (own.astype(jnp.float32) < RATIO_LOSER * qwin.astype(jnp.float32))
    )
    return sid, fix, winner


def pre_correct(reads, chunk_reads: int = 16384):
    """Apply pre-correction to a ReadSet; returns (new_bases, n_fixed).

    All reads are processed in one grouping space (chunked kmerization,
    single global sort per chunk-group is approximated by per-chunk
    sorting when the read set is large; for step-5 local blobs the whole
    set fits one chunk, matching the reference's per-blob usage in
    CorrectionSuite, LoadCorrectCore.cc:171).
    """
    bases = reads.bases
    quals = reads.quals
    lengths = reads.lengths
    n, L = bases.shape
    if L < PC_K:
        return bases.copy(), 0
    P = L - PC_K + 1

    new_bases = bases.copy()
    n_fixed = 0
    # quantize the row count so the jitted kernels see a handful of
    # shapes across blobs (step 5 calls this once per blob; a fresh
    # XLA compile per distinct blob size dominated the correction wall)
    nq = ke._quantize_octave(n, 128)
    if nq != n:
        bases = np.concatenate(
            [bases, np.zeros((nq - n, L), np.uint8)]
        )
        quals = np.concatenate([quals, np.zeros((nq - n, L), quals.dtype)])
        lengths = np.concatenate([lengths, np.zeros(nq - n, lengths.dtype)])
        n = nq
    # one global pass (single sort over all positions)
    canon, center, is_rev, pal = _flank_windows(
        jnp.asarray(bases), jnp.asarray(lengths)
    )
    pos = np.arange(P)[None, :]
    valid_np = (pos <= (lengths[:, None] - PC_K)) & ~np.asarray(pal)
    qual_center = np.zeros((n, P), dtype=np.uint32)
    centers_idx = pos + CENTER
    qual_center = np.take_along_axis(
        quals, np.broadcast_to(centers_idx, (n, P)), axis=1
    ).astype(np.uint32)

    M = n * P
    wordsf = np.array(canon).reshape(M, 2)
    centerf = np.asarray(center).reshape(M)
    isrevf = np.asarray(is_rev).reshape(M)
    validf = valid_np.reshape(M)
    wordsf[~validf] = FULL
    qualf = qual_center.reshape(M)

    sid, fix, winner = _vote(
        jnp.asarray(wordsf),
        jnp.asarray(np.where(validf, centerf, 0)),
        jnp.asarray(np.where(validf, qualf, 0)),
        jnp.asarray(validf),
    )
    sid = np.asarray(sid)
    fix = np.asarray(fix)
    winner = np.asarray(winner)

    hit = np.flatnonzero(fix)
    rows = sid[hit]
    rid = rows // P
    ppos = rows % P
    newb = winner[hit].astype(np.uint8)
    # un-canonicalize: if the occurrence was rc, complement the winner
    rc = isrevf[rows]
    newb = np.where(rc, 3 - newb, newb)
    new_bases[rid, ppos + CENTER] = newb
    return new_bases, len(hit)
