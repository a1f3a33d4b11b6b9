"""Pairwise aligners — banded / free(fitting) / affine Smith-Waterman.

Reference: ``src/pairwise_aligners/SmithWatBandedA.h:23-32`` (penalty
minimization, mis=2, gap=3, band around an expected offset),
``SmithWatFree.h:14-31`` (fit a short sequence inside a longer one,
optionally penalizing left/right outer gaps), ``SmithWatAffine.h:22-36``
(global alignment, mismatch 3 / gap-open 12 / gap-extend 1). All
reference scoring is integer penalty sums; we keep int32 math.

Data-parallel redesign: the hot use is many small alignments at once (friend
alignment stacks, gap patching), so the device path is a **batched
banded DP** — the band is a fixed-width lane dimension, rows advance
under ``jax.lax.scan``, and the whole thing ``vmap``s over the batch.
Shapes are static (bandwidth and max length are compile-time); padding
rows are masked. Traceback (irregular, sequential) runs host-side from
the device-computed cost surface, mirroring the §7.1 split of dense
scoring on the device / pointer-chasing on host.
"""

from __future__ import annotations

import numpy as np

BIG = np.int32(1 << 28)


# ------------------------------------------------------------------ banded

def sw_banded(S, T, offset: int, bandwidth: int, mis: int = 2, gap: int = 3):
    """Fitting alignment of S inside T, restricted to the diagonal band
    ``j - i in [offset-bandwidth, offset+bandwidth]`` (j indexes T).

    Returns (best_cost, errors, pos_S, pos_T, ops) where ops is a list of
    ('M'|'I'|'D', length) blocks; 'I' consumes S only (insertion in S),
    'D' consumes T only. T's prefix/suffix outside the alignment are
    free, as in the reference's use of SmithWatBandedA for read-vs-edge
    placement (SmithWatBandedA.h:23-32).
    """
    S = np.asarray(S, dtype=np.int8)
    T = np.asarray(T, dtype=np.int8)
    D, lo = _banded_matrix(S, T, offset, bandwidth, mis, gap)
    n, W = len(S), 2 * bandwidth + 1
    # best end on the last row
    bs = np.argmin(D[n])
    best = int(D[n, bs])
    # traceback
    i, b = n, int(bs)
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    while i > 0:
        j = i + lo + b
        if j > 0 and 0 <= b < W and D[i, b] == D[i - 1, b] + (
                mis if S[i - 1] != T[j - 1] else 0):
            push("M")
            i -= 1
        elif b + 1 < W and D[i, b] == D[i - 1, b + 1] + gap:
            push("I")
            i -= 1
            b += 1
        elif b - 1 >= 0 and j > 0 and D[i, b] == D[i, b - 1] + gap:
            push("D")
            b -= 1
        else:  # free leading T-gap row 0 not reachable with i>0
            push("I")
            i -= 1
            b += 1
    ops.reverse()
    pos_T = max(0, lo + b)
    errors = _count_errors(S, T, pos_T, ops)
    return best, errors, 0, pos_T, [(o, l) for o, l in ops]


def _count_errors(S, T, j0, ops) -> int:
    i = j = 0
    errs = 0
    for op, l in ops:
        if op == "M":
            errs += int(np.sum(S[i:i + l] != T[j0 + j:j0 + j + l]))
            i += l
            j += l
        elif op == "I":
            errs += l
            i += l
        else:
            errs += l
            j += l
    return errs


def _banded_matrix(S, T, offset, bandwidth, mis, gap):
    """(n+1, W) cost matrix in band coordinates b = j - i - lo,
    lo = offset - bandwidth. Row 0 is free (T prefix unpenalized)."""
    n, m = len(S), len(T)
    W = 2 * bandwidth + 1
    lo = offset - bandwidth
    D = np.full((n + 1, W), BIG, dtype=np.int32)
    j0 = np.arange(W) + lo  # j at row i: i + lo + b
    valid0 = (j0 >= 0) & (j0 <= m)
    D[0, valid0] = 0
    for i in range(1, n + 1):
        j = i + lo + np.arange(W)
        ok = (j >= 1) & (j <= m)
        sub = np.where(ok, np.where(
            S[i - 1] == T[np.clip(j - 1, 0, m - 1)], 0, mis), BIG)
        diag = D[i - 1] + sub
        up = np.concatenate([D[i - 1, 1:], [BIG]]) + gap
        row = np.minimum(diag, up)
        # left moves within the row: prefix-min with +gap per step
        for b in range(1, W):
            if row[b - 1] + gap < row[b]:
                row[b] = row[b - 1] + gap
        row[~ok & (j != 0)] = BIG
        # j == 0 cells on row i mean the whole prefix S[:i] is inserted
        row[j == 0] = gap * i
        D[i] = np.minimum(row, BIG)
    return D, lo


def banded_costs_batch(Ss, Ts, lens_s, lens_t, offset: int, bandwidth: int,
                       mis: int = 2, gap: int = 3):
    """Device path: batched banded cost surfaces.

    Ss: (B, Ls) int8 padded, Ts: (B, Lt) int8 padded. Returns
    (B, Ls+1, W) int32 cost tensors (band coordinates as in
    :func:`_banded_matrix`); final costs = min over the row at
    ``lens_s``. jit/vmap-friendly: static shapes, ``lax.scan`` over
    rows, the in-row gap chain as a W-step ``fori_loop``-free min-scan
    (associative scan over (min,+)).
    """
    import jax
    import jax.numpy as jnp

    W = 2 * bandwidth + 1
    lo = offset - bandwidth

    def one(S, T, ns, nt):
        Ls = S.shape[0]
        b = jnp.arange(W)

        def row_step(prev, i):
            j = i + lo + b
            ok = (j >= 1) & (j <= nt) & (i <= ns)
            sc = T[jnp.clip(j - 1, 0, T.shape[0] - 1)]
            sub = jnp.where(S[i - 1] == sc, 0, mis)
            diag = prev + jnp.where(ok, sub, BIG)
            up = jnp.concatenate([prev[1:], jnp.full((1,), BIG)]) + gap
            row = jnp.minimum(diag, up)
            # left-gap chain: min-plus prefix scan along the band
            def combine(a, c):
                # carry = best row value so far, each step adds one gap
                return jnp.minimum(a + gap, c), jnp.minimum(a + gap, c)
            _, chained = jax.lax.scan(combine, jnp.int32(BIG), row)
            row = jnp.minimum(row, chained)
            row = jnp.where(ok | (j == 0), row, BIG)
            row = jnp.where(j == 0, gap * i, row)
            row = jnp.where(i <= ns, row, prev)
            return jnp.minimum(row, BIG), jnp.minimum(row, BIG)

        j0 = lo + b
        row0 = jnp.where((j0 >= 0) & (j0 <= nt), 0, BIG).astype(jnp.int32)
        _, rows = jax.lax.scan(row_step, row0,
                               jnp.arange(1, Ls + 1, dtype=jnp.int32))
        return jnp.concatenate([row0[None], rows], axis=0)

    return jax.vmap(one)(jnp.asarray(Ss, dtype=jnp.int8),
                         jnp.asarray(Ts, dtype=jnp.int8),
                         jnp.asarray(lens_s, dtype=jnp.int32),
                         jnp.asarray(lens_t, dtype=jnp.int32))


# ------------------------------------------------------------------ free

def sw_free(S, T, penalize_left_gap: bool = False,
            penalize_right_gap: bool = False, mis: int = 2, gap: int = 3,
            outer_gap: int = 3):
    """SmithWatFree parity (SmithWatFree.h:14-31): align all of S inside
    T; T's outer gaps cost ``outer_gap`` per base when penalized, else 0.
    Returns (best_cost, pos_T, ops)."""
    S = np.asarray(S, dtype=np.int8)
    T = np.asarray(T, dtype=np.int8)
    n, m = len(S), len(T)
    D = np.full((n + 1, m + 1), BIG, dtype=np.int64)
    D[0, :] = np.arange(m + 1) * (outer_gap if penalize_left_gap else 0)
    D[1:, 0] = np.arange(1, n + 1) * gap
    for i in range(1, n + 1):
        sub = np.where(S[i - 1] == T, 0, mis)
        out = np.empty(m, dtype=np.int64)
        best = D[i, 0]
        for j in range(m):
            v = min(D[i - 1, j] + sub[j], D[i - 1, j + 1] + gap, best + gap)
            out[j] = v
            best = v
        D[i, 1:] = out
    tail = (np.arange(m, -1, -1) * (outer_gap if penalize_right_gap else 0))
    ends = D[n] + tail
    j_end = int(np.argmin(D[n] + tail))
    best = int(ends[j_end])
    # traceback from (n, j_end)
    i, j = n, j_end
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    while i > 0:
        if j > 0 and D[i, j] == D[i - 1, j - 1] + (
                mis if S[i - 1] != T[j - 1] else 0):
            push("M")
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + gap:
            push("I")
            i -= 1
        else:
            push("D")
            j -= 1
    ops.reverse()
    return best, j, [(o, l) for o, l in ops]


# ------------------------------------------------------------------ affine

def sw_affine(S, T, penalize_left_gap: bool = True,
              penalize_right_gap: bool = True, mis: int = 3,
              gap_open: int = 12, gap_extend: int = 1):
    """SmithWatAffine parity (SmithWatAffine.h:22-36): global alignment
    with affine gap costs (open includes the first extension). Returns
    (best_cost, ops). Only penalized ends are supported, matching the
    reference's restriction (SmithWatAffine.h:26-27)."""
    assert penalize_left_gap and penalize_right_gap
    S = np.asarray(S, dtype=np.int8)
    T = np.asarray(T, dtype=np.int8)
    n, m = len(S), len(T)
    M = np.full((n + 1, m + 1), BIG, dtype=np.int64)  # last op: match/sub
    X = np.full((n + 1, m + 1), BIG, dtype=np.int64)  # gap in T (consume S)
    Y = np.full((n + 1, m + 1), BIG, dtype=np.int64)  # gap in S (consume T)
    M[0, 0] = 0
    for i in range(1, n + 1):
        X[i, 0] = gap_open + (i - 1) * gap_extend
    for j in range(1, m + 1):
        Y[0, j] = gap_open + (j - 1) * gap_extend
    for i in range(1, n + 1):
        sub = np.where(S[i - 1] == T, 0, mis).astype(np.int64)
        prevM, prevX, prevY = M[i - 1], X[i - 1], Y[i - 1]
        base = np.minimum(np.minimum(prevM, prevX), prevY)
        M[i, 1:] = base[:-1] + sub
        X[i, 1:] = np.minimum(np.minimum(prevM[1:] + gap_open,
                                         prevX[1:] + gap_extend),
                              prevY[1:] + gap_open)
        X[i, 0] = gap_open + (i - 1) * gap_extend
        row_y = Y[i]
        bm = M[i]
        bx = X[i]
        for j in range(1, m + 1):
            row_y[j] = min(bm[j - 1] + gap_open, bx[j - 1] + gap_open,
                           row_y[j - 1] + gap_extend)
    best = int(min(M[n, m], X[n, m], Y[n, m]))
    # traceback
    i, j = n, m
    state = int(np.argmin([M[n, m], X[n, m], Y[n, m]]))
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    while i > 0 or j > 0:
        if state == 0:
            push("M")
            c = M[i, j] - (0 if S[i - 1] == T[j - 1] else mis)
            i -= 1
            j -= 1
            state = int(np.argmin([M[i, j], X[i, j], Y[i, j]]))
            # pick the state that actually produced c
            for s, v in enumerate((M[i, j], X[i, j], Y[i, j])):
                if v == c:
                    state = s
                    break
        elif state == 1:
            push("I")
            c = X[i, j]
            i -= 1
            if i >= 0:
                if M[i, j] + gap_open == c:
                    state = 0
                elif X[i, j] + gap_extend == c:
                    state = 1
                else:
                    state = 2
        else:
            push("D")
            c = Y[i, j]
            j -= 1
            if j >= 0:
                if M[i, j] + gap_open == c:
                    state = 0
                elif Y[i, j] + gap_extend == c:
                    state = 2
                else:
                    state = 1
    ops.reverse()
    return best, [(o, l) for o, l in ops]
