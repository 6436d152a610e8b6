"""Independent NumPy oracles for decoder tests.

Straightforward float64 dense implementations of textbook sum-product /
normalized-min-sum BP and OSD, written for clarity and used to validate the
batched edge-list decoders. Semantics follow the reference algorithms
(decoding/beliefPropagation.py, rework/decoding.py, decoding/OSD.py) including
their clipping constants and tie-breaking, so agreement here implies agreement
with the reference.
"""

from __future__ import annotations

import numpy as np

CLIP = 0.9999999


def bp_sum_product(
    H,
    syndrome,
    prior,
    max_iter=50,
    alpha=1.0,
    damping=1.0,
    clip_llr=None,
):
    """Dense sum-product BP. Returns (hard, converged, llrs, n_iter)."""
    H = np.asarray(H, dtype=np.float64)
    m, n = H.shape
    mask = H != 0
    ssign = (1 - 2 * np.asarray(syndrome, dtype=np.float64)).reshape(-1, 1)
    prior = np.broadcast_to(np.asarray(prior, dtype=np.float64), (n,))

    Q = np.where(mask, prior, 0.0)
    Q_old = Q.copy()
    values = prior.copy()
    hard = np.zeros(n, dtype=np.int8)
    for it in range(max_iter):
        t = np.tanh(Q * 0.5)
        t = np.where(mask, t, 1.0)
        row_prod = np.prod(t, axis=1, keepdims=True)
        t_safe = np.where(np.abs(t) < 1e-15, 1e-15, t)
        others = row_prod / t_safe
        R = np.where(
            mask, 2.0 * np.arctanh(np.clip(others * ssign, -CLIP, CLIP)), 0.0
        )
        R = R * alpha
        values = R.sum(axis=0) + prior
        Qn = np.where(mask, values - R, 0.0)
        Qn = damping * Qn + (1 - damping) * Q_old
        if clip_llr is not None:
            Qn = np.clip(Qn, -clip_llr, clip_llr)
        Q = Q_old = Qn
        hard = (values < 0).astype(np.int8)
        if np.array_equal(H.astype(int) @ hard % 2, syndrome):
            return hard, True, values, it
    return hard, False, values, max_iter - 1


def bp_min_sum(
    H,
    syndrome,
    prior,
    max_iter=50,
    alpha=1.0,
    offset=0.0,
    damping=1.0,
    clip_llr=None,
):
    """Dense normalized min-sum BP. Returns (hard, converged, llrs, n_iter)."""
    H = np.asarray(H, dtype=np.float64)
    m, n = H.shape
    mask = H != 0
    ssign = (1 - 2 * np.asarray(syndrome, dtype=np.float64)).reshape(-1, 1)
    prior = np.broadcast_to(np.asarray(prior, dtype=np.float64), (n,))

    Q = np.where(mask, prior, 0.0)
    Q_old = Q.copy()
    values = prior.copy()
    hard = np.zeros(n, dtype=np.int8)
    for it in range(max_iter):
        s = np.where(Q >= 0, 1.0, -1.0)
        s = np.where(mask, s, 1.0)
        row_sign = np.prod(s, axis=1, keepdims=True)
        r_signs = row_sign * s
        aq = np.where(mask, np.abs(Q), np.inf)
        i1 = np.argmin(aq, axis=1)
        min1 = aq[np.arange(m), i1]
        tmp = aq.copy()
        tmp[np.arange(m), i1] = np.inf
        min2 = tmp.min(axis=1)
        mags = np.where(aq == min1[:, None], min2[:, None], min1[:, None])
        if offset:
            mags = np.maximum(mags - offset, 0.0)
        R = np.where(mask, alpha * ssign * r_signs * mags, 0.0)
        values = R.sum(axis=0) + prior
        Qn = np.where(mask, values - R, 0.0)
        Qn = damping * Qn + (1 - damping) * Q_old
        if clip_llr is not None:
            Qn = np.clip(Qn, -clip_llr, clip_llr)
        Q = Q_old = Qn
        hard = (values < 0).astype(np.int8)
        if np.array_equal(H.astype(int) @ hard % 2, syndrome):
            return hard, True, values, it
    return hard, False, values, max_iter - 1


def bp_layered(
    H,
    syndrome,
    prior,
    max_iter=50,
    n_layers=2,
    method="sum-product",
    alpha=1.0,
    offset=0.0,
    clip_llr=None,
):
    """Dense check-serial (layered) BP: checks in ``n_layers`` contiguous
    blocks per iteration, each consuming posteriors refreshed by the
    previous blocks. Returns (hard, converged, llrs, n_iter)."""
    H = np.asarray(H, dtype=np.float64)
    m, n = H.shape
    assert m % n_layers == 0
    ml = m // n_layers
    mask = H != 0
    ssign = (1 - 2 * np.asarray(syndrome, dtype=np.float64)).reshape(-1, 1)
    prior = np.broadcast_to(np.asarray(prior, dtype=np.float64), (n,))

    R = np.zeros((m, n))
    values = prior.copy()
    hard = np.zeros(n, dtype=np.int8)
    for it in range(max_iter):
        for l in range(n_layers):
            rows = slice(l * ml, (l + 1) * ml)
            msk = mask[rows]
            Q = np.where(msk, values[None, :] - R[rows], 0.0)
            if clip_llr is not None:
                Q = np.clip(Q, -clip_llr, clip_llr)
            if method == "sum-product":
                t = np.where(msk, np.tanh(Q * 0.5), 1.0)
                row_prod = np.prod(t, axis=1, keepdims=True)
                t_safe = np.where(np.abs(t) < 1e-15, 1e-15, t)
                others = row_prod / t_safe
                Rn = np.where(
                    msk,
                    2.0 * np.arctanh(np.clip(others * ssign[rows], -CLIP, CLIP)),
                    0.0,
                )
            else:
                s = np.where(msk, np.where(Q >= 0, 1.0, -1.0), 1.0)
                row_sign = np.prod(s, axis=1, keepdims=True)
                r_signs = row_sign * s
                aq = np.where(msk, np.abs(Q), np.inf)
                i1 = np.argmin(aq, axis=1)
                min1 = aq[np.arange(ml), i1]
                tmp = aq.copy()
                tmp[np.arange(ml), i1] = np.inf
                min2 = tmp.min(axis=1)
                mags = np.where(aq == min1[:, None], min2[:, None], min1[:, None])
                if offset:
                    mags = np.maximum(mags - offset, 0.0)
                Rn = np.where(msk, ssign[rows] * r_signs * mags, 0.0)
            Rn = Rn * alpha
            values = values + (Rn - R[rows]).sum(axis=0)
            R[rows] = Rn
        hard = (values < 0).astype(np.int8)
        if np.array_equal(H.astype(int) @ hard % 2, syndrome):
            return hard, True, values, it
    return hard, False, values, max_iter - 1


def gf2_rref_solve(H, s):
    """RREF of [H | s] over GF(2). Returns (A, b, pivot_rows, pivot_cols)."""
    A = (np.asarray(H) % 2).astype(np.uint8).copy()
    b = (np.asarray(s) % 2).astype(np.uint8).copy()
    m, n = A.shape
    piv_rows, piv_cols = [], []
    r = 0
    for c in range(n):
        if r >= m:
            break
        hits = np.nonzero(A[r:, c])[0]
        if hits.size == 0:
            continue
        p = r + hits[0]
        if p != r:
            A[[r, p]] = A[[p, r]]
            b[[r, p]] = b[[p, r]]
        others = np.nonzero(A[:, c])[0]
        others = others[others != r]
        A[others] ^= A[r]
        b[others] ^= b[r]
        piv_rows.append(r)
        piv_cols.append(c)
        r += 1
    return A, b, piv_rows, piv_cols


def osd0(H, syndrome, llr, hard):
    """OSD-0: reliability-ordered GF(2) solve of the residual syndrome."""
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    hard = np.asarray(hard).astype(np.uint8)
    resid = (np.asarray(syndrome) + H @ hard) % 2
    order = np.argsort(np.abs(llr), kind="stable")
    A, b, piv_rows, piv_cols = gf2_rref_solve(H[:, order], resid)
    e_perm = np.zeros(n, dtype=np.uint8)
    for r, c in zip(piv_rows, piv_cols):
        e_perm[c] = b[r]
    corr = np.zeros(n, dtype=np.uint8)
    corr[order] = e_perm
    return (hard + corr) % 2
