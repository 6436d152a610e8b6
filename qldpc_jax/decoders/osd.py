"""Ordered-statistics decoding (OSD-0 / OSD-e).

Functional parity targets (reference: decoding/OSD.py:3-72 for OSD-0;
decoding/OSD_enhanced.py:5-224 for the order-w combination search). OSD-0
semantics are replicated exactly; the OSD-e pattern search deliberately FIXES
a reference bug rather than replicating it: the reference's
``recompute_solution`` (OSD_enhanced.py:134-155) re-solves pivots from the
*un-reduced* permuted H mixed with the *reduced* syndrome, which yields
inconsistent candidate solutions; here pivots are solved from the true RREF.
The divergence is only reachable for syndromes outside image(H) — no shipped
sampler produces them — and on in-image syndromes the search is bypassed by
the early return both here and in the reference, so all shipped workloads
agree bit-for-bit. Semantics preserved from the reference:

  * columns sorted by ascending |LLR| (stable), residual syndrome solved by
    full GF(2) row reduction with first-hit pivoting;
  * pivot bits back-substituted, correction un-permuted and XORed into the
    BP hard decision (OSD.py:20-26);
  * OSD-e: if the OSD-0 solution reproduces the syndrome it is returned
    untouched (OSD_enhanced.py:59); otherwise flip patterns of weight <= order
    over the ``order + 10`` least-reliable non-pivot columns are scored by
    LLR cost with invalid-syndrome penalty and the first minimum wins
    (OSD_enhanced.py:89-129). Two structural facts make this map cleanly to
    batched array code: the system H e = resid is consistent iff the zero rows of the RREF
    carry zero syndrome (pattern-independent), and for inconsistent systems
    the violated-check penalty is identical for every pattern — so the search
    collapses to a stable argmin over per-pattern LLR costs, with the
    zero pattern (OSD-0) listed first so ties resolve exactly like the
    reference's strict-improvement rule.

Design: the elimination runs over *bit-packed* rows (uint32 lanes,
32 columns per word) with a fixed trip count of n column steps, masked
conditional pivoting/elimination (no data-dependent control flow), natively
vmapped over the sample batch. The combination search is a single
(patterns x test-columns) GF(2) matmul + argmin instead of a sequential loop.
"""

from __future__ import annotations

import dataclasses
from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["OSDConfig", "OSDDecoder", "make_flip_patterns"]

_WORD = 32


def make_flip_patterns(
    num_positions: int, order: int, max_combinations: int | None = None
) -> np.ndarray:
    """Static (C, num_positions) 0/1 pattern matrix; row 0 is the zero pattern.

    Rows follow the reference's enumeration order — weight w = 1..order, each
    weight in lexicographic combination order (OSD_enhanced.py:89-94) — so
    truncation by ``max_combinations`` and first-minimum tie-breaking agree.
    """
    rows = [np.zeros(num_positions, dtype=np.uint8)]
    budget = np.inf if max_combinations is None else max_combinations
    count = 0
    for w in range(1, min(order, num_positions) + 1):
        for combo in combinations(range(num_positions), w):
            if count >= budget:
                break
            row = np.zeros(num_positions, dtype=np.uint8)
            row[list(combo)] = 1
            rows.append(row)
            count += 1
        if count >= budget:
            break
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class OSDConfig:
    order: int = 0
    max_combinations: int | None = None
    extra_positions: int = 10  # test set size = order + extra_positions
    dtype: str = "float32"
    backend: str = "auto"  # "auto" == "lanes": batch-in-lanes elimination,
    # on the packed system or, for wide systems (n_words > 4 * m_words),
    # on the m x m row transform | "vmap" (per-sample elimination)
    chunk: int = 64  # OSD-e: samples per lax.map chunk (bounds the
    # (chunk x patterns x m) pattern-search workspace)

    def __post_init__(self):
        if self.backend not in ("auto", "lanes", "vmap"):
            raise ValueError(f"unknown OSD backend {self.backend!r}")


class OSDDecoder:
    """Jitted batched OSD post-processor for a fixed parity-check matrix.

    Usage::

        osd = OSDDecoder(H, OSDConfig(order=7))
        solutions = osd(syndromes, llrs, hard)   # all batched (B, ...)
    """

    def __init__(self, H: np.ndarray, config: OSDConfig = OSDConfig()):
        self.config = config
        H = (np.asarray(H) % 2).astype(np.uint8)
        self.m, self.n = H.shape
        self.n_words = -(-self.n // _WORD)
        self._H_np = H  # dense device copies are built lazily (wide
        # systems never materialize them — a [[144,12,12]] DEM H is 463 MB
        # as f32)
        # GF(2) rank of H: column permutations preserve it, so once every
        # lane's elimination has found `rank(H)` pivots the remaining column
        # steps are provable no-ops (a step only mutates state when it finds
        # a new pivot) — the elimination loops exit there instead of
        # sweeping all n columns. Dominant at DEM scale: rank 432 of
        # n = 15765 columns.
        from qldpc_jax import native as _native

        self._H_rank = int(_native.rank(H))
        # gather-parity tables for the residual syndrome (see parity_tables)
        from qldpc_jax.ops.tanner import parity_tables

        vos_p, dcp_p = parity_tables(H)
        self._vos_parity = jnp.asarray(vos_p)
        self._dcp_parity = dcp_p
        # Wide systems (n >> m, e.g. circuit-level DEMs: 432 x 15765) use
        # the TRANSFORM elimination: instead of row-reducing the full packed
        # (m, n_words) system — whose per-column row ops sweep 493-word rows
        # and whose per-sample column permutation materializes (B, m, n) —
        # carry only the m x m row-operation transform T (m_words words per
        # row) plus b, and compute RREF column bits on demand as
        # parity(T & H[:, col]) from statically packed H columns. Identical
        # pivoting order => identical results.
        self.m_words = -(-self.m // _WORD)
        self._use_transform = self.n_words > 4 * self.m_words
        if self._use_transform:
            Ht = H.T.astype(np.uint32)  # (n, m)
            padc = self.m_words * _WORD - self.m
            Ht = np.pad(Ht, ((0, 0), (0, padc)))
            Ht = Ht.reshape(self.n, self.m_words, _WORD)
            shifts = np.arange(_WORD, dtype=np.uint32)
            self._Hc = jnp.asarray(
                (Ht << shifts).sum(axis=-1).astype(np.uint32)
            )  # (n, m_words) packed columns of H
            eye = np.eye(self.m, dtype=np.uint32)
            eye = np.pad(eye, ((0, 0), (0, padc)))
            eye = eye.reshape(self.m, self.m_words, _WORD)
            self._T0 = jnp.asarray(
                (eye << shifts).sum(axis=-1).astype(np.uint32)
            )  # (m, m_words) packed identity
        if config.order > 0:
            t = min(config.order + config.extra_positions, self.n)
            self.num_test = t
            self._patterns = jnp.asarray(
                make_flip_patterns(t, config.order, config.max_combinations),
                jnp.float32,
            )
        else:
            self.num_test = 0
            self._patterns = None
        self.backend = "lanes" if config.backend == "auto" else config.backend
        # dense device copies of H, for the paths that need them. The wide
        # transform path never touches them; skip only when the matrix is
        # genuinely huge (a [[144,12,12]] DEM is 463 MB as f32) so every
        # configuration of moderate systems keeps working
        if self.m * self.n <= 8_000_000 or not (
            self._use_transform and self.backend == "lanes"
        ):
            self._H = jnp.asarray(H)
            self._Hf = jnp.asarray(H, jnp.float32)  # residual matmul
        if self.backend == "lanes":
            self._decode = jax.jit(
                self._osd0_lanes if config.order == 0 else self._osde_lanes
            )
        elif config.order > 0 and config.chunk > 0:
            self._decode = jax.jit(self._osd_chunked)
        else:
            self._decode = jax.jit(jax.vmap(self._osd_single))

    def _osd_chunked(self, syndromes, llrs, hard):
        """vmap in bounded chunks via lax.map — caps the OSD-e pattern-search
        workspace at (chunk x C x m) instead of (batch x C x m)."""
        B = syndromes.shape[0]
        ch = self.config.chunk
        pad = (-B) % ch
        pad_args = lambda x: jnp.concatenate(
            [x, jnp.repeat(x[:1], pad, axis=0)], axis=0
        ) if pad else x
        s, l, h = pad_args(syndromes), pad_args(llrs), pad_args(hard)
        s = s.reshape(-1, ch, *s.shape[1:])
        l = l.reshape(-1, ch, *l.shape[1:])
        h = h.reshape(-1, ch, *h.shape[1:])
        out = jax.lax.map(
            lambda args: jax.vmap(self._osd_single)(*args), (s, l, h)
        )
        return out.reshape(-1, self.n)[:B]

    # ---- bit packing --------------------------------------------------------
    def _pack_rows(self, bits: jax.Array) -> jax.Array:
        """(m, n) 0/1 -> (m, n_words) uint32, column j at word j//32 bit j%32."""
        pad = self.n_words * _WORD - self.n
        bits = jnp.pad(bits.astype(jnp.uint32), ((0, 0), (0, pad)))
        bits = bits.reshape(self.m, self.n_words, _WORD)
        shifts = jnp.arange(_WORD, dtype=jnp.uint32)
        return jnp.sum(bits << shifts, axis=-1).astype(jnp.uint32)

    @staticmethod
    def _extract_col(A: jax.Array, col: jax.Array) -> jax.Array:
        """Bit `col` of every (packed) row -> (m,) uint32 in {0, 1}."""
        word = col // _WORD
        bit = (col % _WORD).astype(jnp.uint32)
        return (jax.lax.dynamic_index_in_dim(A, word, axis=1, keepdims=False) >> bit) & 1

    # ---- core ---------------------------------------------------------------
    def _eliminate(self, A: jax.Array, b: jax.Array):
        """Masked full GF(2) row reduction of packed system [A | b].

        Fixed trip count of n column steps; per step: first-hit pivot pick via
        argmax over rows >= rank, masked one-hot row swap, masked XOR
        elimination of every other row holding the pivot bit.
        Returns (A_rref, b_rref, pivot_col_of_row [-1 if none]).
        """
        m = self.m
        row_ids = jnp.arange(m)

        def step(col, state):
            A, b, rank, piv_col = state
            bits = self._extract_col(A, col)
            cand = (bits == 1) & (row_ids >= rank) & (col < self.n)
            has = jnp.any(cand)
            p = jnp.argmax(cand)  # first eligible row holding the bit

            # swap rows `rank` <-> `p` (no-op unless a pivot was found)
            row_r = A[rank]
            row_p = A[p]
            is_r = row_ids == rank
            is_p = row_ids == p
            A = jnp.where(has & is_p[:, None], row_r[None, :], A)
            A = jnp.where(has & is_r[:, None], row_p[None, :], A)
            b_r, b_p = b[rank], b[p]
            b = jnp.where(has & is_p, b_r, b)
            b = jnp.where(has & is_r, b_p, b)

            # eliminate the pivot bit from every other row
            bits = self._extract_col(A, col)
            elim = has & (bits == 1) & (row_ids != rank)
            piv_row = A[rank]
            piv_b = b[rank]
            A = A ^ (elim[:, None].astype(jnp.uint32) * piv_row[None, :])
            b = b ^ (elim.astype(b.dtype) * piv_b)

            piv_col = jnp.where(has & is_r, col, piv_col)
            rank = rank + has.astype(jnp.int32)
            return A, b, rank, piv_col

        piv_col0 = jnp.full((m,), -1, jnp.int32)
        blk = 32

        def cond(state):
            (_, _, rank, _), col = state
            return (col < self.n) & (rank < self._H_rank)

        def body(state):
            inner, col = state
            inner = jax.lax.fori_loop(
                0, blk, lambda i, s: step(col + i, s), inner
            )
            return inner, col + blk

        (A, b, rank, piv_col), _ = jax.lax.while_loop(
            cond, body, ((A, b, jnp.int32(0), piv_col0), jnp.int32(0))
        )
        return A, b, rank, piv_col

    def _osd_single(self, syndrome: jax.Array, llr: jax.Array, hard: jax.Array):
        n, m = self.n, self.m
        cfg = self.config
        hard = hard.astype(jnp.int32)
        resid = (syndrome.astype(jnp.int32) + self._H.astype(jnp.int32) @ hard) % 2

        llr_abs = jnp.abs(llr)
        order = jnp.argsort(llr_abs, stable=True)
        Hp = self._H[:, order]  # per-sample column permutation
        A = self._pack_rows(Hp)
        A, b, rank, piv_col = self._eliminate(A, resid.astype(jnp.uint32))

        # OSD-0: e_perm[pivot col of row r] = b[r]; dummy slot n absorbs -1 rows
        tgt = jnp.where(piv_col >= 0, piv_col, n)
        e_perm = jnp.zeros(n + 1, jnp.uint32).at[tgt].set(b)[:n]

        if cfg.order == 0:
            corr = jnp.zeros(n, jnp.uint32).at[order].set(e_perm)
            return ((hard + corr.astype(jnp.int32)) % 2).astype(jnp.int8)

        # ---- OSD-e combination search --------------------------------------
        # consistency: every pivotless (all-zero) RREF row must have b == 0
        consistent = jnp.all((piv_col >= 0) | (b == 0))

        # test set: the `num_test` least-reliable non-pivot columns. Permuted
        # coords are already sorted by |llr|, so ascending column order is
        # reliability order (cf. OSD_enhanced.py:74-81, where the re-sort of
        # non-pivot positions by llr is an identity on sorted coords).
        is_piv = jnp.zeros(n + 1, bool).at[tgt].set(piv_col >= 0)[:n]
        col_ids = jnp.arange(n)
        test_cols = jnp.argsort(jnp.where(is_piv, n + col_ids, col_ids), stable=True)[
            : self.num_test
        ]
        # a column slot is unusable if it is actually a pivot (fewer than
        # num_test non-pivot columns exist); mask its contribution out
        test_valid = ~is_piv[test_cols]

        # T[r, t] = RREF bit (row r, test column t), extracted from packed rows
        words = A[:, test_cols // _WORD]  # (m, t)
        Tmat = ((words >> (test_cols % _WORD).astype(jnp.uint32)) & 1).astype(
            jnp.float32
        )
        Tmat = Tmat * test_valid[None, :].astype(jnp.float32)

        # per-pattern pivot values: b XOR (T @ f) mod 2  -> (C, m)
        F = self._patterns * test_valid[None, :].astype(jnp.float32)  # (C, t)
        piv_vals = jnp.mod(
            F @ Tmat.T + b.astype(jnp.float32)[None, :], 2.0
        )  # (C, m)

        # LLR cost of the full solution hard XOR corr:
        #   cost = const + sum_j corr_j * |llr_j| * (1 - 2 hard_j)   (orig coords)
        # (cf. OSD_enhanced.py:158-177 metric; the invalid-syndrome penalty is
        # pattern-independent, see module docstring.)
        w_perm = (llr_abs * (1.0 - 2.0 * hard.astype(llr.dtype)))[order]
        w_test = w_perm[test_cols] * test_valid
        w_piv = jnp.where(piv_col >= 0, w_perm[jnp.clip(piv_col, 0, n - 1)], 0.0)
        # full float32: the LLR weights are not binary, and a TF32 product
        # could reorder near-tied pattern costs
        hi = jax.lax.Precision.HIGHEST
        costs = jnp.dot(F, w_test, precision=hi) + jnp.dot(
            piv_vals, w_piv, precision=hi
        )  # (C,)

        best = jnp.argmin(costs)  # first minimum == reference tie-breaking
        best = jnp.where(consistent, 0, best)  # OSD-0 returned when valid

        # assemble the winning pattern's correction: test-column flips plus
        # the recomputed pivot values (dummy slot n absorbs pivotless rows)
        f_best = self._patterns[best] * test_valid.astype(jnp.float32)
        pv_best = piv_vals[best]
        e_full = jnp.zeros(n + 1, jnp.float32).at[test_cols].set(f_best)
        e_full = e_full.at[tgt].set(jnp.where(piv_col >= 0, pv_best, 0.0))
        e_perm_best = e_full[:n].astype(jnp.uint32)

        corr = jnp.zeros(n, jnp.uint32).at[order].set(e_perm_best)
        return ((hard + corr.astype(jnp.int32)) % 2).astype(jnp.int8)

    # ---- batch-in-lanes OSD-0 ----------------------------------------------
    # The vmapped single-sample elimination leaves the batch as the leading
    # axis, so every per-column row operation runs on tiny (m, n_words)
    # tiles. This path keeps the batch in the LANE dimension throughout:
    # state is (m, n_words, B) and per-column pivot selection/swap/eliminate
    # are pure masked elementwise ops + reductions over the row axis — no
    # per-sample dynamic indexing anywhere.
    def _pack_lanes(self, Hp: jax.Array) -> jax.Array:
        """(B, m, n) 0/1 -> (m, n_words, B) uint32."""
        B = Hp.shape[0]
        pad = self.n_words * _WORD - self.n
        bits = jnp.pad(Hp.astype(jnp.uint32), ((0, 0), (0, 0), (0, pad)))
        bits = bits.reshape(B, self.m, self.n_words, _WORD)
        shifts = jnp.arange(_WORD, dtype=jnp.uint32)
        packed = jnp.sum(bits << shifts, axis=-1).astype(jnp.uint32)
        return packed.transpose(1, 2, 0)

    def _eliminate_lanes(self, A: jax.Array, b: jax.Array):
        """Masked full RREF, batch in lanes.

        A (m, n_words, B) uint32, b (m, B) uint32. Pivot choice per lane uses
        a cumsum-based first-hit one-hot; the row swap is a masked XOR-swap
        (A ^= (e_r + e_p) (x) (A_r ^ A_p)); elimination XORs the pivot row
        into every other row holding the bit. Returns (A, b, rank (B,),
        piv_col (m, B) int32).
        """
        m = self.m
        row_ids = jnp.arange(m)[:, None]  # (m, 1)

        def step(col, state):
            A, b, rank, piv_col = state
            w = col // _WORD
            bit = (col % _WORD).astype(jnp.uint32)
            word = jax.lax.dynamic_index_in_dim(A, w, axis=1, keepdims=False)
            bits = (word >> bit) & 1  # (m, B)
            cand = (bits == 1) & (row_ids >= rank[None, :]) & (col < self.n)
            has = jnp.any(cand, axis=0)  # (B,)
            ps = jnp.cumsum(cand.astype(jnp.int32), axis=0)
            oh_p = cand & (ps == 1)  # first eligible row per lane
            oh_r = row_ids == rank[None, :]

            au = lambda x: x.astype(jnp.uint32)
            pivrow = jnp.sum(A * au(oh_p)[:, None, :], axis=0, dtype=jnp.uint32)  # (nw, B)
            rankrow = jnp.sum(A * au(oh_r)[:, None, :], axis=0, dtype=jnp.uint32)
            diff = pivrow ^ rankrow
            swap = au((oh_p ^ oh_r) & has[None, :])
            A = A ^ (swap[:, None, :] * diff[None, :, :])
            pb = jnp.sum(b * au(oh_p), axis=0, dtype=jnp.uint32)
            rb = jnp.sum(b * au(oh_r), axis=0, dtype=jnp.uint32)
            b = b ^ (swap * (pb ^ rb)[None, :])

            word2 = jax.lax.dynamic_index_in_dim(A, w, axis=1, keepdims=False)
            bits2 = (word2 >> bit) & 1
            elim = au((bits2 == 1) & ~oh_r & has[None, :])
            newpiv = jnp.sum(A * au(oh_r)[:, None, :], axis=0, dtype=jnp.uint32)
            newpb = jnp.sum(b * au(oh_r), axis=0, dtype=jnp.uint32)
            A = A ^ (elim[:, None, :] * newpiv[None, :, :])
            b = b ^ (elim * newpb[None, :])

            piv_col = jnp.where(oh_r & has[None, :], jnp.int32(col), piv_col)
            rank = rank + has.astype(rank.dtype)
            return A, b, rank, piv_col

        B = A.shape[-1]
        piv0 = jnp.full((m, B), -1, jnp.int32)
        blk = 32

        def cond(state):
            (_, _, rank, _), col = state
            return (col < self.n) & (jnp.min(rank) < self._H_rank)

        def body(state):
            inner, col = state
            inner = jax.lax.fori_loop(
                0, blk, lambda i, s: step(col + i, s), inner
            )
            return inner, col + blk

        (A, b, rank, piv_col), _ = jax.lax.while_loop(
            cond,
            body,
            ((A, b, jnp.zeros((B,), jnp.int32), piv0), jnp.int32(0)),
        )
        return A, b, rank, piv_col

    def _eliminate_lanes_T(self, order: jax.Array, b: jax.Array,
                           b_exit: bool = False):
        """Transform-based masked RREF for wide systems, batch in lanes.

        ``order`` (B, n) per-sample column permutation, ``b`` (m, B) uint32
        residual syndromes. Carries T (m, m_words, B) — the accumulated row
        operations, starting from identity — instead of the full packed
        system: the RREF bit of (row r, permuted column c) is
        parity(T[r] & Hc[order[c]]). Pivot choice / swap / eliminate follow
        ``_eliminate_lanes`` exactly, so pivots and b match it bit-for-bit.
        Exits once every lane reaches rank(H) (see ``_H_rank``).

        Returns (T, b, rank (B,), piv_col (m, B) int32).
        """
        m = self.m
        B = b.shape[-1]
        row_ids = jnp.arange(m)[:, None]  # (m, 1)
        T = jnp.broadcast_to(self._T0[:, :, None], (m, self.m_words, B))

        def step(col, state):
            T, b, rank, piv_col = state
            ocol = jax.lax.dynamic_slice_in_dim(
                order, jnp.minimum(col, self.n - 1), 1, axis=1
            )[:, 0]  # (B,) original column ids
            hcol = self._Hc[ocol].T  # (m_words, B)
            cnt = jnp.sum(
                jax.lax.population_count(T & hcol[None, :, :]),
                axis=1,
                dtype=jnp.int32,
            )
            bits = (cnt & 1).astype(jnp.uint32)  # (m, B)
            cand = (bits == 1) & (row_ids >= rank[None, :]) & (col < self.n)
            has = jnp.any(cand, axis=0)  # (B,)
            ps = jnp.cumsum(cand.astype(jnp.int32), axis=0)
            oh_p = cand & (ps == 1)
            oh_r = row_ids == rank[None, :]

            au = lambda x: x.astype(jnp.uint32)
            pivrow = jnp.sum(T * au(oh_p)[:, None, :], axis=0, dtype=jnp.uint32)
            rankrow = jnp.sum(T * au(oh_r)[:, None, :], axis=0, dtype=jnp.uint32)
            diff = pivrow ^ rankrow
            swap = au((oh_p ^ oh_r) & has[None, :])
            T = T ^ (swap[:, None, :] * diff[None, :, :])
            pb = jnp.sum(b * au(oh_p), axis=0, dtype=jnp.uint32)
            rb = jnp.sum(b * au(oh_r), axis=0, dtype=jnp.uint32)
            b = b ^ (swap * (pb ^ rb)[None, :])

            # bits after the swap, without a second parity pass: the swap
            # only exchanged rows p and r
            bits_p = jnp.sum(bits * au(oh_p), axis=0)  # (B,)
            bits_r = jnp.sum(bits * au(oh_r), axis=0)
            bits2 = jnp.where(oh_p, bits_r[None, :], bits)
            bits2 = jnp.where(oh_r, bits_p[None, :], bits2)

            elim = au((bits2 == 1) & ~oh_r & has[None, :])
            newpiv = jnp.sum(T * au(oh_r)[:, None, :], axis=0, dtype=jnp.uint32)
            newpb = jnp.sum(b * au(oh_r), axis=0, dtype=jnp.uint32)
            T = T ^ (elim[:, None, :] * newpiv[None, :, :])
            b = b ^ (elim * newpb[None, :])

            piv_col = jnp.where(oh_r & has[None, :], jnp.int32(col), piv_col)
            rank = rank + has.astype(rank.dtype)
            return T, b, rank, piv_col

        piv0 = jnp.full((m, B), -1, jnp.int32)
        blk = 32
        lane_rows = jnp.arange(m)[:, None]

        def cond(state):
            (_, bb, rank, _), col = state
            lane_done = rank >= self._H_rank
            if b_exit:
                # OSD-0 shortcut (exact): once no unresolved syndrome bit
                # remains, every later pivot carries b = 0
                unres = jnp.max(
                    jnp.where(
                        lane_rows >= rank[None, :], bb.astype(jnp.int32), 0
                    ),
                    axis=0,
                )
                lane_done = lane_done | (unres == 0)
            return (col < self.n) & ~jnp.all(lane_done)

        def body(state):
            inner, col = state
            inner = jax.lax.fori_loop(
                0, blk, lambda i, s: step(col + i, s), inner
            )
            return inner, col + blk

        (T, b, rank, piv_col), _ = jax.lax.while_loop(
            cond,
            body,
            ((T, b, jnp.zeros((B,), jnp.int32), piv0), jnp.int32(0)),
        )
        return T, b, rank, piv_col

    def _lanes_core(self, syndromes, llrs, hard):
        """Shared lanes pipeline: permute, pack, eliminate, OSD-0 solve.

        Returns (order, A_bt (B,m,nw) [or T_bt (B,m,mw) for wide systems],
        b_bt (B,m), piv_bt (B,m), solution).
        """
        n = self.n
        B = syndromes.shape[0]
        hard = hard.astype(jnp.int32)
        if self._use_transform:
            # gather-parity residual: no dense H constant (463 MB f32 for a
            # [[144,12,12]] DEM)
            hp = jnp.pad(hard, ((0, 0), (0, 1)))
            hs = hp[:, self._vos_parity].reshape(B, self.m, self._dcp_parity)
            s_hat = jnp.sum(hs, axis=-1, dtype=jnp.int32) % 2
            resid = (syndromes.astype(jnp.int32) + s_hat) % 2
        else:
            resid = (
                syndromes.astype(jnp.int32)
                + jnp.mod(
                    jnp.dot(hard.astype(jnp.float32), self._Hf.T), 2.0
                ).astype(jnp.int32)
            ) % 2

        order = jnp.argsort(jnp.abs(llrs), axis=1, stable=True)  # (B, n)
        if self._use_transform:
            # Per-lane combined exit (exact for EVERY order): a lane stops
            # once no unresolved syndrome bit remains (b-exit) OR it reaches
            # rank(H). OSD-0 never reads T after elimination, so b-exit is
            # trivially safe there; for OSD-e a b-exited lane is by
            # definition CONSISTENT (its residual was resolved), which takes
            # the reference's early return (OSD_enhanced.py:59) — the
            # pattern search never reads its T. Inconsistent lanes (the only
            # ones searched) carry a permanently unresolved b bit, so they
            # can never b-exit and always run to full rank with valid T.
            # This removes the order>0 wide-system cliff (round-3 VERDICT
            # item 6: 6x OSD-0 cost for zero benefit on in-image syndromes).
            A, bb, rank, piv_col = self._eliminate_lanes_T(
                order, resid.T.astype(jnp.uint32), b_exit=True
            )
        else:
            Hp = jnp.take(self._H, order, axis=1).transpose(1, 0, 2)
            A = self._pack_lanes(Hp)
            A, bb, rank, piv_col = self._eliminate_lanes(
                A, resid.T.astype(jnp.uint32)
            )

        piv_bt = piv_col.T  # (B, m)
        b_bt = bb.T  # (B, m)
        tgt = jnp.where(piv_bt >= 0, piv_bt, n)
        bidx = jnp.arange(B)[:, None]
        e_perm = jnp.zeros((B, n + 1), jnp.uint32).at[bidx, tgt].set(b_bt)[:, :n]
        corr = jnp.zeros((B, n), jnp.uint32).at[bidx, order].set(e_perm)
        sol = ((hard + corr.astype(jnp.int32)) % 2).astype(jnp.int8)
        return order, A.transpose(2, 0, 1), b_bt, piv_bt, sol

    def _osd0_lanes(self, syndromes, llrs, hard):
        return self._lanes_core(syndromes, llrs, hard)[-1]

    def _search_single_T(self, T, bvec, piv_col, ordering, w_perm):
        """OSD-e pattern search from the transform representation.

        Same search as ``_search_single``, but the RREF test-column bits are
        computed as parity(T[r] & Hc[ordering[test_col]]) instead of being
        read out of the packed full system (which the wide-system path never
        materializes). T (m, m_words) uint32; other args as _search_single.
        """
        n = self.n
        tgt = jnp.where(piv_col >= 0, piv_col, n)
        is_piv = jnp.zeros(n + 1, bool).at[tgt].set(piv_col >= 0)[:n]
        col_ids = jnp.arange(n)
        test_cols = jnp.argsort(
            jnp.where(is_piv, n + col_ids, col_ids), stable=True
        )[: self.num_test]
        test_valid = ~is_piv[test_cols]

        hc = self._Hc[ordering[test_cols]]  # (t, m_words)
        cnt = jnp.sum(
            jax.lax.population_count(T[:, None, :] & hc[None, :, :]),
            axis=-1,
            dtype=jnp.int32,
        )  # (m, t)
        Tmat = (cnt & 1).astype(jnp.float32)
        Tmat = Tmat * test_valid[None, :].astype(jnp.float32)

        F = self._patterns * test_valid[None, :].astype(jnp.float32)  # (C, t)
        piv_vals = jnp.mod(F @ Tmat.T + bvec.astype(jnp.float32)[None, :], 2.0)

        w_test = w_perm[test_cols] * test_valid
        w_piv = jnp.where(piv_col >= 0, w_perm[jnp.clip(piv_col, 0, n - 1)], 0.0)
        hi = jax.lax.Precision.HIGHEST  # LLR weights: see _osd_single
        costs = jnp.dot(F, w_test, precision=hi) + jnp.dot(
            piv_vals, w_piv, precision=hi
        )
        best = jnp.argmin(costs)

        f_best = self._patterns[best] * test_valid.astype(jnp.float32)
        pv_best = piv_vals[best]
        e_full = jnp.zeros(n + 1, jnp.float32).at[test_cols].set(f_best)
        e_full = e_full.at[tgt].set(jnp.where(piv_col >= 0, pv_best, 0.0))
        return e_full[:n].astype(jnp.uint32)

    def _search_single(self, A, bvec, piv_col, ordering, w_perm):
        """OSD-e pattern search from a precomputed RREF (permuted coords).

        A (m, n_words) uint32, bvec (m,), piv_col (m,) int32, ordering (n,),
        w_perm (n,) = |llr| * (1 - 2*hard) in permuted coords. Returns the
        best correction e_perm (n,) uint32 in permuted coords (zero pattern =
        OSD-0 listed first, so reference tie-breaking is preserved).
        """
        n = self.n
        tgt = jnp.where(piv_col >= 0, piv_col, n)
        is_piv = jnp.zeros(n + 1, bool).at[tgt].set(piv_col >= 0)[:n]
        col_ids = jnp.arange(n)
        test_cols = jnp.argsort(
            jnp.where(is_piv, n + col_ids, col_ids), stable=True
        )[: self.num_test]
        test_valid = ~is_piv[test_cols]

        words = A[:, test_cols // _WORD]  # (m, t)
        Tmat = ((words >> (test_cols % _WORD).astype(jnp.uint32)) & 1).astype(
            jnp.float32
        )
        Tmat = Tmat * test_valid[None, :].astype(jnp.float32)

        F = self._patterns * test_valid[None, :].astype(jnp.float32)  # (C, t)
        piv_vals = jnp.mod(F @ Tmat.T + bvec.astype(jnp.float32)[None, :], 2.0)

        w_test = w_perm[test_cols] * test_valid
        w_piv = jnp.where(piv_col >= 0, w_perm[jnp.clip(piv_col, 0, n - 1)], 0.0)
        hi = jax.lax.Precision.HIGHEST  # LLR weights: see _osd_single
        costs = jnp.dot(F, w_test, precision=hi) + jnp.dot(
            piv_vals, w_piv, precision=hi
        )
        best = jnp.argmin(costs)

        f_best = self._patterns[best] * test_valid.astype(jnp.float32)
        pv_best = piv_vals[best]
        e_full = jnp.zeros(n + 1, jnp.float32).at[test_cols].set(f_best)
        e_full = e_full.at[tgt].set(jnp.where(piv_col >= 0, pv_best, 0.0))
        return e_full[:n].astype(jnp.uint32)

    def _osde_lanes(self, syndromes, llrs, hard):
        """OSD-e on the lanes pipeline, searching only inconsistent systems.

        Consistent systems return OSD-0 untouched (the reference's early
        return, OSD_enhanced.py:59). Inconsistent samples are sorted to the
        front and pattern-searched in lax.map chunks; all-consistent chunks
        skip the search entirely via lax.cond, so the (rare) combination
        search costs nothing on clean-syndrome workloads.
        """
        n = self.n
        B = syndromes.shape[0]
        order, A_bt, b_bt, piv_bt, sol0 = self._lanes_core(syndromes, llrs, hard)
        consistent = jnp.all((piv_bt >= 0) | (b_bt == 0), axis=1)  # (B,)

        hard_i = hard.astype(jnp.int32)
        w = jnp.abs(llrs) * (1.0 - 2.0 * hard_i.astype(llrs.dtype))
        w_perm = jnp.take_along_axis(w, order, axis=1)  # (B, n)

        sel = jnp.argsort(consistent, stable=True)  # inconsistent first
        ch = max(1, min(self.config.chunk, B))
        pad = (-B) % ch
        padded = lambda x: (
            jnp.concatenate([x, jnp.repeat(x[:1], pad, axis=0)], axis=0)
            if pad
            else x
        )
        gather = lambda x: padded(x[sel]).reshape(-1, ch, *x.shape[1:])
        A_c, b_c, piv_c, ord_c, w_c = map(
            gather, (A_bt, b_bt, piv_bt, order, w_perm)
        )
        active_c = gather(~consistent)

        def chunk_fn(args):
            A, bvec, piv, ordc, wp, active = args
            search = (
                self._search_single_T
                if self._use_transform
                else self._search_single
            )

            def do_search(_):
                return jax.vmap(search)(A, bvec, piv, ordc, wp)

            return jax.lax.cond(
                jnp.any(active),
                do_search,
                lambda _: jnp.zeros((ch, n), jnp.uint32),
                None,
            )

        e_perm_best = jax.lax.map(
            chunk_fn, (A_c, b_c, piv_c, ord_c, w_c, active_c)
        ).reshape(-1, n)[:B]

        # un-permute the searched corrections and overwrite only the
        # genuinely inconsistent samples
        bidx = jnp.arange(B)[:, None]
        order_sel = order[sel]
        corr = (
            jnp.zeros((B, n), jnp.uint32)
            .at[bidx, order_sel]
            .set(e_perm_best)
        )
        sol_search = ((hard_i[sel] + corr.astype(jnp.int32)) % 2).astype(jnp.int8)
        use = (~consistent)[sel][:, None]
        return sol0.at[sel].set(jnp.where(use, sol_search, sol0[sel]))

    def __call__(self, syndromes, llrs, hard) -> jax.Array:
        return self._decode(
            jnp.asarray(syndromes), jnp.asarray(llrs), jnp.asarray(hard)
        )
