"""Structured space-time BP: decode multi-round syndromes without ever
materializing kron(I_T, H).

The generic decoder treats the space-time matrix
``H_st = [I_T (x) H | I + S_{-m}]`` (noise/spacetime.py) as an arbitrary
graph, which costs per-edge gather tables that grow with T. This decoder
exploits the structure directly (the "long-context" scaling called out in
SURVEY.md §5.7):

  * spatial messages live on a (B, T, E_base) array — every round reuses the
    *base* code's Tanner tables, so table memory is independent of T;
  * the two temporal edges of each check (u_t and u_{t-1}) are two extra
    (B, T, m) message planes, concatenated onto the check groups as slots
    dc and dc+1, after which the check update is the generic leave-one-out
    product over dc+2 slots;
  * the temporal variable update is a shift (u_{t} couples checks t and
    t+1), not a gather.

Semantics are identical to ``BPDecoder`` on the materialized H_st (verified
in tests): same clipping, freeze, iteration accounting; variable ordering of
the output matches space_time_matrix's columns (all data rounds, then all
measurement rounds).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qldpc_jax.decoders.bp import _TANH_CLIP, BPConfig, BPResult
from qldpc_jax.ops.tanner import TannerGraph

__all__ = ["SpaceTimeBPDecoder"]

_BIG = 1e9


class SpaceTimeBPDecoder:
    """Batched BP over T measurement rounds of a base CSS check matrix.

    ``__call__(detectors (B, T*m), priors (T*n + T*m,)) -> BPResult`` with
    hard/llrs over the full space-time variable vector (data rounds first,
    then measurement rounds — the column order of
    noise/spacetime.py::space_time_matrix).
    """

    def __init__(self, H_base: np.ndarray, n_rounds: int, config: BPConfig = BPConfig()):
        if config.backend != "xla":
            raise NotImplementedError(
                "the structured space-time decoder runs on the xla backend"
            )
        if config.schedule != "flooding":
            raise NotImplementedError(
                "the structured space-time decoder supports the flooding "
                "schedule only"
            )
        self.config = config
        self.T = n_rounds
        g = TannerGraph.from_H(H_base)
        if not g.check_regular:
            raise NotImplementedError("base code must be check-regular")
        self.base = g
        self.m, self.n, self.E = g.m, g.n, g.num_edges
        self.dc = g.dc_max
        # host-side numpy tables: embedded as constants at trace time
        self._var_edge = np.asarray(g.var_edge)
        self._var_of_edge = np.asarray(g.var_of_edge)
        self._Hf = g.H.astype(np.float32)
        self.n_vars = self.T * (self.n + self.m)
        self.decode_fn = self._build()
        self._decode = jax.jit(self.decode_fn)

    @staticmethod
    def _others_product(t):
        ones = jnp.ones_like(t[..., :1])
        pre = jnp.cumprod(t, axis=-1)
        suf = jnp.cumprod(t[..., ::-1], axis=-1)[..., ::-1]
        left = jnp.concatenate([ones, pre[..., :-1]], axis=-1)
        right = jnp.concatenate([suf[..., 1:], ones], axis=-1)
        return left * right

    def _build(self):
        cfg = self.config
        T, m, n, E, dc = self.T, self.m, self.n, self.E, self.dc

        def step(carry, syn, ssign, prior_sp, prior_u, alpha=None):
            Qs, Qa, Qb, values_sp, values_u, conv, iters, it = carry
            B = Qs.shape[0]

            # ---- check update over dc+2 slots --------------------------------
            qq = jnp.concatenate(
                [Qs.reshape(B, T, m, dc), Qa[..., None], Qb[..., None]], axis=-1
            )  # (B, T, m, dc+2); Qb[:, 0] pinned to BIG (neutral)
            ssign_full = jnp.repeat(ssign[..., None], dc + 2, axis=-1)
            if cfg.method == "sum-product":
                tt = jnp.tanh(qq * 0.5)
                others = self._others_product(tt)
                clipped = jnp.clip(others * ssign_full, -_TANH_CLIP, _TANH_CLIP)
                R = 2.0 * jnp.arctanh(clipped)
            else:  # min-sum (same formulation as decoders/bp.py)
                sgn = jnp.where(qq >= 0, jnp.float32(1.0), jnp.float32(-1.0))
                r_signs = self._others_product(sgn)
                aq = jnp.abs(qq)
                min1 = jnp.min(aq, axis=-1, keepdims=True)
                first_min = jax.nn.one_hot(
                    jnp.argmin(aq, axis=-1), dc + 2, dtype=bool
                )
                min2 = jnp.min(
                    jnp.where(first_min, jnp.inf, aq), axis=-1, keepdims=True
                )
                mags = jnp.where(
                    aq == jnp.repeat(min1, dc + 2, axis=-1),
                    jnp.repeat(min2, dc + 2, axis=-1),
                    jnp.repeat(min1, dc + 2, axis=-1),
                )
                if cfg.offset:
                    mags = jnp.maximum(mags - cfg.offset, 0.0)
                R = ssign_full * r_signs * mags
            if alpha is not None:
                R = R * alpha.astype(R.dtype)
            elif cfg.alpha != 1.0:
                R = R * jnp.float32(cfg.alpha)
            R_sp = R[..., :dc].reshape(B, T, E)
            R_a = R[..., dc]
            R_b = R[..., dc + 1]  # only meaningful for t >= 1

            # ---- spatial variable update (per-round base gather) -------------
            pad = jnp.zeros((B, T, 1), R_sp.dtype)
            rv = jnp.concatenate([R_sp, pad], axis=-1)[:, :, self._var_edge]
            new_values_sp = jnp.sum(rv, axis=-1) + prior_sp  # (B, T, n)
            Qs_new = new_values_sp[:, :, self._var_of_edge] - R_sp

            # ---- temporal variable update (shift, not gather) ----------------
            # u_t couples check (t, c) via R_a[t] and check (t+1, c) via R_b[t+1]
            r_b_next = jnp.concatenate(
                [R_b[:, 1:], jnp.zeros((B, 1, m), R_b.dtype)], axis=1
            )
            new_values_u = R_a + r_b_next + prior_u  # (B, T, m)
            Qa_new = new_values_u - R_a
            qb_tail = new_values_u[:, :-1] - R_b[:, 1:]  # edges into checks 1..T-1
            Qb_new = jnp.concatenate(
                [jnp.full((B, 1, m), _BIG, Qb.dtype), qb_tail], axis=1
            )

            if cfg.damping != 1.0:
                Qs_new = cfg.damping * Qs_new + (1 - cfg.damping) * Qs
                Qa_new = cfg.damping * Qa_new + (1 - cfg.damping) * Qa
                Qb_new = jnp.concatenate(
                    [
                        Qb_new[:, :1],
                        cfg.damping * Qb_new[:, 1:] + (1 - cfg.damping) * Qb[:, 1:],
                    ],
                    axis=1,
                )
            if cfg.clip_llr is not None:
                Qs_new = jnp.clip(Qs_new, -cfg.clip_llr, cfg.clip_llr)
                Qa_new = jnp.clip(Qa_new, -cfg.clip_llr, cfg.clip_llr)
                Qb_new = jnp.concatenate(
                    [Qb_new[:, :1], jnp.clip(Qb_new[:, 1:], -cfg.clip_llr, cfg.clip_llr)],
                    axis=1,
                )

            # ---- hard decision + structured syndrome check -------------------
            hard_sp = (new_values_sp < 0).astype(jnp.float32)
            hard_u = (new_values_u < 0).astype(jnp.float32)
            s_spatial = jnp.einsum("btn,mn->btm", hard_sp, self._Hf)
            hu_prev = jnp.concatenate(
                [jnp.zeros((B, 1, m), hard_u.dtype), hard_u[:, :-1]], axis=1
            )
            counts = s_spatial + hard_u + hu_prev
            parity = counts - 2.0 * jnp.floor(counts * 0.5)
            now_ok = jnp.all((parity == syn).reshape(B, -1), axis=-1)

            keep = conv
            k3 = keep[:, None, None]
            carry = (
                jnp.where(k3, Qs, Qs_new),
                jnp.where(k3, Qa, Qa_new),
                jnp.where(k3, Qb, Qb_new),
                jnp.where(k3, values_sp, new_values_sp),
                jnp.where(k3, values_u, new_values_u),
                keep | now_ok,
                jnp.where(keep, iters, it),
                it + 1,
            )
            return carry

        def decode(
            detectors: jax.Array, priors: jax.Array, alpha=None
        ) -> BPResult:
            B = detectors.shape[0]
            syn = detectors.astype(jnp.float32).reshape(B, T, m)
            ssign = 1.0 - 2.0 * syn
            priors = jnp.asarray(priors, jnp.float32)
            prior_sp = jnp.broadcast_to(priors[: T * n].reshape(T, n), (B, T, n))
            prior_u = jnp.broadcast_to(
                priors[T * n :].reshape(T, m), (B, T, m)
            )

            Qs0 = prior_sp[:, :, self._var_of_edge]
            Qa0 = prior_u
            Qb0 = jnp.concatenate(
                [jnp.full((B, 1, m), _BIG, jnp.float32), prior_u[:, :-1]], axis=1
            )
            carry = (
                Qs0,
                Qa0,
                Qb0,
                prior_sp,
                prior_u,
                jnp.zeros((B,), bool),
                jnp.full((B,), max(cfg.max_iter - 1, 0), jnp.int32),
                jnp.zeros((), jnp.int32),
            )

            def scan_step(c, _):
                return step(c, syn, ssign, prior_sp, prior_u, alpha), None

            if cfg.chunk_size:
                def cond(c):
                    return (c[-1] < cfg.max_iter) & ~jnp.all(c[5])

                def body(c):
                    c, _ = jax.lax.scan(scan_step, c, None, length=cfg.chunk_size)
                    return c

                carry = jax.lax.while_loop(cond, body, carry)
            else:
                carry, _ = jax.lax.scan(scan_step, carry, None, length=cfg.max_iter)

            _, _, _, values_sp, values_u, conv, iters, _ = carry
            values = jnp.concatenate(
                [values_sp.reshape(B, T * n), values_u.reshape(B, T * m)], axis=1
            )
            return BPResult(
                hard=(values < 0).astype(jnp.int8),
                converged=conv,
                llrs=values,
                iterations=jnp.where(conv, iters, max(cfg.max_iter - 1, 0)),
            )

        return decode

    def __call__(self, detectors, priors, alpha=None) -> BPResult:
        return self._decode(
            jnp.asarray(detectors), jnp.asarray(priors),
            None if alpha is None else jnp.asarray(alpha),
        )
