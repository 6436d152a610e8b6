"""Batched belief-propagation decoding.

Functional parity targets (algorithm semantics, not code):
  - tanh-rule sum-product BP with product-by-division, 1e-15 safe floor and
    ±0.9999999 clip before arctanh (reference: decoding/beliefPropagation.py:110-126);
  - normalized min-sum with sign-product + two-minima update, alpha scaling,
    damping and symmetric LLR clipping (reference: rework/decoding.py:26-67);
  - damped/clipped tanh BP (reference: rework/decoding.py:154-183);
  - per-sample convergence at the first iteration whose hard decision
    reproduces the syndrome, reported like the reference's early-exit loop
    (iteration index at convergence, maxIter-1 when never converged).

Design (nothing here mirrors the reference's implementation):
  - natively batched over a leading sample axis, messages live on a (B, E+1)
    edge array (phantom edge E absorbs padding) instead of dense (m, n);
  - fixed-trip-count ``lax.scan`` with a convergence freeze mask, wrapped in a
    ``lax.while_loop`` over scan chunks so a fully-converged batch exits early
    without data-dependent shapes;
  - all graph tables are static constants baked into the jitted computation.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from qldpc_jax.ops.tanner import TannerGraph

__all__ = ["BPConfig", "BPResult", "BPDecoder"]

# Matches the reference's clip of the tanh-product before arctanh
# (decoding/beliefPropagation.py:110). In float32 this rounds to 1 - 2^-23-ish,
# giving arctanh ~ 8.3 — the same saturation the reference's JAX path had.
_TANH_CLIP = 0.9999999


class BPResult(NamedTuple):
    """Per-sample decoding outputs (all batched on the leading axis)."""

    hard: jax.Array  # (B, n) int8 hard decision (candidate error)
    converged: jax.Array  # (B,) bool — syndrome reproduced within max_iter
    llrs: jax.Array  # (B, n) float — posterior LLRs at exit iteration
    iterations: jax.Array  # (B,) int32 — iteration index at convergence


@dataclasses.dataclass(frozen=True)
class BPConfig:
    """Decoder hyper-parameters (static: changing them recompiles)."""

    max_iter: int = 50
    method: str = "sum-product"  # "sum-product" | "min-sum"
    alpha: float = 1.0  # normalization of check messages (min-sum: typ. 0.6-0.9)
    offset: float = 0.0  # offset min-sum: |R| -> max(|R| - offset, 0)
    damping: float = 1.0  # 1.0 = no damping; Q = d*Q_new + (1-d)*Q_old
    clip_llr: float | None = None  # symmetric clip of Q messages, None = off
    chunk_size: int = 0  # >0: early-exit between chunks of this many iters
    schedule: str = "flooding"  # "flooding" | "layered" (check-serial)
    n_layers: int = 0  # layered: check groups per iteration; 0 = auto
    dtype: str = "float32"
    backend: str = "xla"  # "xla" | "pallas" (fused GPU kernel, ops/bp_triton.py)

    def __post_init__(self):
        if self.method not in ("sum-product", "min-sum"):
            raise ValueError(f"unknown BP method {self.method!r}")
        if self.offset and self.method != "min-sum":
            raise ValueError("offset applies to the min-sum method only")
        if self.schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
        if self.schedule == "layered" and self.damping != 1.0:
            raise ValueError("damping is not supported with the layered "
                             "schedule (messages are recomputed per layer)")
        if self.chunk_size and self.max_iter % self.chunk_size:
            raise ValueError("max_iter must be a multiple of chunk_size")
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")


class _Carry(NamedTuple):
    Q: jax.Array  # (B, E) var->check messages
    Q_old: jax.Array  # (B, E) previous messages (damping)
    values: jax.Array  # (B, n) posterior LLRs (frozen at convergence)
    hard: jax.Array  # (B, n) int8 hard decision (frozen)
    converged: jax.Array  # (B,) bool
    iters: jax.Array  # (B,) int32
    step: jax.Array  # () int32 global iteration counter


class BPDecoder:
    """Jitted batched BP decoder for a fixed parity-check matrix.

    Usage::

        dec = BPDecoder(H, BPConfig(max_iter=50))
        res = dec(syndromes, priors)     # syndromes (B, m), priors (n,) or (B, n)
    """

    def __init__(self, H: np.ndarray, config: BPConfig = BPConfig(),
                 interpret: bool = False):
        """``interpret=True`` runs the pallas backend's kernel through the
        Pallas interpreter (tests on a machine without a GPU)."""
        self.config = config
        self._interpret = interpret
        self.graph = g = TannerGraph.from_H(H)
        self._dtype = jnp.dtype(config.dtype)
        # Irregular graphs (DEM / materialized space-time) use the padded
        # CHECK-SLOT layout: messages live on (B, m*dc_max) where the
        # check-side grouping is a free reshape + phantom mask, instead of
        # (B, E) where grouping costs an edge->slot gather and a slot->edge
        # scatter every iteration. Per-edge arithmetic and reduction order
        # are identical, so results match the edge layout bit-for-bit.
        self._slot_layout = not g.check_regular
        if self._slot_layout:
            S = g.m * g.dc_max
            ce_flat = g.check_edge.reshape(-1)  # (S,) edge ids, phantom == E
            real = ce_flat < g.num_edges
            var_of_slot = np.zeros(S, np.int32)
            var_of_slot[real] = g.var_of_edge[ce_flat[real]]
            var_edge_slots = np.where(
                g.var_edge < g.num_edges,
                g.check_slot_of_edge[np.minimum(g.var_edge, g.num_edges - 1)],
                S,
            ).astype(np.int32)
            self._var_edge = np.asarray(var_edge_slots)
            self._var_of_edge = np.asarray(var_of_slot)
            self._slot_mask = np.asarray(real)
        else:
            self._var_edge = np.asarray(g.var_edge)
            self._var_of_edge = np.asarray(g.var_of_edge)
        # Static index tables stay host-side numpy: they embed in the
        # jitted program as constants at trace time, with no device fetch.
        self._check_edge = np.asarray(g.check_edge)
        self._check_slot_of_edge = np.asarray(g.check_slot_of_edge)
        if config.backend == "pallas":
            self.decode_fn = self._build_pallas()
        elif config.schedule == "layered":
            self.decode_fn = self._build_layered()
        else:
            self.decode_fn = self._build()  # unjitted (for graft/compile checks)
        self._decode = jax.jit(self.decode_fn)

    # ---- layout helpers -----------------------------------------------------
    # "edge space" below means (B, E) for regular graphs and the padded
    # (B, m*dc_max) slot space for irregular ones (see __init__).
    def _gather_check(self, x_edges: jax.Array, phantom) -> jax.Array:
        """Edge-space values -> (B, m, dc_max) per-check groups."""
        g = self.graph
        if self._slot_layout:
            masked = jnp.where(
                self._slot_mask, x_edges, jnp.asarray(phantom, x_edges.dtype)
            )
            return masked.reshape(x_edges.shape[0], g.m, g.dc_max)
        return x_edges.reshape(x_edges.shape[0], g.m, g.dc_max)

    def _scatter_check(self, y: jax.Array) -> jax.Array:
        """(B, m, dc_max) per-check results -> edge-space values."""
        g = self.graph
        return y.reshape(y.shape[0], g.m * g.dc_max)

    def _gather_var(self, x_edges: jax.Array, phantom) -> jax.Array:
        """Edge-space values -> (B, n, dv_max) per-variable groups."""
        pad = jnp.full((x_edges.shape[0], 1), phantom, x_edges.dtype)
        return jnp.concatenate([x_edges, pad], axis=1)[:, self._var_edge]

    # ---- message updates ----------------------------------------------------
    @staticmethod
    def _others_product(t: jax.Array) -> jax.Array:
        """Exact leave-one-out product along the last axis via prefix/suffix
        cumulative products.

        Replaces the reference's divide-by-self trick with its 1e-15 safe
        floor (decoding/beliefPropagation.py:121-123): division-free is
        exact when a message is ~0.
        """
        ones = jnp.ones_like(t[..., :1])
        pre = jnp.cumprod(t, axis=-1)
        suf = jnp.cumprod(t[..., ::-1], axis=-1)[..., ::-1]
        left = jnp.concatenate([ones, pre[..., :-1]], axis=-1)
        right = jnp.concatenate([suf[..., 1:], ones], axis=-1)
        return left * right

    def _check_messages(
        self, Q: jax.Array, syndrome_sign: jax.Array, alpha=None
    ) -> jax.Array:
        """Check-to-variable messages R (B, E), already alpha-scaled.

        ``alpha=None`` bakes the static ``config.alpha`` (unchanged HLO);
        passing a traced scalar lets one compiled program serve a whole
        fitted-alpha sweep (Alvarado per-rate alphas would otherwise force a
        cold recompile per grid point)."""
        cfg = self.config
        dc = self.graph.dc_max
        # dc-scaling switch: the prefix/suffix cumprod is exact but
        # sequential along the slot axis, and at DEM-scale check degrees
        # (dc ~ 300) it dominates the iteration. Large-dc graphs use
        # one-pass formulations instead: log-domain total-minus-one for
        # tanh magnitudes (~1e-5 relative error, invisible under the
        # arctanh clip) and the exact total-parity product for signs.
        # Small dc keeps the cumprod, for oracle parity.
        # float64 configs always use the exact cumprod regardless of dc:
        # the design invariant pins f64 decisions to tests/oracles.py
        # exactly, and f64 is an oracle/debug path where speed is moot.
        large_dc = dc > 16 and self._dtype != jnp.float64
        ssign = jnp.repeat(syndrome_sign[:, :, None], dc, axis=-1)
        if cfg.method == "sum-product":
            t = jnp.tanh(Q * 0.5)
            tc = self._gather_check(t, phantom=jnp.asarray(1.0, self._dtype))
            if large_dc:
                s = jnp.where(tc >= 0, 1.0, -1.0).astype(self._dtype)
                neg = jnp.sum((tc < 0).astype(jnp.int32), axis=-1, keepdims=True)
                total_sign = (1 - 2 * (neg % 2)).astype(self._dtype)
                lt = jnp.log(jnp.maximum(jnp.abs(tc), 1e-15))
                total = jnp.sum(lt, axis=-1, keepdims=True)
                others = jnp.exp(total - lt) * total_sign * s
            else:
                others = self._others_product(tc)
            clipped = jnp.clip(others * ssign, -_TANH_CLIP, _TANH_CLIP)
            R = 2.0 * jnp.arctanh(clipped)
        else:  # min-sum: sign product x second-smallest-magnitude trick
            sgn = jnp.where(Q >= 0, 1.0, -1.0).astype(self._dtype)
            sc = self._gather_check(sgn, phantom=jnp.asarray(1.0, self._dtype))
            if large_dc:
                neg = jnp.sum((sc < 0).astype(jnp.int32), axis=-1, keepdims=True)
                total_sign = (1 - 2 * (neg % 2)).astype(self._dtype)
                r_signs = total_sign * sc  # exact: sc in {+-1}
            else:
                r_signs = self._others_product(sc)
            aq = self._gather_check(
                jnp.abs(Q), phantom=jnp.asarray(jnp.inf, self._dtype)
            )
            min1 = jnp.min(aq, axis=-1, keepdims=True)
            first_min = jax.nn.one_hot(
                jnp.argmin(aq, axis=-1), aq.shape[-1], dtype=bool
            )
            min2 = jnp.min(jnp.where(first_min, jnp.inf, aq), axis=-1, keepdims=True)
            mags = jnp.where(
                aq == jnp.repeat(min1, dc, axis=-1),
                jnp.repeat(min2, dc, axis=-1),
                jnp.repeat(min1, dc, axis=-1),
            )
            if cfg.offset:
                mags = jnp.maximum(mags - cfg.offset, 0.0)
            R = ssign * r_signs * mags
        if alpha is not None:
            R = R * alpha.astype(self._dtype)
        elif cfg.alpha != 1.0:
            R = R * jnp.asarray(cfg.alpha, self._dtype)
        return self._scatter_check(R)

    def _step(self, carry: _Carry, syndrome: jax.Array, syndrome_sign, priors,
              alpha=None):
        """One BP iteration with convergence freeze."""
        cfg, g = self.config, self.graph
        R = self._check_messages(carry.Q, syndrome_sign, alpha)

        rv = self._gather_var(R, phantom=jnp.asarray(0.0, self._dtype))
        # sequential left-fold (not jnp.sum): pins the fp accumulation
        # order, which the GPU kernel (ops/bp_triton.py) folds the same way
        values = rv[..., 0]
        for j in range(1, rv.shape[-1]):
            values = values + rv[..., j]
        values = values + priors  # (B, n)
        Q_new = values[:, self._var_of_edge] - R
        if cfg.damping != 1.0:
            Q_new = cfg.damping * Q_new + (1.0 - cfg.damping) * carry.Q_old
        if cfg.clip_llr is not None:
            Q_new = jnp.clip(Q_new, -cfg.clip_llr, cfg.clip_llr)

        hard = (values < 0).astype(jnp.int8)
        # syndrome of the hard decision, via per-check parity of edge-gathered bits
        hg = self._gather_check(
            hard[:, self._var_of_edge].astype(jnp.int32), phantom=jnp.asarray(0)
        )
        s_hat = jnp.sum(hg, axis=-1) % 2
        now_ok = jnp.all(s_hat == syndrome, axis=-1)

        keep = carry.converged  # frozen before this iteration ran
        keep_e = keep[:, None]
        return _Carry(
            Q=jnp.where(keep_e, carry.Q, Q_new),
            Q_old=jnp.where(keep_e, carry.Q_old, Q_new),
            values=jnp.where(keep_e, carry.values, values),
            hard=jnp.where(keep_e, carry.hard, hard),
            converged=keep | now_ok,
            iters=jnp.where(keep, carry.iters, carry.step),
            step=carry.step + 1,
        )

    # ---- driver -------------------------------------------------------------
    def _build(self):
        cfg, g = self.config, self.graph

        def decode(
            syndromes: jax.Array, priors: jax.Array, alpha=None
        ) -> BPResult:
            B = syndromes.shape[0]
            syndromes = syndromes.astype(jnp.int32)
            priors = jnp.broadcast_to(
                jnp.asarray(priors, self._dtype), (B, g.n)
            )
            syndrome_sign = (1 - 2 * syndromes).astype(self._dtype)
            Q0 = priors[:, self._var_of_edge]
            carry = _Carry(
                Q=Q0,
                Q_old=Q0,
                values=priors,
                hard=jnp.zeros((B, g.n), jnp.int8),
                converged=jnp.zeros((B,), bool),
                iters=jnp.full((B,), max(cfg.max_iter - 1, 0), jnp.int32),
                step=jnp.zeros((), jnp.int32),
            )

            def scan_step(c, _):
                return (
                    self._step(c, syndromes, syndrome_sign, priors, alpha),
                    None,
                )

            if cfg.chunk_size:
                n_chunks = cfg.max_iter // cfg.chunk_size

                def cond(c):
                    return (c.step < cfg.max_iter) & ~jnp.all(c.converged)

                def body(c):
                    c, _ = jax.lax.scan(scan_step, c, None, length=cfg.chunk_size)
                    return c

                carry = jax.lax.while_loop(cond, body, carry)
            else:
                carry, _ = jax.lax.scan(scan_step, carry, None, length=cfg.max_iter)

            iters = jnp.where(
                carry.converged, carry.iters, max(cfg.max_iter - 1, 0)
            )
            return BPResult(
                hard=carry.hard,
                converged=carry.converged,
                llrs=carry.values,
                iterations=iters,
            )

        return decode

    # ---- layered (check-serial) schedule ------------------------------------
    def _group_check_update(self, qg: jax.Array, ssign_g: jax.Array, alpha):
        """Check rule on an all-real (B, ml, dc) group (no phantom slots).

        Same math as ``_check_messages`` — tanh leave-one-out product or
        normalized/offset min-sum — applied to one layer's checks. The
        layered schedule only runs on check-regular graphs, so every slot
        is a real edge and the phantom handling of the flooding path is
        unnecessary here.
        """
        cfg = self.config
        dc = qg.shape[-1]
        if cfg.method == "sum-product":
            t = jnp.tanh(qg * 0.5)
            others = self._others_product(t)
            clipped = jnp.clip(others * ssign_g, -_TANH_CLIP, _TANH_CLIP)
            R = 2.0 * jnp.arctanh(clipped)
        else:
            sgn = jnp.where(qg >= 0, 1.0, -1.0).astype(self._dtype)
            r_signs = self._others_product(sgn)
            aq = jnp.abs(qg)
            min1 = jnp.min(aq, axis=-1, keepdims=True)
            first_min = jax.nn.one_hot(
                jnp.argmin(aq, axis=-1), dc, dtype=bool
            )
            min2 = jnp.min(jnp.where(first_min, jnp.inf, aq), axis=-1, keepdims=True)
            mags = jnp.where(
                aq == jnp.repeat(min1, dc, axis=-1),
                jnp.repeat(min2, dc, axis=-1),
                jnp.repeat(min1, dc, axis=-1),
            )
            if cfg.offset:
                mags = jnp.maximum(mags - cfg.offset, 0.0)
            R = ssign_g * r_signs * mags
        if alpha is not None:
            R = R * alpha.astype(self._dtype)
        elif cfg.alpha != 1.0:
            R = R * jnp.asarray(cfg.alpha, self._dtype)
        return R

    def _build_layered(self):
        """Check-serial ("layered") BP: checks are processed in ``n_layers``
        static groups per iteration, each layer consuming posteriors already
        refreshed by the previous layers. Standard LDPC result: converges in
        roughly half the iterations of the flooding schedule at the same
        fixed point — a decoder-zoo extension beyond the reference, which
        only implements flooding (decoding/beliefPropagation.py:104-133).

        Per layer: Q_l = values[v(e)] - R_e (fresh posteriors), check rule
        on the (B, ml, dc) group, then values += sum_v(R_new - R_old). All
        layer slices are static, so this is one fixed-trip-count scan like
        the flooding path, with the same freeze/early-exit machinery.
        """
        cfg, g = self.config, self.graph
        if not g.check_regular:
            raise ValueError(
                "the layered schedule requires a check-regular graph "
                "(every check with the same degree)"
            )
        L = cfg.n_layers
        if L == 0:  # auto: the largest of 4, 3, 2 dividing m
            L = next((k for k in (4, 3, 2) if g.m % k == 0), 1)
        if g.m % L:
            raise ValueError(f"n_layers={L} must divide m={g.m}")
        ml = g.m // L
        dc = g.dc_max
        var_l = [self._var_of_edge[l * ml * dc:(l + 1) * ml * dc] for l in range(L)]

        def decode(syndromes: jax.Array, priors: jax.Array, alpha=None) -> BPResult:
            B = syndromes.shape[0]
            syndromes = syndromes.astype(jnp.int32)
            priors = jnp.broadcast_to(jnp.asarray(priors, self._dtype), (B, g.n))
            syndrome_sign = (1 - 2 * syndromes).astype(self._dtype)
            ssign_l = [
                jnp.repeat(
                    syndrome_sign[:, l * ml:(l + 1) * ml, None], dc, axis=-1
                )
                for l in range(L)
            ]

            def step(carry, _):
                R, values, hard0, converged, iters, stepc = carry
                v = values
                Rn = R
                for l in range(L):
                    sl_lo = l * ml * dc
                    R_l = jax.lax.slice_in_dim(Rn, sl_lo, sl_lo + ml * dc, axis=1)
                    Q_l = v[:, var_l[l]] - R_l
                    if cfg.clip_llr is not None:
                        Q_l = jnp.clip(Q_l, -cfg.clip_llr, cfg.clip_llr)
                    Rg = self._group_check_update(
                        Q_l.reshape(B, ml, dc), ssign_l[l], alpha
                    )
                    R_l_new = Rg.reshape(B, ml * dc)
                    v = v.at[:, var_l[l]].add(R_l_new - R_l)
                    Rn = jax.lax.dynamic_update_slice_in_dim(
                        Rn, R_l_new, sl_lo, axis=1
                    )
                hard = (v < 0).astype(jnp.int8)
                hg = self._gather_check(
                    hard[:, self._var_of_edge].astype(jnp.int32),
                    phantom=jnp.asarray(0),
                )
                s_hat = jnp.sum(hg, axis=-1) % 2
                now_ok = jnp.all(s_hat == syndromes, axis=-1)
                keep = converged
                keep_e = keep[:, None]
                return (
                    jnp.where(keep_e, R, Rn),
                    jnp.where(keep_e, values, v),
                    jnp.where(keep_e, hard0, hard),
                    keep | now_ok,
                    jnp.where(keep, iters, stepc),
                    stepc + 1,
                ), None

            carry = (
                jnp.zeros((B, g.num_edges), self._dtype),
                priors,
                jnp.zeros((B, g.n), jnp.int8),
                jnp.zeros((B,), bool),
                jnp.full((B,), max(cfg.max_iter - 1, 0), jnp.int32),
                jnp.zeros((), jnp.int32),
            )
            if cfg.chunk_size:
                def cond(c):
                    return (c[5] < cfg.max_iter) & ~jnp.all(c[3])

                def body(c):
                    c, _ = jax.lax.scan(step, c, None, length=cfg.chunk_size)
                    return c

                carry = jax.lax.while_loop(cond, body, carry)
            else:
                carry, _ = jax.lax.scan(step, carry, None, length=cfg.max_iter)

            _, values, hard, converged, iters, _ = carry
            iters = jnp.where(converged, iters, max(cfg.max_iter - 1, 0))
            return BPResult(
                hard=hard, converged=converged, llrs=values, iterations=iters
            )

        return decode

    def _build_pallas(self):
        """Fused GPU kernel path (qldpc_jax.ops.bp_triton). A graph or
        configuration the kernel does not cover is an error."""
        from qldpc_jax.ops.bp_triton import TritonBPKernel, kernel_supports

        cfg = self.config
        reason = kernel_supports(
            self.graph, schedule=cfg.schedule, damping=cfg.damping
        )
        if reason:
            raise ValueError(f"backend='pallas': {reason}; use backend='xla'")
        kernel = TritonBPKernel(
            self.graph,
            max_iter=cfg.max_iter,
            method=cfg.method,
            alpha=cfg.alpha,
            offset=cfg.offset,
            clip_llr=cfg.clip_llr,
            interpret=self._interpret,
        )

        def decode(
            syndromes: jax.Array, priors: jax.Array, alpha=None
        ) -> BPResult:
            if alpha is not None:
                raise ValueError(
                    "the pallas backend bakes alpha statically; use the xla "
                    "backend for traced-alpha sweeps"
                )
            values, conv, iters = kernel(syndromes, priors)
            return BPResult(
                hard=(values < 0).astype(jnp.int8),
                converged=conv,
                llrs=values,
                iterations=iters,
            )

        return decode

    def __call__(self, syndromes, priors, alpha=None) -> BPResult:
        return self._decode(
            jnp.asarray(syndromes), jnp.asarray(priors),
            None if alpha is None else jnp.asarray(alpha),
        )

    # ---- auxiliary: raw check messages for alpha estimation -----------------
    @functools.cached_property
    def _raw_check_messages(self):
        """R after ``at_iter+1`` unnormalized iterations, for Alvarado fits.

        Mirrors the reference's ``alpha_estimation`` escape hatch
        (rework/decoding.py:58-59 min-sum at iter 0; :168-169 tanh at iter 10)
        but returns the (B, E) edge-ordered message array.
        """

        @functools.partial(jax.jit, static_argnames=("at_iter",))
        def run(syndromes, priors, at_iter: int = 0):
            B = syndromes.shape[0]
            g = self.graph
            priors_b = jnp.broadcast_to(jnp.asarray(priors, self._dtype), (B, g.n))
            syndromes = syndromes.astype(jnp.int32)
            ssign = (1 - 2 * syndromes).astype(self._dtype)
            Q = priors_b[:, self._var_of_edge]
            R = self._check_messages(Q, ssign)
            for _ in range(at_iter):
                rv = self._gather_var(R, phantom=jnp.asarray(0.0, self._dtype))
                values = jnp.sum(rv, axis=-1) + priors_b
                Q = values[:, self._var_of_edge] - R
                R = self._check_messages(Q, ssign)
            return R

        return run

    def check_messages(self, syndromes, priors, at_iter: int = 0) -> jax.Array:
        alpha = self.config.alpha
        R = self._raw_check_messages(
            jnp.asarray(syndromes), jnp.asarray(priors), at_iter=at_iter
        )
        if self._slot_layout:  # slot space -> edge order (public contract)
            R = R[:, self._check_slot_of_edge]
        return R / alpha if alpha != 1.0 else R
