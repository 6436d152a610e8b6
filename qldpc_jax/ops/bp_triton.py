"""Fused flooding-BP kernel for the GPU (Pallas, Triton route).

The XLA path (decoders/bp.py) keeps its (B, E) message carries in device
memory and reads and writes them several times per iteration; its early
exit is whole-batch, so one straggler lane keeps every lane iterating.
This kernel decodes one tile of ``batch_tile`` lanes (16 by default) per
program and runs the whole iteration loop inside it, with a per-tile early
exit:

  * layout is batch-minor: every buffer is (rows, B), so each row a
    program touches is ``batch_tile`` contiguous floats;
  * the tile's state is R (check-to-variable messages, one row per
    slot-major edge) and the posterior values. Q is never stored:
    Q_e = values[v(e)] - R_e is rebuilt from a gather at the start of each
    check update;
  * both gathers (values at each edge's variable, R at each variable's
    edges) are indexed row loads from the tile's own columns of the state
    buffers, which stay in L1/L2 while the tile iterates;
  * the check update walks 16 checks at a time and the variable update 16
    variables at a time, so register use is bounded independently of the
    code size;
  * the syndrome check of iteration t shares the values gather of
    iteration t+1's check update.

Semantics follow BPDecoder's flooding schedule (sum-product with the
prefix/suffix leave-one-out product, or normalized/offset min-sum), with
the same convergence freeze and iteration accounting. Supported: check-
regular graphs, no damping (damping needs the previous Q, which the kernel
does not keep). Decisions agree with the XLA path except where float32
rounding differs (transcendentals and reduction order are the GPU's own).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from qldpc_jax.ops.tanner import TannerGraph

__all__ = ["TritonBPKernel", "kernel_supports", "DEFAULT_BATCH_TILE"]

_TANH_CLIP = 0.9999999
# Measured on an H100 at [[144,12,12]], BP(50), p=0.01 (PERF.md): 16-lane
# tiles with 8 warps beat 8/32/64-lane tiles and 2/4/16 warps
DEFAULT_BATCH_TILE = 16
DEFAULT_NUM_WARPS = 8
_CHECK_ROWS = 16  # checks per chunk of the check update
_VAR_ROWS = 16  # variables per chunk of the variable update


def kernel_supports(graph: TannerGraph, *, schedule: str, damping: float) -> str | None:
    """None when the kernel covers this graph and configuration, otherwise
    the reason it does not."""
    if schedule != "flooding":
        return "the GPU kernel implements the flooding schedule only"
    if damping != 1.0:
        return "the GPU kernel does not implement damping"
    if not graph.check_regular:
        return "the GPU kernel needs a check-regular graph"
    return None


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _bp_kernel(
    syn_ref,  # (mp, bt) int8
    pri_ref,  # (np_, bt) or (np_, 1) f32
    vof_ref,  # (dc, mp) int32: variable of each slot-major edge row
    vedge_ref,  # (dv, np_) int32: edge row of each variable's k-th edge
    val_ref,  # out (np_, bt) f32: posterior values (frozen at convergence)
    conv_ref,  # out (1, bt) int32
    iters_ref,  # out (1, bt) int32
    r_ref,  # out/scratch (dc * mp + 1, bt) f32: R rows + one zero row
    *,
    m: int,
    mp: int,
    np_: int,
    dc: int,
    dv: int,
    bt: int,
    cr: int,
    cv: int,
    max_iter: int,
    method: str,
    alpha: float,
    offset: float,
    clip_llr: float | None,
    barrier: bool,
):
    f32 = jnp.float32
    zero_row = dc * mp
    # phases exchange data between threads through the state buffers
    sync = plgpu.debug_barrier if barrier else (lambda: None)

    plgpu.store(r_ref.at[pl.ds(zero_row, 1), :], jnp.zeros((1, bt), f32))

    def init_values(j, carry):
        rows = pl.ds(j * cv, cv)
        pri = jnp.broadcast_to(pri_ref[rows, :], (cv, bt))
        plgpu.store(val_ref.at[rows, :], pri)
        return carry

    jax.lax.fori_loop(0, np_ // cv, init_values, 0)
    sync()

    def check_rule(q, ss):
        """Leave-one-out check update over dc (cr, bt) slot planes."""
        if method == "sum-product":
            t = [jnp.tanh(qi * 0.5) for qi in q]
            left = [None] * dc
            right = [None] * dc
            for i in range(1, dc):
                left[i] = t[0] if i == 1 else left[i - 1] * t[i - 1]
            for i in range(dc - 2, -1, -1):
                right[i] = t[dc - 1] if i == dc - 2 else right[i + 1] * t[i + 1]
            r = []
            for i in range(dc):
                if left[i] is None:
                    others = right[i]
                elif right[i] is None:
                    others = left[i]
                else:
                    others = left[i] * right[i]
                clipped = jnp.clip(others * ss, -_TANH_CLIP, _TANH_CLIP)
                r.append(2.0 * jnp.arctanh(clipped))
        else:  # min-sum
            sg = [jnp.where(qi >= 0, f32(1.0), f32(-1.0)) for qi in q]
            total = sg[0]
            for i in range(1, dc):
                total = total * sg[i]
            aq = [jnp.abs(qi) for qi in q]
            min1 = aq[0]
            amin = jnp.zeros(aq[0].shape, jnp.int32)
            for i in range(1, dc):
                better = aq[i] < min1
                min1 = jnp.where(better, aq[i], min1)
                amin = jnp.where(better, i, amin)
            min2 = None
            for i in range(dc):
                masked = jnp.where(amin == i, f32(jnp.inf), aq[i])
                min2 = masked if min2 is None else jnp.minimum(min2, masked)
            r = []
            for i in range(dc):
                mags = jnp.where(aq[i] == min1, min2, min1)
                if offset:
                    mags = jnp.maximum(mags - offset, 0.0)
                r.append(ss * (total * sg[i]) * mags)
        if alpha != 1.0:
            r = [ri * f32(alpha) for ri in r]
        return r

    def check_phase(first: bool):
        """Syndrome check of the stored values (unless ``first``) fused
        with the check update that reads the same values gather."""

        def chunk(j, ok):
            c0 = j * cr
            syn = syn_ref[pl.ds(c0, cr), :].astype(jnp.int32)
            ss = (1 - 2 * syn).astype(f32)
            ve = [val_ref[vof_ref[i, pl.ds(c0, cr)], :] for i in range(dc)]
            if not first:
                par = (ve[0] < 0).astype(jnp.int32)
                for i in range(1, dc):
                    par = par + (ve[i] < 0).astype(jnp.int32)
                rows = c0 + jax.lax.broadcasted_iota(jnp.int32, (cr, bt), 0)
                row_ok = ((par % 2) == syn) | (rows >= m)
                ok = jnp.minimum(ok, jnp.min(row_ok.astype(jnp.int32), axis=0))
                q = [
                    ve[i] - r_ref[pl.ds(i * mp + c0, cr), :] for i in range(dc)
                ]
                if clip_llr is not None:
                    q = [jnp.clip(qi, -clip_llr, clip_llr) for qi in q]
            else:
                q = ve
            r = check_rule(q, ss)
            for i in range(dc):
                plgpu.store(r_ref.at[pl.ds(i * mp + c0, cr), :], r[i])
            return ok

        return jax.lax.fori_loop(
            0, mp // cr, chunk, jnp.ones((bt,), jnp.int32)
        )

    def var_phase(conv):
        frozen = (conv > 0)[None, :]

        def chunk(j, carry):
            rows = pl.ds(j * cv, cv)
            acc = r_ref[vedge_ref[0, rows], :]
            for k in range(1, dv):
                acc = acc + r_ref[vedge_ref[k, rows], :]
            new = acc + pri_ref[rows, :]
            old = val_ref[rows, :]
            plgpu.store(val_ref.at[rows, :], jnp.where(frozen, old, new))
            return carry

        jax.lax.fori_loop(0, np_ // cv, chunk, 0)

    check_phase(first=True)
    sync()

    def cond(c):
        t, conv, _ = c
        return (t < max_iter) & (jnp.min(conv) == 0)

    def body(c):
        t, conv, iters = c
        var_phase(conv)
        sync()
        ok = check_phase(first=False)
        sync()
        newly = (ok > 0) & (conv == 0)
        return (
            t + 1,
            jnp.where(newly, 1, conv),
            jnp.where(newly, t, iters),
        )

    _, conv, iters = jax.lax.while_loop(
        cond,
        body,
        (
            jnp.int32(0),
            jnp.zeros((bt,), jnp.int32),
            jnp.full((bt,), max(max_iter - 1, 0), jnp.int32),
        ),
    )
    plgpu.store(conv_ref.at[0, :], conv)
    plgpu.store(iters_ref.at[0, :], iters)


class TritonBPKernel:
    """Compiled fused-BP callable for one check-regular Tanner graph.

    ``__call__(syndromes (B, m) int, priors (n,) or (B, n) f32)`` returns
    ``(values (B, n) f32, converged (B,) bool, iterations (B,) int32)``.
    ``interpret=True`` runs the kernel through the Pallas interpreter, for
    tests on a machine without a GPU.
    """

    def __init__(
        self,
        graph: TannerGraph,
        *,
        max_iter: int,
        method: str = "sum-product",
        alpha: float = 1.0,
        offset: float = 0.0,
        clip_llr: float | None = None,
        batch_tile: int = 0,
        interpret: bool = False,
        num_warps: int = DEFAULT_NUM_WARPS,
    ):
        reason = kernel_supports(graph, schedule="flooding", damping=1.0)
        if reason:
            raise ValueError(reason)
        bt = batch_tile or DEFAULT_BATCH_TILE
        if bt <= 0 or bt & (bt - 1):
            raise ValueError(f"batch_tile={bt} must be a power of two")
        self.graph = graph
        self.batch_tile = bt
        self.max_iter = max_iter
        m, n, dc, dv = graph.m, graph.n, graph.dc_max, graph.dv_max
        mp = _round_up(m, _CHECK_ROWS)
        np_ = _round_up(n, _VAR_ROWS)
        self._m, self._n, self._mp, self._np = m, n, mp, np_

        # slot-major edge rows: row i * mp + c holds slot i of check c
        vof = np.zeros((dc, mp), np.int32)
        vof[:, :m] = graph.var_of_edge[graph.check_edge].T
        row_of_edge = np.empty(graph.num_edges, np.int64)
        slots = np.arange(dc)[None, :]
        row_of_edge[graph.check_edge] = slots * mp + np.arange(m)[:, None]
        zero_row = dc * mp
        vedge = np.full((dv, np_), zero_row, np.int32)
        real = graph.var_edge < graph.num_edges
        rows = np.where(
            real, row_of_edge[np.minimum(graph.var_edge, graph.num_edges - 1)],
            zero_row,
        )
        vedge[:, :n] = rows.T
        self._vof, self._vedge = vof, vedge
        self._interpret = interpret
        self._kernel = functools.partial(
            _bp_kernel,
            m=m, mp=mp, np_=np_, dc=dc, dv=dv, bt=bt,
            cr=_CHECK_ROWS, cv=_VAR_ROWS, max_iter=max_iter, method=method,
            alpha=alpha, offset=offset, clip_llr=clip_llr,
            barrier=not interpret,
        )
        self._num_warps = num_warps

    def _call(self, n_tiles: int, shared_prior: bool):
        mp, np_, bt = self._mp, self._np, self.batch_tile
        dc, dv = self._vof.shape[0], self._vedge.shape[0]
        tile = lambda rows: pl.BlockSpec((rows, bt), lambda i: (0, i))
        full = lambda *shape: pl.BlockSpec(shape, lambda i: (0, 0))
        Bp = n_tiles * bt
        return pl.pallas_call(
            self._kernel,
            grid=(n_tiles,),
            in_specs=[
                tile(mp),
                full(np_, 1) if shared_prior else tile(np_),
                full(dc, mp),
                full(dv, np_),
            ],
            out_specs=[tile(np_), tile(1), tile(1), tile(dc * mp + 1)],
            out_shape=[
                jax.ShapeDtypeStruct((np_, Bp), jnp.float32),
                jax.ShapeDtypeStruct((1, Bp), jnp.int32),
                jax.ShapeDtypeStruct((1, Bp), jnp.int32),
                jax.ShapeDtypeStruct((dc * mp + 1, Bp), jnp.float32),
            ],
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=self._num_warps),
            interpret=self._interpret,
            name="bp_flooding",
        )

    def __call__(self, syndromes: jax.Array, priors: jax.Array):
        B = syndromes.shape[0]
        bt = self.batch_tile
        pad = (-B) % bt
        n_tiles = (B + pad) // bt
        m, n, mp, np_ = self._m, self._n, self._mp, self._np
        # padding lanes decode the zero syndrome (they converge at once);
        # padding checks carry syndrome 0 and are excluded from the check
        syn_t = jnp.pad(
            syndromes.astype(jnp.int8), ((0, pad), (0, mp - m))
        ).T
        priors = jnp.asarray(priors, jnp.float32)
        shared = priors.ndim == 1
        if shared:
            pri_t = jnp.pad(priors, (0, np_ - n), constant_values=1.0)[:, None]
        else:
            pri_t = jnp.pad(
                jnp.broadcast_to(priors, (B, n)), ((0, pad), (0, np_ - n)),
                constant_values=1.0,
            ).T
        values_t, conv_t, iters_t, _ = self._call(n_tiles, shared)(
            syn_t, pri_t, jnp.asarray(self._vof), jnp.asarray(self._vedge)
        )
        return values_t[:n, :B].T, conv_t[0, :B] > 0, iters_t[0, :B]
