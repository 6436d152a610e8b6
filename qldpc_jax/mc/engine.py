"""Sharded Monte-Carlo logical-error-rate engine.

This is the accelerator re-design of the reference's canonical trial loop
(studies/study.py:50-87: sample error -> syndrome -> BP -> OSD fallback ->
classify -> count; also rework/main.py:75-112 with richer metrics). The
entire loop body — channel sampling, BP, OSD, classification, counting —
is one jitted, natively batched device program, sharded over a 1-D device
mesh with ``shard_map``:

  * the sample batch axis is split across devices;
  * each shard draws its slice of one GLOBAL counter-mode RNG stream
    (utils/rng.py), so counters are bit-identical across mesh shapes;
  * outcome counters are ``psum``-reduced on-device, so one scalar bundle
    returns per batch regardless of mesh size;
  * exact trial counts are kept with a validity mask (no ragged batches);
  * partial results checkpoint after every batch and resume transparently
    (the reference loses an entire sweep on interruption — SURVEY.md §5.4).

Decoding basis: ``Hx`` detects the sampled (Z-type) errors and ``Lx``
classifies logical residuals, exactly like the reference drivers
(studies/study.py:32-34); pass ``basis="z"`` for the transpose experiment.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from qldpc_jax.codes.css import CSSCode
from qldpc_jax.decoders.bp import BPConfig, BPDecoder
from qldpc_jax.decoders.osd import OSDConfig, OSDDecoder
from qldpc_jax.mc.metrics import HIST_BINS, Counters, counters_to_dict, zeros_counters
from qldpc_jax.noise import spacetime as st
from qldpc_jax.parallel.mesh import BATCH_AXIS, RATE_AXIS, make_mesh

__all__ = ["EngineConfig", "MonteCarloEngine", "SweepResult"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    bp: BPConfig = BPConfig()
    osd: OSDConfig | None = OSDConfig()  # None = BP-only (fault => logical error)
    channel: str = "code-capacity"  # | "doubled" | "phenomenological" | "space-time"
    basis: str = "x"
    n_rounds: int = 0  # space-time rounds; 0 => code.distance
    syndrome_flip_rate: float | None = None  # phenomenological q (None => p)
    batch_size: int = 4096  # global batch across the mesh
    osd_fraction: float = 1.0  # per-batch OSD capacity as a fraction of the
    # local batch; non-converged samples beyond it keep the BP output and are
    # tallied in the osd_overflow counter (1.0 == exact reference behavior)
    osd_tiers: tuple = (128, 1024)  # compacted-OSD capacity tiers: per batch
    # the smallest tier >= the failure count runs (lax.cond), so clean
    # batches skip OSD entirely and low-p batches pay a 128-lane elimination
    # instead of the full-batch one. Results are identical to full OSD as
    # long as failures fit the selected tier (OSD runs on exactly the
    # non-converged samples either way, like studies/study.py:62-68).
    osd_chunk: int = 8192  # cap on the lanes of a single OSD program: tiers
    # above this run as fori_loop chunks of this size. Every lax.cond branch
    # is compiled even when runtime-skipped, so without the cap the top
    # (full-batch) tier would materialize OSD intermediates for the whole
    # batch at compile time — 21 GB at a 262k batch. 0 disables chunking.
    fused_dispatch: bool = True  # True: all batches of a rate in one
    # dispatched program (fewest host round trips; robust on high-latency
    # links); False: async pipelined per-batch dispatches
    rescue_iters: int = 0  # >0: two-phase decoding — BP(rescue_iters) on the
    # whole batch, then the full BP(bp.max_iter) only on compacted failures
    # (lax.cond tier ladder like OSD). BIT-EXACT with single-phase: BP is
    # deterministic from (syndrome, priors), samples converged within the
    # short phase are frozen at the same state a long run would freeze them,
    # and the top tier spans the whole local batch so no failure is ever
    # left at short-phase quality. Pays off at mid p where one straggler
    # lane keeps a whole Pallas tile iterating.
    rescue_tiers: tuple = (256, 2048)


@dataclasses.dataclass
class SweepResult:
    code_name: str
    error_rates: list[float]
    per_rate: list[dict]  # counters_to_dict output per error rate
    wall_time_s: float = 0.0
    throughput: float = 0.0  # decoded syndromes / s (aggregate)

    def curve(self, key: str) -> np.ndarray:
        return np.array([r[key] for r in self.per_rate])


class MonteCarloEngine:
    """Batched, sharded LER estimation for one code + decoder configuration."""

    def __init__(self, code: CSSCode, config: EngineConfig = EngineConfig(), mesh=None):
        self.code = code
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh()
        # batch parallelism spans the BATCH_AXIS only; a 2-D (rate, mc)
        # mesh additionally shards the error-rate grid (run_rates_sharded)
        self.n_devices = dict(self.mesh.shape)[BATCH_AXIS]
        if config.batch_size % self.n_devices:
            raise ValueError("batch_size must divide evenly across the mesh")
        self.local_batch = config.batch_size // self.n_devices

        H = code.Hx if config.basis == "x" else code.Hz
        L = code.Lx if config.basis == "x" else code.Lz
        self.n_qubits = H.shape[1]
        self.distance = code.distance

        if config.channel == "space-time":
            self.n_rounds = config.n_rounds or max(code.distance, 1)
            self._H_dec = st.space_time_matrix(H, self.n_rounds)
            self._H_space = H
        else:
            self.n_rounds = 0
            self._H_dec = H
            self._H_space = H
        self.n_vars = self._H_dec.shape[1]
        self.m_checks = self._H_dec.shape[0]

        self._bp = self._make_bp_decoder(H)
        self._bp_short = None
        if 0 < config.rescue_iters < config.bp.max_iter:
            self._bp_short = self._make_bp_decoder(
                H, dataclasses.replace(config.bp, max_iter=config.rescue_iters)
            )
        self._osd = (
            OSDDecoder(self._H_dec, config.osd) if config.osd is not None else None
        )
        self._Hf = jnp.asarray(self._H_dec, jnp.float32)
        self._Lf = jnp.asarray(L, jnp.float32)
        # traced per-rate alpha (Alvarado sweeps reuse one compiled program);
        # the pallas kernels bake alpha statically, so they keep the static
        # path and fitted-alpha sweeps on pallas rebuild per rate instead
        self._alpha_traceable = config.bp.backend != "pallas"
        self._stride = self._draws_per_sample()
        self._check_counter_space(self._stride)
        self._batch_fn = self._build()

    def _check_counter_space(self, stride: int) -> None:
        """Guard the uint32 counter space of utils/rng.py::counter_uniform:
        one batch consumes ``batch_size * ceil(stride/2)`` counter pairs;
        overflowing 2^32 would silently wrap and reuse draw streams across
        samples (correlated trials with no error raised)."""
        if self.config.batch_size * ((stride + 1) // 2) >= 2**32:
            raise ValueError(
                f"batch_size x {(stride + 1) // 2} counter pairs per "
                "sample exceeds the 2^32 counter space of one batch; use a "
                "smaller batch_size"
            )

    def _draws_per_sample(self) -> int:
        """Uniform draws consumed per sample (the counter-mode RNG stride)."""
        if self.config.channel == "phenomenological":
            return self.n_vars + self.m_checks  # errors + syndrome flips
        return self.n_vars  # space-time's n*T + m*T variables ARE its draws

    def _make_bp_decoder(self, H_base, bp_cfg: BPConfig | None = None):
        """Space-time sweeps use the structured decoder (no materialized
        kron; base-code tables only — decoders/spacetime_bp.py) whenever the
        configuration allows; everything else (and unsupported configs)
        decodes the materialized matrix."""
        bp_cfg = bp_cfg if bp_cfg is not None else self.config.bp
        if self.config.channel == "space-time":
            try:
                from qldpc_jax.decoders.spacetime_bp import SpaceTimeBPDecoder

                return SpaceTimeBPDecoder(H_base, self.n_rounds, bp_cfg)
            except NotImplementedError:
                pass
        return BPDecoder(self._H_dec, bp_cfg)

    # ------------------------------------------------------------------ build
    def _sample(self, key, base, p):
        """Channel sampling; returns (errors, syndromes, priors).

        Channel math lives in noise/channels.py (the single source of
        truth); draws come from *global* counter-mode RNG (utils/rng.py):
        sample i's uniforms are a pure function of its global id, so the
        stream — and every counter — is independent of the mesh shape and
        dispatch mode
        (tests/test_engine.py::test_mesh_sharding_matches_single_device).
        ``base`` is this shard's first global SAMPLE id (traced)."""
        from qldpc_jax.noise import channels as ch

        cfg = self.config
        n = self.n_vars
        B = self.local_batch
        if cfg.channel == "code-capacity":
            errors = ch.code_capacity(key, base, p, B, n)
            syn = self._syndrome(errors)
            priors = ch.uniform_prior_llr(n, p)
        elif cfg.channel == "doubled":
            errors = ch.doubled_channel(key, base, p, B, n)
            syn = self._syndrome(errors)
            # the reference decodes the doubled channel with the plain
            # log((1-p)/p) prior (paperResults.py:66-77)
            priors = ch.uniform_prior_llr(n, p)
        elif cfg.channel == "phenomenological":
            q = p if cfg.syndrome_flip_rate is None else cfg.syndrome_flip_rate
            errors, flips = ch.phenomenological(
                key, base, p, B, n, self.m_checks, q=q
            )
            syn = (self._syndrome(errors) + flips) % 2
            priors = ch.uniform_prior_llr(n, p)
        elif cfg.channel == "space-time":
            q = p if cfg.syndrome_flip_rate is None else cfg.syndrome_flip_rate
            errors, syn = st.sample_space_time_counters(
                key, base, self._H_space, p, B, self.n_rounds, q=q
            )
            priors = st.space_time_prior_llr(
                self.n_qubits, self._H_space.shape[0], self.n_rounds, p, q=q
            )
        else:
            raise ValueError(f"unknown channel {self.config.channel!r}")
        return errors, syn, priors

    def _decode_with_rescue(self, syn, priors, alpha=None):
        """Two-phase decode (config.rescue_iters): BP(short) on everything,
        then the full BP(max_iter) on compacted failures only (smallest
        fitting tier via a lax.cond ladder; the top tier spans the whole
        batch, so results are bit-exact with a single long run — BP is
        deterministic from (syndrome, priors))."""
        if self._bp_short is None:
            return self._bp.decode_fn(syn, priors, alpha)
        from qldpc_jax.decoders.bp import BPResult

        r1 = self._bp_short.decode_fn(syn, priors, alpha)
        conv1 = r1.converged
        n_fail = jnp.sum((~conv1).astype(jnp.int32))
        B = syn.shape[0]

        def rescue_at(k: int) -> BPResult:
            sel = jnp.argsort(conv1, stable=True)[:k]
            r2 = self._bp.decode_fn(syn[sel], priors, alpha)
            keep = conv1[sel]
            return BPResult(
                hard=r1.hard.at[sel].set(
                    jnp.where(keep[:, None], r1.hard[sel], r2.hard)
                ),
                converged=conv1.at[sel].set(keep | r2.converged),
                llrs=r1.llrs.at[sel].set(
                    jnp.where(keep[:, None], r1.llrs[sel], r2.llrs)
                ),
                iterations=r1.iterations.at[sel].set(
                    jnp.where(keep, r1.iterations[sel], r2.iterations)
                ),
            )

        tiers = sorted({int(k) for k in self.config.rescue_tiers if 0 < k < B})
        run = lambda: rescue_at(B)
        for k in reversed(tiers):
            run = lambda k=k, nxt=run: jax.lax.cond(
                n_fail <= k, lambda: rescue_at(k), nxt
            )
        return jax.lax.cond(n_fail == 0, lambda: r1, run)

    def _syndrome(self, errors):
        from qldpc_jax.noise.channels import syndrome_of

        return syndrome_of(self._Hf, errors)

    def _classify(self, errors, final, syn, bp_res, valid) -> Counters:
        """Outcome taxonomy of studies/study.py:73-87 + rework/main.py:164-190."""
        cfg = self.config
        conv = bp_res.converged
        residual = (errors.astype(jnp.int32) + final.astype(jnp.int32)) % 2
        if cfg.channel == "space-time":
            folded = st.fold_data_correction(residual, self.n_qubits, self.n_rounds)
            logical_vec = jnp.mod(folded.astype(jnp.float32) @ self._Lf.T, 2.0)
            err_weight = st.fold_data_correction(
                errors, self.n_qubits, self.n_rounds
            ).sum(-1)
            res_weight = folded.sum(-1)
        else:
            logical_vec = jnp.mod(residual.astype(jnp.float32) @ self._Lf.T, 2.0)
            err_weight = errors.astype(jnp.int32).sum(-1)
            res_weight = residual.sum(-1)

        vec_logical = jnp.any(logical_vec != 0, axis=-1)
        logical = vec_logical
        if self._osd is None:
            # BP-only runs count a non-converged decode as a fault == logical
            # error (the CC-50k archives' semantics, SURVEY.md §6 table 2)
            logical = logical | ~conv
        mismatch = jnp.any(final.astype(jnp.int32) != errors.astype(jnp.int32), axis=-1)

        s_hat = self._syndrome(final)
        sol_valid = jnp.all(s_hat == syn.astype(jnp.int8), axis=-1)

        # strict weight < d/2 as in studies/study.py:83 — kept in integer
        # arithmetic (2w < d) so odd distances (Steane d=3: weight-1 errors
        # are miscorrections) match the reference exactly
        low_weight = (2 * err_weight) < self.distance
        degenerate = ~logical & mismatch
        osd_used = ~conv if self._osd is not None else jnp.zeros_like(conv)

        v = valid
        cnt = lambda mask: jnp.sum((mask & v).astype(jnp.int32))
        w = jnp.clip(res_weight, 0, HIST_BINS - 1)
        hist = lambda mask: jnp.zeros((HIST_BINS,), jnp.int32).at[w].add(
            (mask & v).astype(jnp.int32)
        )

        return Counters(
            trials=jnp.sum(v.astype(jnp.int32)),
            logical_errors=cnt(logical),
            residual_logicals=cnt(vec_logical),
            bp_converged=cnt(conv),
            bp_faults=cnt(~conv),
            osd_invocations=cnt(osd_used),
            miscorrected=cnt(logical & low_weight),
            incorrectable=cnt(logical & ~low_weight),
            degeneracies=cnt(degenerate),
            valid_degenerate=cnt(degenerate & sol_valid),
            osd_and_logical=cnt(logical & ~conv),
            osd_overflow=jnp.zeros((), jnp.int32),
            sum_iterations=jnp.sum(
                jnp.where(v, bp_res.iterations, 0).astype(jnp.int32)
            ),
            hist_bp=hist(degenerate & conv),
            hist_osd=hist(degenerate & ~conv),
            hist_bp_error=hist(logical & conv),
            hist_osd_error=hist(logical & ~conv),
        )

    def _build(self):
        local_B = self.local_batch

        k_osd = max(1, int(round(local_B * self.config.osd_fraction)))

        def local_step(key, p, n_valid, base0, alpha):
            idx = jax.lax.axis_index(BATCH_AXIS)
            # counter-mode RNG over GLOBAL sample ids (not shard ids): the
            # stream — and therefore every counter — is mesh-shape-invariant.
            # base0 is a traced zero: a constant-folded iota counter sends
            # the XLA threefry lowering down a ~1000x slower path (see
            # utils/rng.py), so the offset must stay traced even on shard 0.
            sample_ids = idx * local_B + jnp.arange(local_B)
            base = base0 + jnp.uint32(idx) * jnp.uint32(local_B)
            errors, syn, priors = self._sample(key, base, p)
            bp_res = self._decode_with_rescue(
                syn, priors, alpha if self._alpha_traceable else None
            )
            overflow = jnp.zeros((), jnp.int32)
            if self._osd is not None:
                conv = bp_res.converged
                n_fail = jnp.sum((~conv).astype(jnp.int32))

                def osd_at(k: int):
                    # compaction: stable-sort non-converged samples to the
                    # front, post-process the first k slots, scatter back
                    sel = jnp.argsort(conv, stable=True)[:k]
                    syn_s = syn[sel]
                    llr_s = bp_res.llrs[sel]
                    hard_s = bp_res.hard[sel]
                    chunk = self.config.osd_chunk
                    if chunk and k > chunk:
                        # bounded-memory top tier: one chunk-sized OSD
                        # program swept over the compacted slots (padded
                        # lanes decode the zero syndrome; discarded below)
                        n_ch = -(-k // chunk)
                        pad = n_ch * chunk - k
                        if pad:
                            syn_s = jnp.pad(syn_s, ((0, pad), (0, 0)))
                            llr_s = jnp.pad(
                                llr_s, ((0, pad), (0, 0)), constant_values=1.0
                            )
                            hard_s = jnp.pad(hard_s, ((0, pad), (0, 0)))

                        def body(i, acc):
                            dsl = lambda x: jax.lax.dynamic_slice_in_dim(
                                x, i * chunk, chunk, 0
                            )
                            sol_i = self._osd._decode(
                                dsl(syn_s), dsl(llr_s), dsl(hard_s)
                            )
                            return jax.lax.dynamic_update_slice_in_dim(
                                acc, sol_i, i * chunk, 0
                            )

                        osd_sol = jax.lax.fori_loop(
                            0, n_ch, body, jnp.zeros_like(hard_s)
                        )[:k]
                    else:
                        osd_sol = self._osd._decode(syn_s, llr_s, hard_s)
                    picked = jnp.where(
                        conv[sel][:, None], bp_res.hard[sel], osd_sol
                    )
                    return bp_res.hard.at[sel].set(picked)

                tiers = sorted(
                    {int(k) for k in self.config.osd_tiers if 0 < k < k_osd}
                )
                run = lambda k=k_osd: osd_at(k_osd)
                for k in reversed(tiers):
                    run = (
                        lambda k=k, nxt=run: jax.lax.cond(
                            n_fail <= k, lambda: osd_at(k), nxt
                        )
                    )
                final = jax.lax.cond(n_fail == 0, lambda: bp_res.hard, run)
                overflow = jnp.maximum(n_fail - k_osd, 0)
            else:
                final = bp_res.hard
            valid = sample_ids < n_valid
            counters = self._classify(errors, final, syn, bp_res, valid)
            counters = counters._replace(osd_overflow=overflow)
            # pin int32: jnp.sum promotes int32->int64 under x64, which would
            # break the fused fori_loop carry
            counters = jax.tree.map(lambda x: x.astype(jnp.int32), counters)
            return jax.tree.map(partial(jax.lax.psum, axis_name=BATCH_AXIS), counters)

        self._local_step = local_step

        sharded = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(P(), P(), P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )

        self._multi_cache = {}
        self._rates_cache = {}
        return jax.jit(sharded)

    def _batch_fn_multi_offset(self, n_batches: int):
        """Fused variant: ``n_batches`` batches inside a single dispatched
        program (fori_loop with one psum'd counter bundle out) — removes
        per-batch host->device round trips, which dominate on high-latency
        links. ``offset`` shifts the global batch index for RNG and validity
        so large sweeps can be split across several dispatches."""
        fn = self._multi_cache.get(n_batches)
        if fn is not None:
            return fn
        B = self.config.batch_size

        def local_multi(key, p, trials, offset, base0, alpha):
            def body(i, tot):
                b = offset + i
                kb = jax.random.fold_in(key, b)
                n_valid = jnp.clip(trials - b * B, 0, B)
                return tot + self._local_step(kb, p, n_valid, base0, alpha)

            return jax.lax.fori_loop(0, n_batches, body, zeros_counters())

        fn = jax.jit(
            jax.shard_map(
                local_multi,
                mesh=self.mesh,
                in_specs=(P(), P(), P(), P(), P(), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        self._multi_cache[n_batches] = fn
        return fn

    # -------------------------------------------------------------------- run
    def run_rate(
        self, p: float, trials: int, seed: int = 0, start_batch: int = 0,
        init: Counters | None = None, on_batch=None, alpha: float | None = None,
    ) -> Counters:
        """Accumulate `trials` samples at one error rate.

        ``alpha`` overrides the decoder's normalization for this rate as a
        TRACED scalar (xla backends only) — fitted-alpha sweeps reuse one
        compiled program instead of recompiling per grid point."""
        if alpha is not None and not self._alpha_traceable:
            raise ValueError(
                "per-rate alpha override needs an xla BP backend (the pallas "
                "kernels bake alpha statically — rebuild the engine instead)"
            )
        if trials >= 2**31:
            # device-side validity arithmetic is int32 (fori carries)
            raise ValueError(
                f"trials={trials} exceeds int32; split the campaign into "
                "multiple run_rate calls and sum the host-side counters"
            )
        B = self.config.batch_size
        n_batches = -(-trials // B)
        key = jax.random.key(seed)
        a32 = jnp.float32(self.config.bp.alpha if alpha is None else alpha)
        to_host = lambda c: jax.tree.map(
            lambda x: np.asarray(x, dtype=np.int64), c
        )
        if on_batch is None and start_batch == 0 and init is None:
            kp = jax.random.fold_in(key, hash(p) % (2**31))
            if self.config.fused_dispatch:
                # all batches inside one (or a few) dispatched programs;
                # device counters are int32, so cap per-dispatch trials and
                # accumulate on the host in int64 (sum_iterations would
                # overflow int32 past ~1e7 trials)
                max_fused = max(
                    1, (2**30) // (B * max(self.config.bp.max_iter, 1))
                )
                total = to_host(zeros_counters())
                b = 0
                while b < n_batches:
                    nb = min(max_fused, n_batches - b)
                    chunk = self._batch_fn_multi_offset(nb)(
                        kp, jnp.float32(p), jnp.int32(trials), jnp.int32(b),
                        jnp.uint32(0), a32,
                    )
                    total = total + to_host(chunk)
                    b += nb
                return total
            # async pipelined per-batch dispatches: queue everything, block
            # once, then sum on the host in int64 (per-batch int32 counters
            # cannot overflow within one batch)
            outs = []
            for b in range(n_batches):
                n_valid = min(B, trials - b * B)
                kb = jax.random.fold_in(kp, b)
                outs.append(
                    self._batch_fn(
                        kb, jnp.float32(p), jnp.int32(n_valid), jnp.uint32(0),
                        a32,
                    )
                )
            jax.block_until_ready(outs)
            total = to_host(zeros_counters())
            for c in outs:
                total = total + to_host(c)
            return total
        total = (
            to_host(init) if init is not None else to_host(zeros_counters())
        )
        for b in range(start_batch, n_batches):
            done = b * B
            n_valid = min(B, trials - done)
            kb = jax.random.fold_in(jax.random.fold_in(key, hash(p) % (2**31)), b)
            counters = self._batch_fn(
                kb, jnp.float32(p), jnp.int32(n_valid), jnp.uint32(0), a32
            )
            total = total + to_host(counters)
            if on_batch is not None:
                on_batch(b, n_batches, total)
        return total

    def _rates_fn(self, n_batches: int):
        """Rate-axis-sharded fused sweep program: each RATE_AXIS shard scans
        its slice of the rate grid, running ``n_batches`` batch-sharded
        batches per rate (psum over BATCH_AXIS only). RNG is keyed by the
        *global* rate index + the same per-rate hash fold as ``run_rate``,
        so counters are bit-identical to per-rate ``run_rate`` calls on any
        mesh shape."""
        fn = self._rates_cache.get(n_batches)
        if fn is not None:
            return fn
        B = self.config.batch_size

        def local_rates(rates_l, hash_l, gidx_l, trials, offset, seed, base0, alpha):
            def per_rate(carry, xs):
                p, h, gi = xs
                key = jax.random.key(seed + gi.astype(jnp.int32))
                kp = jax.random.fold_in(key, h)

                def body(i, tot):
                    b = offset + i
                    kb = jax.random.fold_in(kp, b)
                    n_valid = jnp.clip(trials - b * B, 0, B)
                    return tot + self._local_step(kb, p, n_valid, base0, alpha)

                return carry, jax.lax.fori_loop(0, n_batches, body, zeros_counters())

            _, out = jax.lax.scan(per_rate, 0, (rates_l, hash_l, gidx_l))
            return out

        fn = jax.jit(
            jax.shard_map(
                local_rates,
                mesh=self.mesh,
                in_specs=(
                    P(RATE_AXIS), P(RATE_AXIS), P(RATE_AXIS),
                    P(), P(), P(), P(), P(),
                ),
                out_specs=P(RATE_AXIS),
                check_vma=False,
            )
        )
        self._rates_cache[n_batches] = fn
        return fn

    def run_rates_sharded(
        self, error_rates, trials: int, seed: int = 0,
        alpha: float | None = None,
    ) -> list[Counters]:
        """Sweep a whole rate grid with the grid sharded over the mesh's
        RATE_AXIS (build the engine with ``make_mesh(rate_shards=r)``).

        Counters are bit-identical to ``[run_rate(p_i, trials, seed+i) for
        i, p_i in enumerate(error_rates)]`` — the RNG stream depends only on
        (seed + rate index, hash(p), global sample id), never on the mesh.
        On a 1-D mesh this falls back to exactly that sequential loop."""
        shape = dict(self.mesh.shape)
        if RATE_AXIS not in shape:
            return [
                self.run_rate(float(p), trials, seed=seed + i, alpha=alpha)
                for i, p in enumerate(error_rates)
            ]
        if alpha is not None and not self._alpha_traceable:
            raise ValueError("per-rate alpha override needs an xla BP backend")
        if trials >= 2**31:
            raise ValueError(f"trials={trials} exceeds int32")
        n_rs = shape[RATE_AXIS]
        R = len(error_rates)
        pad = (-R) % n_rs
        rate_list = [float(p) for p in error_rates] + [
            float(error_rates[-1])
        ] * pad
        rates = np.asarray(rate_list, np.float32)
        # hash the PYTHON floats (as run_rate does), not their f32 casts
        hashes = np.asarray(
            [hash(p) % (2**31) for p in rate_list], np.uint32
        )
        gidx = np.arange(rates.size, dtype=np.int32)
        B = self.config.batch_size
        n_batches = -(-trials // B)
        max_fused = max(1, (2**30) // (B * max(self.config.bp.max_iter, 1)))
        a32 = jnp.float32(self.config.bp.alpha if alpha is None else alpha)
        to_host = lambda c: jax.tree.map(
            lambda x: np.asarray(x, dtype=np.int64), c
        )
        totals = to_host(
            jax.tree.map(
                lambda z: jnp.zeros((rates.size,) + z.shape, z.dtype),
                zeros_counters(),
            )
        )
        b = 0
        while b < n_batches:
            nb = min(max_fused, n_batches - b)
            chunk = self._rates_fn(nb)(
                jnp.asarray(rates), jnp.asarray(hashes), jnp.asarray(gidx),
                jnp.int32(trials), jnp.int32(b), jnp.int32(seed),
                jnp.uint32(0), a32,
            )
            totals = totals + to_host(chunk)
            b += nb
        # totals is a Counters tree stacked (R + pad, ...); unstack, drop pad
        return [jax.tree.map(lambda x: x[i], totals) for i in range(R)]

    def sweep(
        self,
        error_rates,
        trials: int,
        seed: int = 0,
        checkpoint=None,
        verbose: bool = False,
    ) -> SweepResult:
        """Full LER sweep over an error-rate grid (with optional resume).

        On a 2-D (rate, mc) mesh the grid is sharded over the rate axis
        (``run_rates_sharded``) unless checkpointing is requested — resume
        granularity is per (rate, batch), which the fused sharded program
        does not expose."""
        t0 = time.time()
        per_rate = []
        if checkpoint is None and RATE_AXIS in dict(self.mesh.shape):
            all_counters = self.run_rates_sharded(error_rates, trials, seed)
            for p, counters in zip(error_rates, all_counters):
                d = counters_to_dict(counters)
                per_rate.append(d)
                if verbose:
                    print(
                        f"{self.code.name} p={float(p):.5g}: "
                        f"ler={d['ler']:.5g} osd={d['osd']:.3g} "
                        f"iters={d['average_iterations']:.2f}"
                    )
        else:
            for i, p in enumerate(error_rates):
                if checkpoint is not None:
                    counters = checkpoint.run_rate(
                        self, float(p), trials, seed + i
                    )
                else:
                    counters = self.run_rate(float(p), trials, seed=seed + i)
                d = counters_to_dict(counters)
                per_rate.append(d)
                if verbose:
                    print(
                        f"{self.code.name} p={float(p):.5g}: "
                        f"ler={d['ler']:.5g} osd={d['osd']:.3g} "
                        f"iters={d['average_iterations']:.2f}"
                    )
        wall = time.time() - t0
        total_trials = sum(r["trials"] for r in per_rate)
        return SweepResult(
            code_name=self.code.name,
            error_rates=[float(p) for p in error_rates],
            per_rate=per_rate,
            wall_time_s=wall,
            throughput=total_trials / max(wall, 1e-9),
        )
