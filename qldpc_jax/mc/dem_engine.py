"""Circuit-level decoding engine over a detector error model.

Re-design of the reference's circuit-level pipeline
(studies/studyComplete.py:88-109): given a DEM bundle (H detectors x
mechanisms, L observables x mechanisms, per-mechanism priors), sample
mechanism firings *on device* (each mechanism is an independent Bernoulli of
its prior — the same distribution a stim detector sampler draws from),
decode the detector syndrome with BP(+OSD), and count a logical error when
the predicted observable flip ``L @ e_hat`` differs from the actual
``L @ e``.

``DEMEngine`` is ``MonteCarloEngine`` with the channel sampler swapped for
per-mechanism Bernoulli draws: it inherits the full machinery — shard_map
over the device mesh, mesh-invariant per-sample RNG, tiered compacted OSD
with the all-converged skip, fused/async dispatch, int64 host-side counter
accumulation, and mid-run checkpoint/resume.

Notes on the counter schema: the miscorrected/incorrectable split is a
weight-vs-code-distance classification (studies/study.py:83-87) that has no
analog in mechanism space, so every logical error lands in
``incorrectable`` (distance is pinned to 0).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from qldpc_jax.decoders.bp import BPDecoder
from qldpc_jax.decoders.osd import OSDDecoder
from qldpc_jax.mc.engine import EngineConfig, MonteCarloEngine
from qldpc_jax.mc.metrics import counters_to_dict
from qldpc_jax.noise.circuit import ParametricDEM
from qldpc_jax.noise.dem import DEMData
from qldpc_jax.parallel.mesh import make_mesh

__all__ = ["DEMEngine", "DEMEngineConfig"]


@dataclasses.dataclass(frozen=True)
class DEMEngineConfig(EngineConfig):
    channel: str = "dem"


@dataclasses.dataclass(frozen=True)
class _DEMCodeShim:
    """Minimal ``code`` stand-in (name only) for checkpoint paths and sweep
    result labeling; a DEM has no CSS structure to expose."""

    name: str


class DEMEngine(MonteCarloEngine):
    """Batched, sharded logical-error estimation for one detector error model."""

    def __init__(
        self,
        dem: DEMData | ParametricDEM,
        config: DEMEngineConfig = DEMEngineConfig(),
        mesh=None,
        name: str = "dem",
    ):
        if config.channel != "dem":
            config = dataclasses.replace(config, channel="dem")
        self.dem = dem
        self.code = _DEMCodeShim(name=name)
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_devices = self.mesh.devices.size
        if config.batch_size % self.n_devices:
            raise ValueError("batch_size must divide evenly across the mesh")
        self.local_batch = config.batch_size // self.n_devices

        # weight-vs-distance classification is undefined for DEM mechanisms
        self.distance = 0
        self.n_rounds = 0
        self.n_qubits = dem.H.shape[1]
        self._H_dec = dem.H
        self._H_space = dem.H
        self.n_vars = dem.H.shape[1]
        self.m_checks = dem.H.shape[0]

        self._bp = BPDecoder(dem.H, config.bp)
        self._bp_short = None
        if 0 < config.rescue_iters < config.bp.max_iter:
            self._bp_short = BPDecoder(
                dem.H, dataclasses.replace(config.bp, max_iter=config.rescue_iters)
            )
        self._osd = OSDDecoder(dem.H, config.osd) if config.osd is not None else None
        # no dense H device constant: DEM syndromes use gather-parity (a
        # [[144,12,12]] DEM H as f32 is 463 MB)
        from qldpc_jax.ops.tanner import parity_tables

        vos_p, dcp_p = parity_tables(dem.H)
        self._vos_parity = jnp.asarray(vos_p)
        self._dcp_parity = dcp_p
        self._Lf = jnp.asarray(dem.L, jnp.float32)
        self._alpha_traceable = config.bp.backend != "pallas"
        # DEMs have the largest RNG strides (one uniform per mechanism), so
        # the uint32 counter-space guard matters most here
        self._check_counter_space(self.n_vars)
        self._parametric = isinstance(dem, ParametricDEM)
        if self._parametric:
            self._ratios = jnp.asarray(dem.ratios, jnp.float32)
            self._counts = jnp.asarray(dem.counts, jnp.float32)
        else:
            self._priors_prob = jnp.asarray(dem.priors, jnp.float32)
            self._priors_llr = jnp.asarray(dem.llrs, jnp.float32)
        self._batch_fn = self._build()

    def _syndrome(self, errors):
        """Gather-parity detector syndrome (no dense H matmul constant)."""
        B = errors.shape[0]
        ep = jnp.pad(errors.astype(jnp.int32), ((0, 0), (0, 1)))
        es = ep[:, self._vos_parity].reshape(B, self.m_checks, self._dcp_parity)
        return (jnp.sum(es, axis=-1, dtype=jnp.int32) % 2).astype(jnp.int8)

    def _priors(self, p):
        """Mechanism priors and LLRs. Static for a DEMData; for a
        ParametricDEM they are the exact closed form
        q = (1 - prod_j (1-2 r_j p)^{c_j})/2 of the *traced* base rate p —
        the whole p-grid reuses one compiled program."""
        if not self._parametric:
            return self._priors_prob, self._priors_llr
        # full float32: a TF32 product would perturb the priors themselves
        log_q = jnp.dot(
            self._counts, jnp.log1p(-2.0 * self._ratios * p),
            precision=jax.lax.Precision.HIGHEST,
        )
        q = 0.5 * (1.0 - jnp.exp(log_q))
        qc = jnp.clip(q, 1e-15, 1.0 - 1e-15)  # studyComplete.py:88 clipping
        return q, jnp.log((1.0 - qc) / qc)

    def _sample(self, key, base, p):
        """Per-mechanism Bernoulli firings from global counter-mode draws
        (utils/rng.py; sample i's uniforms are a pure function of its global
        id). For a plain DEMData the traced scalar ``p`` is ignored — the
        DEM carries its own priors (studyComplete.py:85-89); for a
        ParametricDEM it is the physical depolarizing rate."""
        from qldpc_jax.utils.rng import counter_uniform

        B, M = self.local_batch, self.n_vars
        prob, llr = self._priors(p)
        u = counter_uniform(key, base, B, M)
        mech = (u < prob[None, :]).astype(jnp.int8)
        return mech, self._syndrome(mech), llr

    def run(self, shots: int, seed: int = 0, p: float = 0.0, checkpoint=None) -> dict:
        """Estimate the logical error rate over ``shots`` sampled shots.
        ``p`` is the physical rate for a ParametricDEM (ignored otherwise)."""
        if self._parametric and p <= 0.0:
            raise ValueError("a ParametricDEM needs a physical rate: run(..., p=...)")
        if checkpoint is not None:
            counters = checkpoint.run_rate(self, p, shots, seed)
        else:
            counters = self.run_rate(p, shots, seed=seed)
        return counters_to_dict(counters)
