import numpy as np

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig
from qldpc_jax.decoders.osd import OSDConfig
from qldpc_jax.mc import (
    DEMEngine,
    DEMEngineConfig,
    EngineConfig,
    MonteCarloEngine,
    counters_to_dict,
)
from qldpc_jax.noise import DEMData


def dicts_equal(a, b):
    return a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a
    )


def steane_dem(p):
    """A code-capacity channel expressed as a DEM: mechanisms are the 7
    single-qubit flips, detectors are the Steane checks, observable is Lx."""
    code = get_code("steane")
    return DEMData(H=code.Hx, L=code.Lx, priors=np.full(7, p))


class TestDEMEngine:
    def test_runs_and_counts(self):
        eng = DEMEngine(
            steane_dem(0.05),
            DEMEngineConfig(bp=BPConfig(max_iter=30), osd=OSDConfig(order=0),
                            batch_size=256),
        )
        d = eng.run(shots=512, seed=0)
        assert d["trials"] == 512
        assert 0 <= d["ler"] <= 1

    def test_matches_code_capacity_engine_statistically(self):
        """A DEM that encodes the code-capacity channel must reproduce the
        code-capacity engine's LER within sampling error."""
        p = 0.08
        shots = 4096
        dem_eng = DEMEngine(
            steane_dem(p),
            DEMEngineConfig(bp=BPConfig(max_iter=30), osd=OSDConfig(order=0),
                            batch_size=512),
        )
        d_dem = dem_eng.run(shots=shots, seed=1)

        cc_eng = MonteCarloEngine(
            get_code("steane"),
            EngineConfig(bp=BPConfig(max_iter=30), osd=OSDConfig(order=0),
                         batch_size=512),
        )
        d_cc = counters_to_dict(cc_eng.run_rate(p, trials=shots, seed=2))

        sigma = np.sqrt(max(d_cc["ler"] * (1 - d_cc["ler"]), 1e-9) / shots)
        assert abs(d_dem["ler"] - d_cc["ler"]) < 5 * sigma + 0.01

    def test_heterogeneous_priors(self):
        """Mechanism-dependent priors flow into both sampling and LLRs."""
        code = get_code("steane")
        priors = np.array([0.001, 0.001, 0.1, 0.001, 0.1, 0.001, 0.001])
        dem = DEMData(H=code.Hx, L=code.Lx, priors=priors)
        eng = DEMEngine(
            dem, DEMEngineConfig(bp=BPConfig(max_iter=30), batch_size=256)
        )
        d = eng.run(shots=512, seed=3)
        assert d["trials"] == 512

    def test_fused_matches_async_dispatch(self):
        """The inherited fused fori_loop dispatch and per-batch async
        dispatch draw identical RNG streams -> identical counters."""
        kw = dict(bp=BPConfig(max_iter=20), osd=OSDConfig(order=0), batch_size=128)
        d_f = DEMEngine(
            steane_dem(0.06), DEMEngineConfig(**kw, fused_dispatch=True)
        ).run(shots=384, seed=5)
        d_a = DEMEngine(
            steane_dem(0.06), DEMEngineConfig(**kw, fused_dispatch=False)
        ).run(shots=384, seed=5)
        assert dicts_equal(d_f, d_a)

    def test_mesh_invariant_counters(self):
        """Per-sample keys from global sample ids: counters are bit-identical
        on a 1-device and an 8-device mesh."""
        import jax

        from qldpc_jax.parallel import make_mesh

        kw = DEMEngineConfig(
            bp=BPConfig(max_iter=20), osd=OSDConfig(order=0), batch_size=128
        )
        dem = steane_dem(0.06)
        mesh1 = make_mesh(devices=np.array(jax.devices()[:1]))
        d1 = DEMEngine(dem, kw, mesh=mesh1).run(shots=256, seed=7)
        d8 = DEMEngine(dem, kw).run(shots=256, seed=7)
        assert dicts_equal(d1, d8)

    def test_checkpoint_resume(self, tmp_path):
        """Inherited checkpoint/resume: an interrupted run completes to the
        same counters as an uninterrupted one."""
        from qldpc_jax.mc import CheckpointManager

        kw = DEMEngineConfig(
            bp=BPConfig(max_iter=20), osd=OSDConfig(order=0), batch_size=128
        )
        dem = steane_dem(0.06)
        full = DEMEngine(dem, kw).run(shots=512, seed=9, checkpoint=None)

        ck = CheckpointManager(tmp_path)
        eng = DEMEngine(dem, kw)
        # simulate an interruption: run the first 2 of 4 batches, persist
        partial = eng.run_rate(
            0.0, 512, seed=9, start_batch=0,
            on_batch=lambda b, n, t: ck.save(eng, 0.0, 9, t, b + 1),
        )
        del partial
        ck_counters, start = ck.load(eng, 0.0, 9)
        assert start == 4  # all batches persisted
        resumed = DEMEngine(dem, kw).run(shots=512, seed=9, checkpoint=ck)
        assert dicts_equal(resumed, full)
