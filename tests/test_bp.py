import numpy as np
import pytest

import oracles
from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder


def uniform_prior(n, p):
    return np.full(n, np.log((1 - p) / p))


def sample_batch(rng, H, p, batch):
    n = H.shape[1]
    errors = (rng.random((batch, n)) < p).astype(np.int8)
    syndromes = (errors @ H.T) % 2
    return errors, syndromes


class TestBPAgainstOracle:
    @pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]"])
    @pytest.mark.parametrize("method", ["sum-product", "min-sum"])
    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_matches_dense_oracle(self, rng, code_name, method, dtype):
        """float64 run must track the float64 oracle tightly; float32 agrees on
        all decisions but its saturated LLRs drift (arctanh clip rounds
        differently in f32 — SURVEY.md §7 hard part d)."""
        code = get_code(code_name)
        H = code.Hx
        p = 0.05
        prior = uniform_prior(code.n, p)
        errors, syndromes = sample_batch(rng, H, p, batch=64)

        dec = BPDecoder(H, BPConfig(max_iter=30, method=method, dtype=dtype))
        res = dec(syndromes, prior)

        oracle = (
            oracles.bp_sum_product if method == "sum-product" else oracles.bp_min_sum
        )
        tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float64" else dict(rtol=0.15)
        for i in range(len(syndromes)):
            hard, conv, llrs, iters = oracle(H, syndromes[i], prior, max_iter=30)
            assert bool(res.converged[i]) == conv, f"sample {i} convergence"
            if conv:
                assert np.array_equal(np.asarray(res.hard[i]), hard), f"sample {i}"
                assert int(res.iterations[i]) == iters, f"sample {i} iters"
            np.testing.assert_allclose(np.asarray(res.llrs[i]), llrs, **tol)

    @pytest.mark.parametrize("method", ["sum-product", "min-sum"])
    def test_damped_clipped_matches_oracle(self, rng, method):
        code = get_code("steane")
        H = code.Hx
        prior = uniform_prior(code.n, 0.08)
        _, syndromes = sample_batch(rng, H, 0.08, batch=48)
        kwargs = dict(alpha=0.8, damping=0.7, clip_llr=25.0)
        dec = BPDecoder(H, BPConfig(max_iter=20, method=method, dtype="float64", **kwargs))
        res = dec(syndromes, prior)
        oracle = (
            oracles.bp_sum_product if method == "sum-product" else oracles.bp_min_sum
        )
        for i in range(len(syndromes)):
            hard, conv, llrs, _ = oracle(H, syndromes[i], prior, max_iter=20, **kwargs)
            assert bool(res.converged[i]) == conv
            np.testing.assert_allclose(np.asarray(res.llrs[i]), llrs, rtol=1e-6, atol=1e-6)

    def test_offset_min_sum_matches_oracle(self, rng):
        """Offset min-sum (|R| -> max(|R|-beta, 0)): beyond-reference zoo
        member, oracle-pinned like the other variants."""
        code = get_code("[[72, 12, 6]]")
        H = code.Hx
        prior = uniform_prior(code.n, 0.05)
        _, syndromes = sample_batch(rng, H, 0.05, batch=48)
        kwargs = dict(offset=0.4, damping=0.8)
        dec = BPDecoder(
            H, BPConfig(max_iter=20, method="min-sum", dtype="float64", **kwargs)
        )
        res = dec(syndromes, prior)
        for i in range(len(syndromes)):
            hard, conv, llrs, _ = oracles.bp_min_sum(
                H, syndromes[i], prior, max_iter=20, **kwargs
            )
            assert bool(res.converged[i]) == conv
            np.testing.assert_allclose(
                np.asarray(res.llrs[i]), llrs, rtol=1e-6, atol=1e-6
            )

    def test_offset_requires_min_sum(self):
        with pytest.raises(ValueError):
            BPConfig(method="sum-product", offset=0.3)


class TestLayeredSchedule:
    @pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]"])
    @pytest.mark.parametrize("method", ["sum-product", "min-sum"])
    def test_matches_dense_oracle(self, rng, code_name, method):
        code = get_code(code_name)
        H = code.Hx
        p = 0.05
        prior = uniform_prior(code.n, p)
        _, syndromes = sample_batch(rng, H, p, batch=48)
        L = 3 if code_name == "steane" else 4
        dec = BPDecoder(
            H,
            BPConfig(
                max_iter=20, method=method, schedule="layered", n_layers=L,
                dtype="float64",
            ),
        )
        res = dec(syndromes, prior)
        for i in range(len(syndromes)):
            hard, conv, llrs, iters = oracles.bp_layered(
                H, syndromes[i], prior, max_iter=20, n_layers=L, method=method
            )
            assert bool(res.converged[i]) == conv, f"sample {i}"
            if conv:
                assert np.array_equal(np.asarray(res.hard[i]), hard)
                assert int(res.iterations[i]) == iters
            np.testing.assert_allclose(
                np.asarray(res.llrs[i]), llrs, rtol=1e-6, atol=1e-6
            )

    def test_layered_offset_clip_matches_oracle(self, rng):
        code = get_code("[[72, 12, 6]]")
        H = code.Hx
        prior = uniform_prior(code.n, 0.05)
        _, syndromes = sample_batch(rng, H, 0.05, batch=32)
        kw = dict(method="min-sum", alpha=0.8, offset=0.2, clip_llr=25.0)
        dec = BPDecoder(
            H,
            BPConfig(
                max_iter=15, schedule="layered", n_layers=2, dtype="float64", **kw
            ),
        )
        res = dec(syndromes, prior)
        for i in range(len(syndromes)):
            _, conv, llrs, _ = oracles.bp_layered(
                H, syndromes[i], prior, max_iter=15, n_layers=2, **kw
            )
            assert bool(res.converged[i]) == conv
            np.testing.assert_allclose(
                np.asarray(res.llrs[i]), llrs, rtol=1e-6, atol=1e-6
            )

    def test_converges_in_fewer_iterations_than_flooding(self, rng):
        """The point of the serial schedule: ~2x fewer iterations at the
        same fixed point (standard LDPC scheduling result)."""
        code = get_code("[[144, 12, 12]]")
        H = code.Hx
        p = 0.03
        prior = uniform_prior(code.n, p)
        _, syndromes = sample_batch(rng, H, p, batch=256)
        flood = BPDecoder(H, BPConfig(max_iter=50))(syndromes, prior)
        layer = BPDecoder(H, BPConfig(max_iter=50, schedule="layered"))(
            syndromes, prior
        )
        assert np.asarray(layer.converged).sum() >= np.asarray(flood.converged).sum()
        both = np.asarray(layer.converged) & np.asarray(flood.converged)
        mean_l = np.asarray(layer.iterations)[both].mean()
        mean_f = np.asarray(flood.iterations)[both].mean()
        assert mean_l <= 0.75 * mean_f, (mean_l, mean_f)

    def test_chunked_early_exit_parity(self, rng):
        code = get_code("[[90, 8, 10]]")
        H = code.Hx
        prior = uniform_prior(code.n, 0.03)
        _, syndromes = sample_batch(rng, H, 0.03, batch=64)
        kw = dict(max_iter=24, schedule="layered", n_layers=3)
        full = BPDecoder(H, BPConfig(**kw))(syndromes, prior)
        chunked = BPDecoder(H, BPConfig(chunk_size=6, **kw))(syndromes, prior)
        assert np.array_equal(np.asarray(full.converged), np.asarray(chunked.converged))
        assert np.array_equal(np.asarray(full.hard), np.asarray(chunked.hard))
        assert np.array_equal(
            np.asarray(full.iterations), np.asarray(chunked.iterations)
        )

    def test_layered_rejects_damping(self):
        with pytest.raises(ValueError):
            BPConfig(schedule="layered", damping=0.7)


class TestBPBehavior:
    def test_steane_known_answer(self):
        """Single-bit errors on Steane: BP converges and every decode
        reproduces its syndrome (cf. the reference's main.py smoke test).
        Note BP does not guarantee minimum weight: the all-ones syndrome
        legitimately converges to a weight-4 degenerate solution, so the
        assertion is syndrome reproduction, not bit-exact recovery."""
        code = get_code("steane")
        H = code.Hx
        prior = uniform_prior(7, 0.1)
        errors = np.eye(7, dtype=np.int8)
        syndromes = (errors @ H.T) % 2
        dec = BPDecoder(H, BPConfig(max_iter=50))
        res = dec(syndromes, prior)
        assert bool(np.all(res.converged))
        hard = np.asarray(res.hard)
        assert np.array_equal((hard @ H.T) % 2, syndromes)
        # six of the seven single-bit errors are recovered exactly
        assert (hard == errors).all(axis=1).sum() >= 6

    def test_zero_syndrome_converges_immediately(self):
        code = get_code("[[72, 12, 6]]")
        dec = BPDecoder(code.Hx, BPConfig(max_iter=50))
        res = dec(np.zeros((4, code.Hx.shape[0]), np.int8), uniform_prior(code.n, 0.01))
        assert bool(np.all(res.converged))
        assert np.array_equal(np.asarray(res.iterations), np.zeros(4))
        assert not np.asarray(res.hard).any()

    def test_chunked_early_exit_equals_full_scan(self, rng):
        code = get_code("[[90, 8, 10]]")
        H = code.Hx
        prior = uniform_prior(code.n, 0.03)
        _, syndromes = sample_batch(rng, H, 0.03, batch=128)
        full = BPDecoder(H, BPConfig(max_iter=40))(syndromes, prior)
        chunked = BPDecoder(H, BPConfig(max_iter=40, chunk_size=8))(syndromes, prior)
        assert np.array_equal(np.asarray(full.converged), np.asarray(chunked.converged))
        assert np.array_equal(np.asarray(full.hard), np.asarray(chunked.hard))
        assert np.array_equal(
            np.asarray(full.iterations), np.asarray(chunked.iterations)
        )

    def test_irregular_matrix(self, rng):
        """Non-regular H (padded tables + phantom edge path)."""
        H = np.array(
            [
                [1, 1, 0, 1, 0, 0, 1, 0],
                [0, 1, 1, 0, 1, 0, 0, 0],
                [1, 0, 0, 0, 1, 1, 0, 1],
                [0, 0, 1, 1, 0, 1, 0, 0],
            ],
            dtype=np.uint8,
        )
        prior = uniform_prior(8, 0.05)
        errors, syndromes = sample_batch(rng, H, 0.05, batch=32)
        res = BPDecoder(H, BPConfig(max_iter=25, dtype="float64"))(syndromes, prior)
        for i in range(32):
            hard, conv, llrs, _ = oracles.bp_sum_product(
                H, syndromes[i], prior, max_iter=25
            )
            assert bool(res.converged[i]) == conv
            np.testing.assert_allclose(np.asarray(res.llrs[i]), llrs, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("method", ["sum-product", "min-sum"])
    def test_large_dc_graph_against_oracle(self, rng, method):
        """dc > 16 graphs (the DEM regime) switch the f32 check update to the
        one-pass log-domain / total-parity form. Contract: float64 stays on
        the exact cumprod and matches the oracle exactly; float32's
        approximation agrees on every decision and keeps LLRs within ~1e-4
        relative (the stated ~1e-5 per-message error, accumulated)."""
        m, n, deg = 24, 160, 24  # every check has dc = 24 > 16
        H = np.zeros((m, n), np.uint8)
        for c in range(m):
            H[c, rng.choice(n, size=deg, replace=False)] = 1
        prior = uniform_prior(n, 0.03)
        _, syndromes = sample_batch(rng, H, 0.03, batch=32)

        res64 = BPDecoder(H, BPConfig(max_iter=20, method=method, dtype="float64"))(
            syndromes, prior
        )
        res32 = BPDecoder(H, BPConfig(max_iter=20, method=method, dtype="float32"))(
            syndromes, prior
        )
        oracle = (
            oracles.bp_sum_product if method == "sum-product" else oracles.bp_min_sum
        )
        for i in range(len(syndromes)):
            hard, conv, llrs, iters = oracle(H, syndromes[i], prior, max_iter=20)
            # f64: exact oracle parity (the design invariant)
            assert bool(res64.converged[i]) == conv
            np.testing.assert_allclose(
                np.asarray(res64.llrs[i]), llrs, rtol=1e-6, atol=1e-6
            )
            # f32 one-pass form: same decisions; LLRs tolerance-bounded on
            # converged samples (non-converged min-sum trajectories are
            # chaotic — f32 rounding alone can grow LLR deltas there)
            assert bool(res32.converged[i]) == conv
            if conv:
                assert np.array_equal(np.asarray(res32.hard[i]), hard)
                assert int(res32.iterations[i]) == iters
                np.testing.assert_allclose(
                    np.asarray(res32.llrs[i]), llrs, rtol=5e-3, atol=5e-3
                )

    def test_converged_hard_reproduces_syndrome(self, rng):
        code = get_code("[[144, 12, 12]]")
        H = code.Hx
        _, syndromes = sample_batch(rng, H, 0.02, batch=256)
        res = BPDecoder(H, BPConfig(max_iter=50))(syndromes, uniform_prior(code.n, 0.02))
        hard = np.asarray(res.hard)
        conv = np.asarray(res.converged)
        s_hat = (hard @ H.T) % 2
        assert np.array_equal(s_hat[conv], syndromes[conv])
        assert conv.mean() > 0.9  # most samples decode at this p

    def test_check_messages_shape(self, rng):
        code = get_code("steane")
        dec = BPDecoder(code.Hx, BPConfig(max_iter=10, method="min-sum"))
        _, syndromes = sample_batch(rng, code.Hx, 0.05, batch=8)
        R = dec.check_messages(syndromes, uniform_prior(7, 0.05), at_iter=0)
        assert R.shape == (8, dec.graph.num_edges)
