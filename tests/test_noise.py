import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qldpc_jax.codes import get_code
from qldpc_jax.noise import (
    DEMData,
    code_capacity,
    doubled_channel,
    fold_data_correction,
    phenomenological,
    priors_to_llrs,
    sample_space_time,
    space_time_matrix,
    space_time_prior_llr,
    syndrome_of,
    uniform_prior_llr,
)


class TestChannels:
    def test_code_capacity_rate(self):
        key = jax.random.key(0)
        e = code_capacity(key, 0, 0.1, 2000, 100)
        assert e.shape == (2000, 100)
        assert abs(float(jnp.mean(e.astype(jnp.float32))) - 0.1) < 0.01

    def test_doubled_channel_rate(self):
        key = jax.random.key(1)
        p = 0.1
        e = doubled_channel(key, 0, p, 4000, 64)
        expect = 2 * p * (1 - p)
        assert abs(float(jnp.mean(e.astype(jnp.float32))) - expect) < 0.01

    def test_phenomenological_shapes(self):
        key = jax.random.key(2)
        e, f = phenomenological(key, 0, 0.05, 128, 72, 36)
        assert e.shape == (128, 72) and f.shape == (128, 36)

    def test_counter_mode_base_offsets_commute(self):
        """Counter-mode contract: sample i of a batch starting at base b is
        sample 0 of a batch starting at base b+i (stream is a pure function
        of the global sample id)."""
        key = jax.random.key(7)
        a = np.asarray(code_capacity(key, 0, 0.2, 16, 33))
        b = np.asarray(code_capacity(key, 5, 0.2, 11, 33))
        assert np.array_equal(a[5:], b)

    def test_syndrome_matches_numpy(self, rng):
        code = get_code("[[72, 12, 6]]")
        e = rng.integers(0, 2, size=(32, 72)).astype(np.int8)
        s = np.asarray(syndrome_of(code.Hx, jnp.asarray(e)))
        assert np.array_equal(s, (e @ code.Hx.T) % 2)

    def test_uniform_prior(self):
        pr = np.asarray(uniform_prior_llr(10, 0.01))
        np.testing.assert_allclose(pr, np.log(99.0), rtol=1e-5)


class TestSpaceTime:
    def test_matrix_structure_matches_reference_blocks(self):
        """Same block structure as spaceTime.py:4-18 (kron spatial + bidiagonal
        temporal), built without materializing intermediates."""
        code = get_code("steane")
        H = code.Hx
        T = 4
        Hst = space_time_matrix(H, T)
        m, n = H.shape
        assert Hst.shape == (m * T, n * T + m * T)
        spatial = Hst[:, : n * T]
        temporal = Hst[:, n * T :]
        assert np.array_equal(spatial, np.kron(np.eye(T, dtype=np.uint8), H))
        expect_t = (np.eye(m * T) + np.eye(m * T, k=-m)) % 2
        assert np.array_equal(temporal, expect_t.astype(np.uint8))

    def test_sampled_syndrome_consistent_with_matrix(self):
        """detectors == H_st @ errors mod 2 — the generative model and the
        decoding matrix must agree (this is what the reference's broken
        sampler violated, SURVEY.md §2 #16)."""
        code = get_code("steane")
        H = code.Hx
        T = 5
        key = jax.random.key(3)
        errors, det = sample_space_time(key, H, 0.1, 64, T)
        Hst = space_time_matrix(H, T)
        expect = (np.asarray(errors) @ Hst.T) % 2
        assert np.array_equal(np.asarray(det), expect)

    def test_fold_data_correction(self):
        n, T, m = 3, 2, 2
        v = jnp.asarray([[1, 0, 1, 1, 1, 0, 0, 1, 1, 0]], jnp.int8)  # e1,e2|u
        folded = np.asarray(fold_data_correction(v, n, T))
        assert np.array_equal(folded, [[0, 1, 1]])

    def test_prior_shapes(self):
        pr = np.asarray(space_time_prior_llr(7, 3, 4, 0.01, q=0.02))
        assert pr.shape == (7 * 4 + 3 * 4,)
        np.testing.assert_allclose(pr[: 28], np.log(99.0), rtol=1e-5)
        np.testing.assert_allclose(pr[28:], np.log(49.0), rtol=1e-5)


class TestDEM:
    def _toy_dem(self):
        H = np.array([[1, 1, 0], [0, 1, 1]])
        L = np.array([[1, 0, 1]])
        priors = np.array([0.01, 0.02, 0.03])
        return DEMData(H=H, L=L, priors=priors)

    def test_llrs_clip(self):
        d = DEMData(H=np.eye(2), L=np.zeros((1, 2)), priors=np.array([0.0, 1.0]))
        llrs = d.llrs
        assert np.isfinite(llrs).all()
        assert llrs[0] > 30 and llrs[1] < -30

    def test_sample_consistency(self):
        d = self._toy_dem()
        mech, det, obs = d.sample(0, shots=100)
        assert np.array_equal(det, (mech @ d.H.T) % 2)
        assert np.array_equal(obs, (mech @ d.L.T) % 2)

    def test_roundtrip(self, tmp_path):
        d = self._toy_dem()
        d.save(tmp_path / "dem.npz")
        back = DEMData.load(tmp_path / "dem.npz")
        assert np.array_equal(back.H, d.H)
        np.testing.assert_allclose(back.priors, d.priors)

    def test_shape_validation(self):
        with pytest.raises(ValueError):
            DEMData(H=np.eye(2), L=np.zeros((1, 3)), priors=np.array([0.1, 0.1]))
