import numpy as np
import pytest

import oracles
from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder
from qldpc_jax.decoders.alvarado import estimate_alpha


class TestCheckMessages:
    def test_first_iteration_minsum_matches_oracle(self, rng):
        """R after one unnormalized min-sum pass == the reference's
        alpha_estimation escape hatch (rework/decoding.py:58-59)."""
        code = get_code("steane")
        H = code.Hx
        m, n = H.shape
        p = 0.05
        prior = np.full(n, np.log((1 - p) / p))
        errors = (rng.random((8, n)) < p).astype(np.int8)
        syn = (errors @ H.T) % 2
        dec = BPDecoder(H, BPConfig(max_iter=1, method="min-sum", dtype="float64"))
        R_dev = np.asarray(dec.check_messages(syn, prior, at_iter=0))
        g = dec.graph
        for b in range(8):
            # oracle: one min-sum check update from the prior messages
            mask = H != 0
            Q = np.where(mask, prior, 0.0)
            ssign = (1 - 2 * syn[b]).reshape(-1, 1).astype(float)
            s = np.where(mask, np.where(Q >= 0, 1.0, -1.0), 1.0)
            r_signs = np.prod(s, axis=1, keepdims=True) * s
            aq = np.where(mask, np.abs(Q), np.inf)
            i1 = np.argmin(aq, axis=1)
            min1 = aq[np.arange(m), i1]
            tmp = aq.copy()
            tmp[np.arange(m), i1] = np.inf
            min2 = tmp.min(axis=1)
            mags = np.where(aq == min1[:, None], min2[:, None], min1[:, None])
            R_ref = np.where(mask, ssign * r_signs * mags, 0.0)
            for e in range(g.num_edges):
                c, v = g.check_of_edge[e], g.var_of_edge[e]
                np.testing.assert_allclose(R_dev[b, e], R_ref[c, v], rtol=1e-6)


class TestAlphaEstimation:
    def test_alpha_in_plausible_range(self):
        """Min-sum overestimates magnitudes, so the consistency correction
        should land below 1 (typically 0.3-1.0 for these codes)."""
        code = get_code("[[72, 12, 6]]")
        alpha = estimate_alpha(code.Hx, error_rate=0.05, trials=2000, seed=0)
        assert 0.1 < alpha < 1.2, alpha

    def test_alpha_deterministic_for_seed(self):
        code = get_code("steane")
        a1 = estimate_alpha(code.Hx, 0.08, trials=1000, seed=3)
        a2 = estimate_alpha(code.Hx, 0.08, trials=1000, seed=3)
        assert a1 == a2
