import numpy as np
import pytest

import oracles
from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder
from qldpc_jax.decoders.osd import OSDConfig, OSDDecoder, make_flip_patterns


def uniform_prior(n, p):
    return np.full(n, np.log((1 - p) / p))


def bp_then_llrs(rng, H, p, batch, max_iter=12):
    """Generate realistic (syndrome, llr, hard) triples via a short BP run."""
    n = H.shape[1]
    errors = (rng.random((batch, n)) < p).astype(np.int8)
    syndromes = (errors @ H.T) % 2
    res = BPDecoder(H, BPConfig(max_iter=max_iter))(syndromes, uniform_prior(n, p))
    return errors, syndromes, np.asarray(res.llrs), np.asarray(res.hard)


class TestFlipPatterns:
    def test_counts(self):
        # 1 zero pattern + C(4,1) + C(4,2) = 1 + 4 + 6
        P = make_flip_patterns(4, 2)
        assert P.shape == (11, 4)
        assert not P[0].any()
        weights = P.sum(axis=1)
        assert list(weights[1:5]) == [1] * 4
        assert list(weights[5:]) == [2] * 6

    def test_max_combinations_truncates(self):
        P = make_flip_patterns(6, 3, max_combinations=5)
        assert P.shape == (6, 6)  # zero pattern + 5


class TestOSD0:
    @pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]", "[[90, 8, 10]]"])
    def test_matches_oracle(self, rng, code_name):
        code = get_code(code_name)
        H = code.Hx
        _, syndromes, llrs, hard = bp_then_llrs(rng, H, 0.06, batch=48)
        osd = OSDDecoder(H, OSDConfig(order=0))
        sols = np.asarray(osd(syndromes, llrs, hard))
        for i in range(len(syndromes)):
            expect = oracles.osd0(H, syndromes[i], llrs[i], hard[i])
            assert np.array_equal(sols[i] % 2, expect), f"sample {i}"

    def test_solution_satisfies_syndrome(self, rng):
        """OSD output must always reproduce a consistent syndrome
        (the physics invariant the reference checks at rework/main.py:93-94)."""
        code = get_code("[[144, 12, 12]]")
        H = code.Hx
        _, syndromes, llrs, hard = bp_then_llrs(rng, H, 0.08, batch=64, max_iter=5)
        sols = np.asarray(OSDDecoder(H)(syndromes, llrs, hard))
        s_hat = (sols @ H.T) % 2
        assert np.array_equal(s_hat, syndromes)

    def test_zero_residual_returns_hard(self, rng):
        code = get_code("steane")
        H = code.Hx
        hard = np.array([[1, 0, 0, 0, 0, 0, 0]], dtype=np.int8)
        syndromes = (hard @ H.T) % 2
        llrs = np.abs(rng.normal(size=(1, 7))) + 0.5
        sols = np.asarray(OSDDecoder(H)(syndromes, llrs, hard))
        assert np.array_equal(sols, hard)


class TestOSDEnhanced:
    def test_consistent_system_returns_osd0(self, rng):
        """For consistent syndromes OSD-e must equal OSD-0 (the reference
        returns early at OSD_enhanced.py:59 whenever OSD-0 is valid)."""
        code = get_code("[[72, 12, 6]]")
        H = code.Hx
        _, syndromes, llrs, hard = bp_then_llrs(rng, H, 0.06, batch=32, max_iter=5)
        sols0 = np.asarray(OSDDecoder(H, OSDConfig(order=0))(syndromes, llrs, hard))
        sols7 = np.asarray(OSDDecoder(H, OSDConfig(order=7))(syndromes, llrs, hard))
        assert np.array_equal(sols0, sols7)

    def test_inconsistent_system_picks_min_cost(self, rng):
        """Syndrome flips make H e = s inconsistent; the search must pick the
        minimum-LLR-cost solution among OSD-0 and all flip patterns."""
        code = get_code("steane")
        H = code.Hx
        n = code.n
        errors = (rng.random((24, n)) < 0.12).astype(np.int8)
        syndromes = (errors @ H.T) % 2
        # flip one syndrome bit per sample -> often inconsistent with BP hard
        flip = rng.integers(0, H.shape[0], size=24)
        syndromes[np.arange(24), flip] ^= 1
        res = BPDecoder(H, BPConfig(max_iter=8))(syndromes, uniform_prior(n, 0.12))
        llrs, hard = np.asarray(res.llrs), np.asarray(res.hard)

        order = 2
        osd = OSDDecoder(H, OSDConfig(order=order))
        sols = np.asarray(osd(syndromes, llrs, hard))

        for i in range(24):
            # enumerate the reference search space by brute force on the oracle
            base = oracles.osd0(H, syndromes[i], llrs[i], hard[i])
            base_valid = np.array_equal((base @ H.T) % 2, syndromes[i])
            if base_valid:
                assert np.array_equal(sols[i], base)
                continue
            got_cost = np.sum(np.abs(llrs[i]) * sols[i])
            base_cost = np.sum(np.abs(llrs[i]) * base)
            assert got_cost <= base_cost + 1e-4, f"sample {i} worse than OSD-0"

    def test_order0_path_equals_order_config_zero(self, rng):
        code = get_code("steane")
        H = code.Hx
        _, syndromes, llrs, hard = bp_then_llrs(rng, H, 0.1, batch=16, max_iter=4)
        a = np.asarray(OSDDecoder(H, OSDConfig(order=0))(syndromes, llrs, hard))
        b = np.asarray(OSDDecoder(H, OSDConfig(order=3))(syndromes, llrs, hard))
        assert np.array_equal(a, b)  # consistent systems


class TestOSDeBackendEquivalence:
    def test_lanes_matches_vmap_on_inconsistent(self, rng):
        """Both OSD-e backends must produce identical solutions, including on
        syndrome-noise (inconsistent) inputs."""
        code = get_code("steane")
        H = code.Hx
        n = code.n
        errors = (rng.random((40, n)) < 0.12).astype(np.int8)
        syndromes = (errors @ H.T) % 2
        flip = rng.integers(0, H.shape[0], size=40)
        syndromes[np.arange(40), flip] ^= 1
        res = BPDecoder(H, BPConfig(max_iter=8))(syndromes, np.full(n, 2.0))
        llrs, hard = np.asarray(res.llrs), np.asarray(res.hard)
        a = np.asarray(
            OSDDecoder(H, OSDConfig(order=2, backend="lanes", chunk=16))(
                syndromes, llrs, hard
            )
        )
        b = np.asarray(
            OSDDecoder(H, OSDConfig(order=2, backend="vmap", chunk=16))(
                syndromes, llrs, hard
            )
        )
        assert np.array_equal(a, b)


class TestTransformElimination:
    """Wide systems (n_words > 4*m_words) use the m x m transform-based
    elimination instead of row-reducing the full packed system. Pivoting
    order is identical, so results must match the standard path exactly."""

    def _wide_case(self, rng, m=24, n=320, batch=24, redundant=2):
        H = (rng.random((m - redundant, n)) < 0.08).astype(np.uint8)
        H[:, : m - redundant] |= np.eye(m - redundant, dtype=np.uint8)  # full rank prefix
        H = np.vstack([H, H[:redundant]])  # redundant rows: rank < m
        errors = (rng.random((batch, n)) < 0.02).astype(np.int8)
        syndromes = (errors @ H.T) % 2
        llrs = rng.normal(size=(batch, n)).astype(np.float32) * 3.0
        hard = np.zeros((batch, n), np.int8)
        return H, syndromes, llrs, hard

    def test_transform_enabled_on_wide_system(self, rng):
        H, *_ = self._wide_case(rng)
        assert OSDDecoder(H, OSDConfig(order=0))._use_transform

    def test_osd0_matches_standard_lanes(self, rng):
        H, syndromes, llrs, hard = self._wide_case(rng)
        dec_t = OSDDecoder(H, OSDConfig(order=0, backend="lanes"))
        dec_s = OSDDecoder(H, OSDConfig(order=0, backend="lanes"))
        object.__setattr__(dec_s, "_use_transform", False)
        a = np.asarray(dec_t(syndromes, llrs, hard))
        b = np.asarray(dec_s(syndromes, llrs, hard))
        assert np.array_equal(a, b)

    def test_osd0_matches_oracle(self, rng):
        H, syndromes, llrs, hard = self._wide_case(rng, batch=12)
        dec = OSDDecoder(H, OSDConfig(order=0, backend="lanes"))
        sol = np.asarray(dec(syndromes, llrs, hard))
        for i in range(len(syndromes)):
            exp = oracles.osd0(H, syndromes[i], llrs[i], hard[i])
            assert np.array_equal(sol[i], exp), f"sample {i}"

    def test_osde_matches_standard_lanes_on_inconsistent(self, rng):
        H, syndromes, llrs, hard = self._wide_case(rng, batch=16)
        # flip detector bits so some systems become inconsistent
        flip = rng.integers(0, H.shape[0], size=16)
        syndromes = np.asarray(syndromes).copy()
        syndromes[np.arange(16), flip] ^= 1
        dec_t = OSDDecoder(H, OSDConfig(order=2, backend="lanes", chunk=8))
        dec_s = OSDDecoder(H, OSDConfig(order=2, backend="lanes", chunk=8))
        object.__setattr__(dec_s, "_use_transform", False)
        a = np.asarray(dec_t(syndromes, llrs, hard))
        b = np.asarray(dec_s(syndromes, llrs, hard))
        assert np.array_equal(a, b)


class TestParityTables:
    def test_gather_parity_equals_matmul(self, rng):
        from qldpc_jax.ops.tanner import parity_tables

        H = (rng.random((13, 57)) < 0.15).astype(np.uint8)
        vos, dcp = parity_tables(H)
        assert vos.shape == (13 * dcp,)
        bits = rng.integers(0, 2, size=(9, 57)).astype(np.int64)
        bp = np.pad(bits, ((0, 0), (0, 1)))
        got = bp[:, vos].reshape(9, 13, dcp).sum(-1) % 2
        assert np.array_equal(got, (bits @ H.T) % 2)
