"""Native GF(2) library vs the NumPy implementations."""

import numpy as np
import pytest

import oracles
from qldpc_jax import native
from qldpc_jax.codes import get_code, gf2

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native gf2 library not built"
)


def test_rank_matches_numpy(rng):
    for shape in [(10, 20), (30, 30), (50, 17)]:
        M = rng.integers(0, 2, size=shape, dtype=np.uint8)
        assert native.rank(M) == gf2.rank(M)


def test_rref_matches_numpy(rng):
    M = rng.integers(0, 2, size=(18, 31), dtype=np.uint8)
    b = rng.integers(0, 2, size=18, dtype=np.uint8)
    Rn, bn, pivn = native.rref(M, b)
    aug, piv = gf2.row_reduce(np.hstack([M, b[:, None]]), ncols=31)
    assert pivn == piv
    assert np.array_equal(Rn, aug[:, :31])
    assert np.array_equal(bn, aug[:, 31])


def test_solve(rng):
    M = rng.integers(0, 2, size=(12, 25), dtype=np.uint8)
    x_true = rng.integers(0, 2, size=25, dtype=np.uint8)
    b = (M @ x_true) % 2
    x = native.solve(M, b)
    assert x is not None
    assert np.array_equal((M @ x) % 2, b)
    # inconsistent
    M2 = np.array([[1, 0], [1, 0]], np.uint8)
    assert native.solve(M2, np.array([1, 0])) is None


def test_nullspace(rng):
    code = get_code("[[72, 12, 6]]")
    ns = native.nullspace(code.Hx)
    expect = gf2.null_space(code.Hx)
    assert ns.shape == expect.shape
    assert not ((code.Hx @ ns.T) % 2).any()
    assert gf2.rank(ns) == ns.shape[0]


def test_osd0_matches_oracle(rng):
    code = get_code("[[90, 8, 10]]")
    H = code.Hx
    n = code.n
    for _ in range(20):
        error = (rng.random(n) < 0.05).astype(np.uint8)
        syndrome = (H @ error) % 2
        llr = rng.normal(size=n) * 5
        hard = (rng.random(n) < 0.1).astype(np.uint8)
        got = native.osd0(H, syndrome, llr, hard)
        expect = oracles.osd0(H, syndrome, llr, hard)
        assert np.array_equal(got, expect)
        # syndrome satisfied (consistency invariant)
        assert np.array_equal((H @ got) % 2, syndrome)
