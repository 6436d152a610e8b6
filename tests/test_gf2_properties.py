"""Property-based tests for the GF(2) linear-algebra kernels."""

import numpy as np
from hypothesis import given, settings, strategies as st

from qldpc_jax.codes import gf2


def matrices(max_m=24, max_n=32):
    return st.integers(0, 2**31 - 1).flatmap(
        lambda seed: st.tuples(
            st.integers(1, max_m), st.integers(1, max_n), st.just(seed)
        )
    )


@given(matrices())
@settings(max_examples=40, deadline=None)
def test_rref_is_idempotent_and_rank_stable(args):
    m, n, seed = args
    M = np.random.default_rng(seed).integers(0, 2, size=(m, n), dtype=np.uint8)
    R1, piv1 = gf2.row_reduce(M)
    R2, piv2 = gf2.row_reduce(R1)
    assert np.array_equal(R1, R2)
    assert piv1 == piv2
    assert len(piv1) == gf2.rank(M)


@given(matrices())
@settings(max_examples=40, deadline=None)
def test_nullspace_rank_theorem(args):
    m, n, seed = args
    M = np.random.default_rng(seed).integers(0, 2, size=(m, n), dtype=np.uint8)
    ns = gf2.null_space(M)
    assert ns.shape[0] == n - gf2.rank(M)
    if ns.size:
        assert not ((M @ ns.T) % 2).any()
        assert gf2.rank(ns) == ns.shape[0]


@given(matrices())
@settings(max_examples=40, deadline=None)
def test_solve_agrees_with_membership(args):
    m, n, seed = args
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 2, size=(m, n), dtype=np.uint8)
    # b in the image: must solve; arbitrary b: solve iff rank unchanged
    b = rng.integers(0, 2, size=m, dtype=np.uint8)
    x = gf2.solve(M, b)
    in_image = gf2.rank(np.hstack([M, b[:, None]])) == gf2.rank(M)
    assert (x is not None) == in_image
    if x is not None:
        assert np.array_equal((M @ x) % 2, b)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_native_matches_numpy_rank(seed):
    from qldpc_jax import native

    if not native.available():
        return
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 2, size=(rng.integers(1, 40), rng.integers(1, 70)), dtype=np.uint8)
    assert native.rank(M) == gf2.rank(M)
