"""Property-based tests for the GF(2) linear-algebra kernels.

The GF(2) layer (codes/gf2.py + the native C fallback in qldpc_jax/native.py)
underpins code construction, logical-operator extraction, degeneracy
classification, and every OSD budget (rank-sized column budgets in
decoders/osd.py). Hypothesis hammers them with arbitrary small matrices;
invariants are textbook linear algebra, independent of any implementation.
"""

import numpy as np
from hypothesis import given, settings, strategies as st

from qldpc_jax import native
from qldpc_jax.codes import gf2


@st.composite
def gf2_matrix(draw, max_m=12, max_n=14):
    m = draw(st.integers(1, max_m))
    n = draw(st.integers(1, max_n))
    bits = draw(
        st.lists(st.integers(0, 1), min_size=m * n, max_size=m * n)
    )
    return np.array(bits, dtype=np.uint8).reshape(m, n)


@settings(max_examples=60, deadline=None)
@given(gf2_matrix())
def test_row_reduce_preserves_row_space_and_rank(M):
    R, piv = gf2.row_reduce(M)
    assert gf2.rank(R) == gf2.rank(M) == len(piv)
    # every original row is in span(R) and vice versa
    for v in M:
        assert gf2.in_row_space(R, v)
    for v in R:
        if v.any():
            assert gf2.in_row_space(M, v)
    # pivot columns are unit columns in R (reduced form)
    for r, c in enumerate(piv):
        col = R[:, c]
        assert col[r] == 1 and col.sum() == 1


@settings(max_examples=60, deadline=None)
@given(gf2_matrix())
def test_rank_nullity_and_null_space(M):
    m, n = M.shape
    N = gf2.null_space(M)
    assert N.shape[0] == n - gf2.rank(M)  # rank-nullity
    if N.size:
        assert not ((M @ N.T) % 2).any()  # kernel vectors annihilate
        assert gf2.rank(N) == N.shape[0]  # basis is independent


@settings(max_examples=60, deadline=None)
@given(gf2_matrix())
def test_native_rank_matches_python(M):
    assert native.rank(M) == gf2.rank(M)


@settings(max_examples=60, deadline=None)
@given(gf2_matrix(), st.randoms(use_true_random=False))
def test_solve_roundtrip_and_inconsistency(M, rnd):
    m, n = M.shape
    # consistent case: b = M @ x0 must be solvable and verify
    x0 = np.array([rnd.randint(0, 1) for _ in range(n)], np.uint8)
    b = (M @ x0) % 2
    x = gf2.solve(M, b)
    assert x is not None
    assert np.array_equal((M @ x) % 2, b)
    # arbitrary b: None iff rank grows when augmenting
    b2 = np.array([rnd.randint(0, 1) for _ in range(m)], np.uint8)
    x2 = gf2.solve(M, b2)
    aug_grows = gf2.rank(np.hstack([M, b2[:, None]])) > gf2.rank(M)
    assert (x2 is None) == aug_grows
    if x2 is not None:
        assert np.array_equal((M @ x2) % 2, b2)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000))
def test_css_logical_ops_properties(seed):
    """Random CSS pair via the hypergraph-product trick: any biadjacency
    seed yields Hx @ Hz.T = 0; the extracted logicals must satisfy the
    commutation and pairing contract for whatever k results."""
    rng = np.random.default_rng(seed)
    a = (rng.random((3, 5)) < 0.4).astype(np.uint8)
    # hypergraph product of a with itself: Hx = [a x I | I x a^T]
    m, n = a.shape
    Hx = np.hstack([np.kron(a, np.eye(n, dtype=np.uint8)),
                    np.kron(np.eye(m, dtype=np.uint8), a.T)]) % 2
    Hz = np.hstack([np.kron(np.eye(n, dtype=np.uint8), a),
                    np.kron(a.T, np.eye(m, dtype=np.uint8))]) % 2
    assert not ((Hx @ Hz.T) % 2).any()
    Lx, Lz = gf2.css_logical_ops(Hx, Hz)
    k = Lx.shape[0]
    assert k == Hx.shape[1] - gf2.rank(Hx) - gf2.rank(Hz)
    if k:
        assert not ((Lx @ Hz.T) % 2).any()  # logical X commutes with Z checks
        assert not ((Lz @ Hx.T) % 2).any()
        assert np.array_equal((Lx @ Lz.T) % 2, np.eye(k, dtype=np.uint8))
        # logicals are not stabilizers
        for v in Lx:
            assert not gf2.in_row_space(Hx, v)
        for v in Lz:
            assert not gf2.in_row_space(Hz, v)
