"""Batch-in-lanes GF(2) elimination against independent references.

The lanes pipeline (dense packed systems) and its transform variant (wide
systems: circuit DEMs) are the OSD eliminators on every platform. These
cases pin them to a dense numpy RREF (tests/oracles.py) and to the native
OSD-0 (native/gf2.cpp) on the shapes the engine runs: per-sample column
permutations, ragged batches, redundant rows (rank < m), inconsistent
syndromes and nonzero BP hard decisions.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import oracles
from qldpc_jax import native
from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder
from qldpc_jax.decoders.osd import OSDConfig, OSDDecoder


def _wide_case(rng, m=40, n=640, batch=6, density=0.05, err=0.02,
               redundant=3):
    """Wide system (n_words > 4 m_words) with redundant rows."""
    H = (rng.random((m - redundant, n)) < density).astype(np.uint8)
    H[:, : m - redundant] |= np.eye(m - redundant, dtype=np.uint8)
    H = np.vstack([H, H[:redundant]])  # rank < m
    errors = (rng.random((batch, n)) < err).astype(np.int8)
    syndromes = ((errors @ H.T) % 2).astype(np.int8)
    llrs = rng.normal(size=(batch, n)).astype(np.float32) * 3.0
    hard = np.zeros((batch, n), np.int8)
    return H, syndromes, llrs, hard


def _steane_dem():
    from qldpc_jax.noise.circuit import memory_experiment_dem

    dem = memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)
    assert dem.H.shape[1] > 4 * 32 * ((dem.H.shape[0] + 31) // 32)
    return dem


def _dem_bp_inputs(rng, dem, batch):
    mech = (rng.random((batch, dem.H.shape[1])) < dem.priors[None, :]).astype(
        np.int8
    )
    syn = (mech @ dem.H.T) % 2
    res = BPDecoder(dem.H, BPConfig(max_iter=8))(
        jnp.asarray(syn), jnp.asarray(dem.llrs, jnp.float32)
    )
    return syn, res


def _canonical_pivots(H_perm, s):
    """{pivot column: reduced syndrome bit} of the full RREF of [H_perm|s]."""
    _, b, rows, cols = oracles.gf2_rref_solve(H_perm, s)
    return {c: int(b[r]) for r, c in zip(rows, cols)}


@pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]"])
def test_lanes_rref_matches_dense_oracle(rng, code_name):
    """Per-lane column permutations, like the real pipeline: the packed
    lanes RREF must equal the dense numpy RREF bit for bit."""
    H = get_code(code_name).Hx
    m, n = H.shape
    B = 32
    osd = OSDDecoder(H, OSDConfig(order=0))
    errors = (rng.random((B, n)) < 0.08).astype(np.uint8)
    resid = (errors @ H.T) % 2
    orders = np.stack([rng.permutation(n) for _ in range(B)])
    Hp = np.stack([H[:, o] for o in orders])
    A, b, _, piv = osd._eliminate_lanes(
        osd._pack_lanes(jnp.asarray(Hp)), jnp.asarray(resid.T, jnp.uint32)
    )
    A, b, piv = np.asarray(A), np.asarray(b), np.asarray(piv)
    for i in range(B):
        A_ref, b_ref, rows, cols = oracles.gf2_rref_solve(Hp[i], resid[i])
        packed_ref = np.asarray(osd._pack_rows(jnp.asarray(A_ref)))
        assert np.array_equal(A[:, :, i], packed_ref), i
        assert np.array_equal(b[:, i], b_ref), i
        assert list(piv[: len(cols), i]) == cols, i
        assert (piv[len(cols):, i] == -1).all(), i


def test_lanes_pivots_solve_systems(rng):
    """Back-substituting the pivots solves H e = resid for every lane."""
    H = get_code("steane").Hx
    n = H.shape[1]
    B = 64
    osd = OSDDecoder(H, OSDConfig(order=0))
    errors = (rng.random((B, n)) < 0.2).astype(np.uint8)
    resid = (errors @ H.T) % 2
    A = osd._pack_lanes(jnp.asarray(np.broadcast_to(H, (B, *H.shape))))
    _, b, _, piv = osd._eliminate_lanes(A, jnp.asarray(resid.T, jnp.uint32))
    b_bt, piv_bt = np.asarray(b).T, np.asarray(piv).T
    for i in range(B):
        e = np.zeros(n, np.uint8)
        for r in range(H.shape[0]):
            if piv_bt[i, r] >= 0:
                e[piv_bt[i, r]] = b_bt[i, r]
        assert np.array_equal((H @ e) % 2, resid[i]), i


@pytest.mark.parametrize("batch", [1, 37, 100])
def test_osd0_matches_native_ragged(rng, batch):
    """Any batch size, including ones no tile divides."""
    code = get_code("[[72, 12, 6]]")
    H = code.Hx
    errors = (rng.random((batch, code.n)) < 0.08).astype(np.uint8)
    syn = (errors @ H.T) % 2
    llrs = rng.normal(size=(batch, code.n)).astype(np.float32)
    hard = (rng.random((batch, code.n)) < 0.05).astype(np.int8)
    sol = np.asarray(OSDDecoder(H, OSDConfig(order=0))(syn, llrs, hard))
    for i in range(batch):
        assert np.array_equal(sol[i], native.osd0(H, syn[i], llrs[i], hard[i]))


@pytest.mark.parametrize("batch", [16, 48])
def test_transform_rref_matches_dense_oracle(rng, batch):
    """Wide systems carry the m x m transform T: the pivot columns and
    their reduced syndrome bits must be the canonical RREF's."""
    dem = _steane_dem()
    syn, res = _dem_bp_inputs(rng, dem, batch)
    osd = OSDDecoder(dem.H, OSDConfig(order=0))
    assert osd._use_transform
    order = np.asarray(
        jnp.argsort(jnp.abs(res.llrs), axis=1, stable=True)
    )
    _, b, _, piv = osd._eliminate_lanes_T(
        jnp.asarray(order), jnp.asarray(syn.T, jnp.uint32), b_exit=False
    )
    b, piv = np.asarray(b), np.asarray(piv)
    for i in range(batch):
        ref = _canonical_pivots(dem.H[:, order[i]], syn[i])
        got = {int(c): int(v) for c, v in zip(piv[:, i], b[:, i]) if c >= 0}
        assert got == ref, i


def test_b_exit_shortcut_is_exact(rng):
    """OSD-0's unresolved-b early exit gives the same solution as the full
    rank(H) sweep: every pivot found after the exit carries b = 0."""
    dem = _steane_dem()
    syn, res = _dem_bp_inputs(rng, dem, 64)
    dec = OSDDecoder(dem.H, OSDConfig(order=0))
    order = jnp.argsort(jnp.abs(res.llrs), axis=1, stable=True)
    b = jnp.asarray(np.asarray(syn).T, np.uint32)
    _, b_full, _, piv_full = dec._eliminate_lanes_T(order, b, b_exit=False)
    _, b_fast, _, piv_fast = dec._eliminate_lanes_T(order, b, b_exit=True)
    bf, pf = np.asarray(b_full), np.asarray(piv_full)
    bq, pq = np.asarray(b_fast), np.asarray(piv_fast)
    for lane in range(bf.shape[1]):
        full = {(c, v) for c, v in zip(pf[:, lane], bf[:, lane]) if c >= 0 and v}
        fast = {(c, v) for c, v in zip(pq[:, lane], bq[:, lane]) if c >= 0 and v}
        assert full == fast, lane


@pytest.mark.parametrize("order_w", [0, 4])
def test_wide_solutions_match_per_sample_path(rng, order_w):
    """Transform lanes path vs the per-sample (vmap) elimination on the
    Steane circuit DEM."""
    dem = _steane_dem()
    syn, res = _dem_bp_inputs(rng, dem, 24)
    lanes = OSDDecoder(dem.H, OSDConfig(order=order_w, backend="lanes"))
    vmap = OSDDecoder(dem.H, OSDConfig(order=order_w, backend="vmap"))
    a = np.asarray(lanes(syn, res.llrs, res.hard))
    b = np.asarray(vmap(syn, res.llrs, res.hard))
    assert np.array_equal(a, b)
    s_hat = (a @ dem.H.T) % 2
    assert (s_hat == syn).all(axis=1).mean() > 0.9


@pytest.mark.parametrize("inconsistent", [False, True])
def test_wide_osd0_matches_native(rng, inconsistent):
    H, syndromes, llrs, hard = _wide_case(rng, batch=8)
    if inconsistent:
        flip = rng.integers(0, H.shape[0], size=len(syndromes))
        syndromes[np.arange(len(syndromes)), flip] ^= 1
    sol = np.asarray(OSDDecoder(H, OSDConfig(order=0))(syndromes, llrs, hard))
    for i in range(len(syndromes)):
        expect = native.osd0(H, syndromes[i], llrs[i], hard[i])
        assert np.array_equal(sol[i], expect), i


def test_wide_osd0_with_nonzero_hard(rng):
    H, syndromes, llrs, hard = _wide_case(rng, batch=8)
    hard = (rng.random(hard.shape) < 0.03).astype(np.int8)
    sol = np.asarray(OSDDecoder(H, OSDConfig(order=0))(syndromes, llrs, hard))
    for i in range(len(syndromes)):
        expect = oracles.osd0(H, syndromes[i], llrs[i], hard[i])
        assert np.array_equal(sol[i], expect), i


def test_auto_backend_is_a_shape_rule(rng):
    """backend="auto" is the lanes pipeline on every platform; the shape
    alone picks the packed or the transform elimination."""
    dense = OSDDecoder(get_code("[[72, 12, 6]]").Hx, OSDConfig(order=0))
    wide = OSDDecoder(_wide_case(rng)[0], OSDConfig(order=0))
    assert dense.backend == wide.backend == "lanes"
    assert not dense._use_transform and wide._use_transform


@pytest.mark.parametrize("backend", ["pallas", "factored"])
def test_removed_backends_rejected(backend):
    with pytest.raises(ValueError, match="backend"):
        OSDConfig(order=0, backend=backend)


def test_dem_engine_sparse_syndrome_matches_matmul(rng):
    from qldpc_jax.mc import DEMEngine, DEMEngineConfig

    dem = _steane_dem()
    eng = DEMEngine(dem, DEMEngineConfig(batch_size=32, bp=BPConfig(max_iter=5)))
    errors = (rng.random((32, dem.H.shape[1])) < 0.01).astype(np.int8)
    got = np.asarray(eng._syndrome(jnp.asarray(errors)))
    assert np.array_equal(got, (errors @ dem.H.T) % 2)
