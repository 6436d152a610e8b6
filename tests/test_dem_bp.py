"""BP on irregular / detector-error-model graphs: the XLA slot path.

Irregular graphs (circuit DEMs, materialized space-time matrices) keep
messages in the padded check-slot layout. These cases pin that path to the
float64 dense oracle (tests/oracles.py) on the graphs the DEM engine
decodes: random irregular checks, the Steane memory-experiment DEM (also
cross-checked against the independent forward-propagation DEM,
tests/forward_dem_oracle.py), alpha/offset/clipping, chunked early exit
and small ragged batches. float64 runs use the exact leave-one-out product
and must match the oracle exactly; float32 runs (the large-dc one-pass
form) must agree on every converged decision.
"""

import numpy as np
import pytest

import oracles
from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder


def _irregular_H(rng, m=24, n=160, deg=24):
    H = np.zeros((m, n), np.uint8)
    for c in range(m):
        H[c, rng.choice(n, size=deg + int(rng.integers(0, 5)) - 2,
                        replace=False)] = 1
    for v in np.flatnonzero(H.sum(0) == 0):  # no empty columns
        H[rng.integers(0, m), v] = 1
    return H


def _steane_dem():
    from qldpc_jax.noise.circuit import memory_experiment_dem

    return memory_experiment_dem(get_code("steane"), p=0.01, rounds=3)


def _oracle_run(H, syn, prior, kw):
    method = kw.get("method", "sum-product")
    okw = {k: v for k, v in kw.items() if k in ("max_iter", "alpha", "clip_llr")}
    if method == "min-sum":
        okw["offset"] = kw.get("offset", 0.0)
        return [oracles.bp_min_sum(H, s, prior, **okw) for s in syn]
    return [oracles.bp_sum_product(H, s, prior, **okw) for s in syn]


def _compare_to_oracle(H, syn, prior, kw, dtype="float64"):
    res = BPDecoder(H, BPConfig(dtype=dtype, **kw))(syn, prior)
    assert not BPDecoder(H, BPConfig(**kw)).graph.check_regular
    for i, (hard, conv, llrs, it) in enumerate(_oracle_run(H, syn, prior, kw)):
        assert bool(res.converged[i]) == conv, i
        if conv:
            assert int(res.iterations[i]) == it, i
            assert np.array_equal(np.asarray(res.hard[i]), hard), i
        if dtype == "float64":
            np.testing.assert_allclose(
                np.asarray(res.llrs[i]), llrs, rtol=1e-6, atol=1e-6
            )
    return res


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_irregular_graph_matches_oracle(rng, method, dtype):
    H = _irregular_H(rng)
    p = 0.03
    prior = np.full(H.shape[1], np.log((1 - p) / p))
    errors = (rng.random((32, H.shape[1])) < p).astype(np.int8)
    syn = (errors @ H.T) % 2
    _compare_to_oracle(H, syn, prior, dict(max_iter=20, method=method), dtype)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_steane_circuit_dem_matches_oracle(rng, method):
    dem = _steane_dem()
    H = dem.H
    mech = (rng.random((24, H.shape[1])) < dem.priors[None, :]).astype(np.int8)
    syn = (mech @ H.T) % 2
    _compare_to_oracle(H, syn, dem.llrs, dict(max_iter=15, method=method))


def test_alpha_offset_clip_matches_oracle(rng):
    H = _irregular_H(rng)
    p = 0.03
    prior = np.full(H.shape[1], np.log((1 - p) / p))
    errors = (rng.random((24, H.shape[1])) < p).astype(np.int8)
    syn = (errors @ H.T) % 2
    _compare_to_oracle(
        H, syn, prior,
        dict(max_iter=16, method="min-sum", alpha=0.8, offset=0.3,
             clip_llr=25.0),
    )


def test_clipped_sum_product_matches_oracle(rng):
    dem = _steane_dem()
    H = dem.H
    mech = (rng.random((24, H.shape[1])) < dem.priors[None, :]).astype(np.int8)
    syn = (mech @ H.T) % 2
    _compare_to_oracle(H, syn, dem.llrs, dict(max_iter=12, alpha=0.9,
                                              clip_llr=6.0))


def test_chunked_early_exit_matches_full(rng):
    dem = _steane_dem()
    H = dem.H
    mech = (rng.random((64, H.shape[1])) < dem.priors[None, :]).astype(np.int8)
    syn = (mech @ H.T) % 2
    prior = dem.llrs.astype(np.float32)
    full = BPDecoder(H, BPConfig(max_iter=16))(syn, prior)
    chunked = BPDecoder(H, BPConfig(max_iter=16, chunk_size=4))(syn, prior)
    assert np.array_equal(np.asarray(full.converged), np.asarray(chunked.converged))
    assert np.array_equal(np.asarray(full.iterations), np.asarray(chunked.iterations))
    assert np.array_equal(np.asarray(full.hard), np.asarray(chunked.hard))


@pytest.mark.parametrize("batch", [1, 7])
def test_small_ragged_batch_matches_oracle(rng, batch):
    H = _irregular_H(rng)
    p = 0.04
    prior = np.full(H.shape[1], np.log((1 - p) / p))
    errors = (rng.random((batch, H.shape[1])) < p).astype(np.int8)
    syn = (errors @ H.T) % 2
    res = _compare_to_oracle(H, syn, prior, dict(max_iter=12, method="min-sum"))
    assert np.asarray(res.hard).shape == (batch, H.shape[1])


def test_forward_oracle_dem_decodes_identically(rng):
    """The backward-pass DEM and the independent forward-propagation DEM
    list the same mechanisms in another order; BP on either gives the same
    decisions once the columns are matched (float64: the column order
    changes the order of the leave-one-out products)."""
    from forward_dem_oracle import forward_dem
    from qldpc_jax.noise.circuit import DepolarizingNoise, memory_experiment

    code = get_code("steane")
    circ = memory_experiment(code, rounds=3, noise=DepolarizingNoise(0.01))
    dem = _steane_dem()
    n_det = dem.H.shape[0]
    fwd = forward_dem(circ)
    sigs = sorted(fwd)
    H_f = np.array([[(s >> k) & 1 for k in range(n_det)] for s in sigs],
                   np.uint8).T
    q = np.array([fwd[s] for s in sigs])
    # column j of dem.H <-> column perm[j] of H_f, matched by signature
    bwd_sig = [
        sum(int(b) << k for k, b in enumerate(np.concatenate([hc, lc])))
        for hc, lc in zip(dem.H.T, dem.L.T)
    ]
    pos = {s: j for j, s in enumerate(sigs)}
    perm = np.array([pos[s] for s in bwd_sig])
    np.testing.assert_allclose(q[perm], dem.priors, rtol=1e-9)
    mech = (rng.random((32, dem.H.shape[1])) < dem.priors[None, :]).astype(np.int8)
    syn = (mech @ dem.H.T) % 2
    cfg = BPConfig(max_iter=15, dtype="float64")
    a = BPDecoder(dem.H, cfg)(syn, dem.llrs)
    b = BPDecoder(H_f, cfg)(syn, np.log((1 - q) / q))
    assert np.array_equal(np.asarray(a.converged), np.asarray(b.converged))
    assert np.array_equal(np.asarray(a.hard), np.asarray(b.hard)[:, perm])
