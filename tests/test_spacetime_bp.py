"""Structured space-time decoder vs the generic decoder on materialized H_st."""

import numpy as np
import pytest

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder
from qldpc_jax.decoders.spacetime_bp import SpaceTimeBPDecoder
from qldpc_jax.noise.spacetime import (
    sample_space_time,
    space_time_matrix,
    space_time_prior_llr,
)


def make_case(code_name, T, p, batch, seed=0):
    import jax

    code = get_code(code_name)
    H = code.Hx
    key = jax.random.key(seed)
    errors, det = sample_space_time(key, H, p, batch, T)
    priors = space_time_prior_llr(code.n, H.shape[0], T, p)
    return H, np.asarray(errors), np.asarray(det), np.asarray(priors)


@pytest.mark.parametrize("code_name,T", [("steane", 4), ("[[72, 12, 6]]", 3)])
def test_matches_generic_decoder(code_name, T):
    """Same math as BPDecoder on kron-materialized H_st: decisions must agree
    exactly, LLRs to float32 tolerance."""
    H, errors, det, priors = make_case(code_name, T, 0.01, batch=64)
    Hst = space_time_matrix(H, T)

    generic = BPDecoder(Hst, BPConfig(max_iter=25))(det, priors)
    structured = SpaceTimeBPDecoder(H, T, BPConfig(max_iter=25))(det, priors)

    assert np.array_equal(
        np.asarray(generic.converged), np.asarray(structured.converged)
    )
    assert np.array_equal(
        np.asarray(generic.iterations), np.asarray(structured.iterations)
    )
    assert np.array_equal(np.asarray(generic.hard), np.asarray(structured.hard))
    # LLRs: float32 op-ordering differs (per-round einsum vs flat gathers);
    # agreement is loose only in the arctanh-saturated regime
    np.testing.assert_allclose(
        np.asarray(generic.llrs), np.asarray(structured.llrs), rtol=0.03, atol=0.03
    )


def test_chunked_early_exit():
    H, errors, det, priors = make_case("steane", 5, 0.01, batch=32, seed=3)
    full = SpaceTimeBPDecoder(H, 5, BPConfig(max_iter=24))(det, priors)
    chunked = SpaceTimeBPDecoder(H, 5, BPConfig(max_iter=24, chunk_size=6))(det, priors)
    assert np.array_equal(np.asarray(full.hard), np.asarray(chunked.hard))
    assert np.array_equal(
        np.asarray(full.iterations), np.asarray(chunked.iterations)
    )


def test_converged_solutions_satisfy_detectors():
    H, errors, det, priors = make_case("[[72, 12, 6]]", 4, 0.005, batch=64, seed=7)
    Hst = space_time_matrix(H, 4)
    res = SpaceTimeBPDecoder(H, 4, BPConfig(max_iter=40))(det, priors)
    hard = np.asarray(res.hard)
    conv = np.asarray(res.converged)
    s_hat = (hard @ Hst.T) % 2
    assert conv.mean() > 0.9
    assert np.array_equal(s_hat[conv], det[conv])


def test_damped_clipped_matches_generic():
    H, errors, det, priors = make_case("steane", 3, 0.02, batch=32, seed=11)
    Hst = space_time_matrix(H, 3)
    kw = dict(max_iter=15, damping=0.8, clip_llr=20.0)
    generic = BPDecoder(Hst, BPConfig(**kw))(det, priors)
    structured = SpaceTimeBPDecoder(H, 3, BPConfig(**kw))(det, priors)
    assert np.array_equal(
        np.asarray(generic.converged), np.asarray(structured.converged)
    )
    assert np.array_equal(np.asarray(generic.hard), np.asarray(structured.hard))


def test_offset_minsum_matches_generic():
    H, _, det, priors = make_case("steane", 3, 0.03, batch=48)
    kw = dict(max_iter=15, method="min-sum", offset=0.3)
    Hst = space_time_matrix(H, 3)
    generic = BPDecoder(Hst, BPConfig(**kw))(det, priors)
    structured = SpaceTimeBPDecoder(H, 3, BPConfig(**kw))(det, priors)
    assert np.array_equal(
        np.asarray(generic.converged), np.asarray(structured.converged)
    )
    assert np.array_equal(np.asarray(generic.hard), np.asarray(structured.hard))


def test_minsum_matches_generic():
    H, errors, det, priors = make_case("steane", 3, 0.02, batch=32, seed=21)
    Hst = space_time_matrix(H, 3)
    kw = dict(max_iter=15, method="min-sum", alpha=0.8, damping=0.7, clip_llr=25.0)
    generic = BPDecoder(Hst, BPConfig(**kw))(det, priors)
    structured = SpaceTimeBPDecoder(H, 3, BPConfig(**kw))(det, priors)
    assert np.array_equal(
        np.asarray(generic.converged), np.asarray(structured.converged)
    )
    assert np.array_equal(np.asarray(generic.hard), np.asarray(structured.hard))
    assert np.array_equal(
        np.asarray(generic.iterations), np.asarray(structured.iterations)
    )


def _oracle_case(code_name, T, p, batch, q=None, seed=0):
    import jax

    H = get_code(code_name).Hx
    _, det = sample_space_time(jax.random.key(seed), H, p, batch, T, q=q)
    priors = space_time_prior_llr(H.shape[1], H.shape[0], T, p, q=q)
    return H, np.asarray(det), np.asarray(priors)


@pytest.mark.parametrize(
    "code_name,T,p,q,kw",
    [
        ("steane", 4, 0.02, None, dict(max_iter=20)),
        ("[[72, 12, 6]]", 3, 0.02, None, dict(max_iter=20)),
        ("steane", 3, 0.03, None,
         dict(max_iter=15, method="min-sum", alpha=0.8, damping=0.7,
              clip_llr=25.0)),
        ("steane", 3, 0.03, None, dict(max_iter=15, method="min-sum",
                                       offset=0.3)),
        ("steane", 3, 0.02, 0.01, dict(max_iter=12, damping=0.5,
                                       clip_llr=20.0)),
        ("steane", 1, 0.05, None, dict(max_iter=10)),
    ],
)
def test_matches_dense_oracle(code_name, T, p, q, kw):
    """The structured decoder against the float64 dense oracle on the
    materialized H_st: same convergence, and on converged samples the same
    hard decision and iteration (T=1 has no u_{t-1} temporal slot)."""
    import oracles

    H, det, priors = _oracle_case(code_name, T, p, 32, q=q)
    Hst = space_time_matrix(H, T)
    res = SpaceTimeBPDecoder(H, T, BPConfig(**kw))(det, priors)
    okw = {k: v for k, v in kw.items() if k != "method"}
    oracle = (oracles.bp_min_sum if kw.get("method") == "min-sum"
              else oracles.bp_sum_product)
    for i in range(len(det)):
        hard, conv, _, it = oracle(Hst, det[i], priors, **okw)
        assert bool(res.converged[i]) == conv, i
        if conv:
            assert np.array_equal(np.asarray(res.hard[i]), hard), i
            assert int(res.iterations[i]) == it, i


def test_ragged_batch_matches_generic():
    H, det, priors = _oracle_case("steane", 3, 0.02, 25)
    Hst = space_time_matrix(H, 3)
    generic = BPDecoder(Hst, BPConfig(max_iter=10))(det, priors)
    structured = SpaceTimeBPDecoder(H, 3, BPConfig(max_iter=10))(det, priors)
    assert np.asarray(structured.hard).shape == (25, Hst.shape[1])
    assert np.array_equal(np.asarray(generic.hard), np.asarray(structured.hard))
    assert np.array_equal(
        np.asarray(generic.iterations), np.asarray(structured.iterations)
    )


def test_engine_space_time_uses_structured_decoder():
    from qldpc_jax.decoders.osd import OSDConfig
    from qldpc_jax.mc import EngineConfig, MonteCarloEngine, counters_to_dict

    eng = MonteCarloEngine(
        get_code("steane"),
        EngineConfig(bp=BPConfig(max_iter=10), osd=OSDConfig(order=0),
                     channel="space-time", n_rounds=3, batch_size=64),
    )
    assert isinstance(eng._bp, SpaceTimeBPDecoder)
    d = counters_to_dict(eng.run_rate(0.02, trials=128, seed=0))
    assert d["trials"] == 128
    assert 0 <= d["ler"] <= 1


def test_pallas_backend_is_an_error():
    """No GPU kernel covers space-time graphs: asking for one fails at
    construction, in the decoder and through the engine."""
    from qldpc_jax.mc import EngineConfig, MonteCarloEngine

    H = get_code("steane").Hx
    with pytest.raises(NotImplementedError, match="xla"):
        SpaceTimeBPDecoder(H, 3, BPConfig(max_iter=5, backend="pallas"))
    with pytest.raises(ValueError, match="backend='xla'"):
        MonteCarloEngine(
            get_code("steane"),
            EngineConfig(bp=BPConfig(max_iter=5, backend="pallas"),
                         channel="space-time", n_rounds=3, batch_size=64),
        )
