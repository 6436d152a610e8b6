"""GPU BP kernel (ops/bp_triton.py) against the XLA path and the oracle.

The kernel runs through the Pallas interpreter here (``interpret=True``):
same kernel body, same tables, same padding and tiling as on the GPU. On
the CPU the interpreter evaluates the float32 arithmetic like the XLA path,
so decisions must agree exactly; on a GPU they differ only on chaotic lanes
(chip_smoke.py states that tolerance).
"""

import numpy as np
import pytest

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder
from qldpc_jax.noise.spacetime import space_time_matrix
from qldpc_jax.ops.bp_triton import DEFAULT_BATCH_TILE, TritonBPKernel

from oracles import bp_min_sum, bp_sum_product


def sample(rng, H, p, batch):
    n = H.shape[1]
    errors = (rng.random((batch, n)) < p).astype(np.int8)
    return (errors @ H.T) % 2


def prior_for(n, p):
    return np.full(n, np.log((1 - p) / p), np.float32)


def kernel_decoder(H, **kw):
    return BPDecoder(H, BPConfig(backend="pallas", **kw), interpret=True)


def kernel_run(H, syn, prior, batch_tile, **kw):
    """The kernel at an explicit tile, as a BPResult-like tuple."""
    from qldpc_jax.decoders.bp import BPResult

    graph = BPDecoder(H).graph
    k = TritonBPKernel(graph, batch_tile=batch_tile, interpret=True, **kw)
    values, conv, iters = k(np.asarray(syn), np.asarray(prior))
    return BPResult(hard=(np.asarray(values) < 0).astype(np.int8),
                    converged=conv, llrs=values, iterations=iters)


def assert_same_decisions(a, b):
    assert np.array_equal(np.asarray(a.converged), np.asarray(b.converged))
    assert np.array_equal(np.asarray(a.iterations), np.asarray(b.iterations))
    assert np.array_equal(np.asarray(a.hard), np.asarray(b.hard))


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_pallas_matches_xla(rng, method):
    code = get_code("[[72, 12, 6]]")
    H = code.Hx
    syn = sample(rng, H, 0.05, batch=96)
    prior = prior_for(code.n, 0.05)
    xla = BPDecoder(H, BPConfig(max_iter=25, method=method))(syn, prior)
    pal = kernel_run(H, syn, prior, 32, max_iter=25, method=method)
    assert_same_decisions(xla, pal)
    # converged lanes freeze their posteriors; saturated messages round
    # differently at the arctanh clip (leave-one-out products associate
    # differently), which moves LLRs by ~1% (cf. test_bp's float32 note)
    conv = np.asarray(xla.converged)
    np.testing.assert_allclose(
        np.asarray(pal.llrs)[conv], np.asarray(xla.llrs)[conv], rtol=0.05,
    )


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_gross_code_matches_xla(rng, method):
    """The headline shape: [[144,12,12]] Hx (72 x 144, dc=6, dv=3)."""
    code = get_code("[[144, 12, 12]]")
    H = code.Hx
    syn = sample(rng, H, 0.03, batch=64)
    prior = prior_for(code.n, 0.03)
    xla = BPDecoder(H, BPConfig(max_iter=20, method=method))(syn, prior)
    pal = kernel_decoder(H, max_iter=20, method=method)(syn, prior)
    assert_same_decisions(xla, pal)


@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_matches_dense_oracle(rng, method):
    code = get_code("[[72, 12, 6]]")
    H = code.Hx
    p = 0.04
    syn = sample(rng, H, p, batch=48)
    prior = prior_for(code.n, p)
    res = kernel_decoder(H, max_iter=20, method=method)(syn, prior)
    oracle = bp_sum_product if method == "sum-product" else bp_min_sum
    for i in range(len(syn)):
        hard, conv, _, it = oracle(H, syn[i], prior, max_iter=20)
        assert bool(res.converged[i]) == conv, i
        if conv:
            assert int(res.iterations[i]) == it, i
            assert np.array_equal(np.asarray(res.hard[i]), hard), i


def test_pallas_clipped_alpha(rng):
    code = get_code("steane")
    H = code.Hx
    syn = sample(rng, H, 0.08, batch=64)
    prior = prior_for(7, 0.08)
    kw = dict(max_iter=16, alpha=0.8, clip_llr=1.5)
    xla = BPDecoder(H, BPConfig(**kw))(syn, prior)
    pal = kernel_decoder(H, **kw)(syn, prior)
    assert_same_decisions(xla, pal)


def test_pallas_offset_min_sum(rng):
    code = get_code("steane")
    H = code.Hx
    syn = sample(rng, H, 0.08, batch=64)
    prior = prior_for(7, 0.08)
    kw = dict(max_iter=16, method="min-sum", offset=0.4, alpha=0.9)
    xla = BPDecoder(H, BPConfig(**kw))(syn, prior)
    pal = kernel_decoder(H, **kw)(syn, prior)
    assert_same_decisions(xla, pal)


def test_pallas_ragged_batch(rng):
    """Batch not a multiple of the tile: padding lanes must not leak."""
    code = get_code("steane")
    H = code.Hx
    syn = sample(rng, H, 0.05, batch=100)
    prior = prior_for(7, 0.05)
    xla = BPDecoder(H, BPConfig(max_iter=20))(syn, prior)
    pal = kernel_run(H, syn, prior, 32, max_iter=20)
    assert np.asarray(pal.hard).shape == (100, 7)
    assert_same_decisions(xla, pal)


@pytest.mark.parametrize("tile", [8, 32, 64])
def test_tile_choice_keeps_decisions(rng, tile):
    """The tile only groups lanes into programs; each lane's decode is its
    own, so every tile size gives the same answers."""
    code = get_code("[[72, 12, 6]]")
    H = code.Hx
    syn = sample(rng, H, 0.05, batch=72)
    prior = prior_for(code.n, 0.05)
    ref = kernel_decoder(H, max_iter=15)(syn, prior)
    got = kernel_run(H, syn, prior, tile, max_iter=15)
    assert_same_decisions(ref, got)


def test_default_tile_and_padding_geometry():
    g = BPDecoder(get_code("[[144, 12, 12]]").Hx).graph
    k = TritonBPKernel(g, max_iter=5)
    assert k.batch_tile == DEFAULT_BATCH_TILE
    assert k._mp % 16 == 0 and k._mp >= g.m
    assert k._np % 16 == 0 and k._np >= g.n
    with pytest.raises(ValueError, match="power of two"):
        TritonBPKernel(g, max_iter=5, batch_tile=24)


@pytest.mark.parametrize("code_name", ["steane", "[[72, 12, 6]]", "[[144, 12, 12]]"])
def test_kernel_tables_reproduce_graph(code_name):
    """vof maps each slot-major edge row to its variable; vedge maps each
    variable's edges back to those rows: together they must rebuild H."""
    H = get_code(code_name).Hx
    g = BPDecoder(H).graph
    k = TritonBPKernel(g, max_iter=1)
    dc, mp = k._vof.shape
    rebuilt = np.zeros_like(H)
    for v in range(g.n):
        for row in k._vedge[:, v]:
            if row == dc * mp:
                continue
            slot, c = divmod(int(row), mp)
            assert k._vof[slot, c] == v
            rebuilt[c, v] ^= 1
    assert np.array_equal(rebuilt, H % 2)


def test_per_lane_priors(rng):
    """(B, n) priors take the per-lane path of the kernel."""
    code = get_code("[[72, 12, 6]]")
    H = code.Hx
    syn = sample(rng, H, 0.04, batch=40)
    p = rng.uniform(0.01, 0.08, size=(40, code.n))
    prior = np.log((1 - p) / p).astype(np.float32)
    xla = BPDecoder(H, BPConfig(max_iter=15))(syn, prior)
    pal = kernel_decoder(H, max_iter=15)(syn, prior)
    assert_same_decisions(xla, pal)


def test_converged_lanes_reproduce_syndrome(rng):
    code = get_code("[[144, 12, 12]]")
    H = code.Hx
    syn = sample(rng, H, 0.06, batch=64)
    res = kernel_decoder(H, max_iter=10)(syn, prior_for(code.n, 0.06))
    conv = np.asarray(res.converged)
    assert conv.any() and not conv.all()
    hard = np.asarray(res.hard)
    assert np.array_equal((hard[conv] @ H.T) % 2, syn[conv])
    assert (np.asarray(res.iterations)[~conv] == 9).all()


@pytest.mark.parametrize(
    "case,kw",
    [
        ("damping", dict(damping=0.7)),
        ("layered", dict(schedule="layered")),
        ("irregular", dict()),
    ],
)
def test_pallas_rejects_unsupported_config(case, kw):
    """A configuration the kernel does not cover is an error, never a
    silent fallback to the XLA path."""
    H = get_code("steane").Hx
    if case == "irregular":
        H = space_time_matrix(H, 3)  # mixed check degrees
    with pytest.raises(ValueError, match="backend='xla'"):
        BPDecoder(H, BPConfig(max_iter=5, backend="pallas", **kw))


def test_pallas_rejects_traced_alpha(rng):
    H = get_code("steane").Hx
    dec = kernel_decoder(H, max_iter=5)
    with pytest.raises(ValueError, match="alpha"):
        dec(sample(rng, H, 0.05, 8), prior_for(7, 0.05), alpha=0.8)


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="backend"):
        BPConfig(backend="triton")


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["sum-product", "min-sum"])
def test_compiled_kernel_matches_xla_on_gpu(gpu, rng, method):
    """The kernel as compiled for the card (no interpreter) against the XLA
    path on the same card: every converged lane reproduces its syndrome, and
    decisions agree except on chaotic lanes (measured on an H100 at
    p=0.01: 0.07-0.1% of lanes; the limit is 0.25%)."""
    code = get_code("[[144, 12, 12]]")
    H = code.Hx
    syn = sample(rng, H, 0.01, batch=16384)
    prior = prior_for(code.n, 0.01)
    xla = BPDecoder(H, BPConfig(max_iter=50, method=method))(syn, prior)
    pal = BPDecoder(H, BPConfig(max_iter=50, method=method,
                                backend="pallas"))(syn, prior)
    conv = np.asarray(pal.converged)
    hard = np.asarray(pal.hard)
    assert np.array_equal((hard[conv] @ H.T) % 2, syn[conv])
    differ = (
        (np.asarray(xla.hard) != hard).any(axis=1)
        | (np.asarray(xla.converged) != conv)
    )
    assert differ.sum() <= 0.0025 * len(syn)
