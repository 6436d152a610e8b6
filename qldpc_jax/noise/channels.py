"""On-device noise channels and syndrome generation.

The reference samples errors on the host with numpy inside every driver
(code capacity: studies/study.py:54; doubled-error channel:
paperResults.py:61-64; phenomenological syndrome flips:
studies/study.py:58-60). Here sampling is a first-class, jittable,
batched device operation — and the SINGLE source of channel math: the
Monte-Carlo engine's ``_sample`` consumes these functions directly.

All channels draw from the *global counter-mode* RNG (utils/rng.py):
sample i's uniforms are a pure function of its global id, so the stream
is independent of the mesh shape and dispatch mode. ``base`` is the first
global sample id of the batch (a traced int32 in sharded runs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qldpc_jax.utils.rng import counter_bernoulli, counter_uniform

__all__ = [
    "uniform_prior_llr",
    "syndrome_of",
    "code_capacity",
    "doubled_channel",
    "phenomenological",
]


def uniform_prior_llr(n: int, p) -> jax.Array:
    """Uniform channel prior ``log((1-p)/p)`` per variable (study.py:42)."""
    p = jnp.asarray(p, jnp.float32)
    return jnp.broadcast_to(jnp.log((1.0 - p) / p), (n,))


def syndrome_of(H, errors: jax.Array) -> jax.Array:
    """Batched ``e @ H^T mod 2`` as a matmul; (B, n) -> (B, m)."""
    Hf = jnp.asarray(H, jnp.float32) if not isinstance(H, jax.Array) else H
    s = jnp.dot(
        errors.astype(jnp.float32), Hf.T, preferred_element_type=jnp.float32
    )
    return jnp.mod(s, 2.0).astype(jnp.int8)


def _as_base(base) -> jax.Array:
    """Global-first-sample id as an array. NOTE: perf-critical callers (the
    engine) must pass a TRACED value — a weak-typed constant zero sends the
    threefry lowering down a ~1000x slower path (utils/rng.py module notes);
    plain ints are accepted for convenience in examples/tests."""
    return jnp.asarray(base)


def code_capacity(key: jax.Array, base, p, batch: int, n: int) -> jax.Array:
    """iid Bernoulli(p) bit flips on each of n qubits (study.py:54)."""
    return counter_bernoulli(key, p, _as_base(base), (batch, n))


def doubled_channel(key: jax.Array, base, p, batch: int, n: int) -> jax.Array:
    """``e = e1 XOR e2`` with e_i ~ Bernoulli(p): the reference's
    X-after-Z-correction depolarizing proxy (paperResults.py:61-64).
    Equivalent to Bernoulli(2p(1-p)), sampled that way in one draw."""
    p = jnp.asarray(p, jnp.float32)
    return counter_bernoulli(key, 2.0 * p * (1.0 - p), _as_base(base), (batch, n))


def phenomenological(
    key: jax.Array, base, p, batch: int, n: int, m: int, q=None
) -> tuple[jax.Array, jax.Array]:
    """Code-capacity data errors plus Bernoulli(q) syndrome-bit flips
    (the commented-out model at studies/study.py:58-60; q defaults to p).

    Returns ``(errors (B, n), syndrome_flips (B, m))``; the caller XORs the
    flips into the true syndrome. Both draws come from one counter stream
    (stride n + m) so the sample's stream is a pure function of its id.
    """
    q = p if q is None else q
    u = counter_uniform(key, _as_base(base), batch, n + m)
    errors = (u[:, :n] < p).astype(jnp.int8)
    flips = (u[:, n:] < q).astype(jnp.int8)
    return errors, flips
