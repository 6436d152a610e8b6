"""Space-time (multi-round) decoding: matrix construction and sampling.

The decoding matrix follows the standard phenomenological space-time model
(same block structure the reference builds at spaceTime.py:4-18):

    H_st = [ I_T (x) H  |  I_{mT} + S_{-m} ]        shape (m*T, n*T + m*T)

variables = (e_1..e_T data errors, one fresh Bernoulli(p)^n per round;
             u_1..u_T measurement errors, Bernoulli(q)^m per round), and the
detector syndrome is the round-to-round difference

    d_t = H e_t + u_t + u_{t-1}   (u_0 = 0).

The *sampler* is implemented correctly from this generative model — the
reference's sampler and correction folding are known-broken (cumulative
syndromes never differenced properly at spaceTime.py:34-41, and
studies/studyTT.py:58 folds the correction to a scalar; see SURVEY.md §2 #16)
— so this module reproduces the intended workload, not the bug.

Syndromes are computed in structured form (batched per-round matmul +
temporal XOR), never materializing the Kronecker product on device; the dense
H_st is only assembled host-side once to build the decoder's edge tables.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "space_time_matrix",
    "sample_space_time",
    "sample_space_time_counters",
    "fold_data_correction",
    "space_time_prior_llr",
]


def space_time_matrix(H: np.ndarray, n_rounds: int) -> np.ndarray:
    """Dense (m*T, n*T + m*T) space-time check matrix (host-side, uint8)."""
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    T = n_rounds
    spatial = np.kron(np.eye(T, dtype=np.uint8), H)
    temporal = np.eye(m * T, dtype=np.uint8)
    idx = np.arange(m * (T - 1))
    temporal[m + idx, idx] ^= 1  # u_{t-1} feeds detector row t
    return np.hstack([spatial, temporal])


def sample_space_time(
    key: jax.Array, H, p, batch: int, n_rounds: int, q=None
) -> tuple[jax.Array, jax.Array]:
    """Sample per-round data+measurement errors and the detector syndrome.

    ``key`` is either one PRNG key (shape ()) or a (batch,) array of
    per-sample keys — the latter makes the stream independent of how the
    batch is sharded (mesh-invariant Monte-Carlo counters).

    Returns:
      errors: (B, n*T + m*T) int8 — ground-truth variable vector of H_st
        (data rounds concatenated, then measurement rounds).
      detectors: (B, m*T) int8 — d_t = H e_t + u_t + u_{t-1}, flattened.
    """
    H = np.asarray(H)
    m, n = H.shape
    T = n_rounds
    q = p if q is None else q
    if key.ndim == 1:  # per-sample keys
        kk = jax.vmap(jax.random.split)(key)  # (batch, 2)
        e = jax.vmap(lambda k: jax.random.bernoulli(k, p, (T, n)))(
            kk[:, 0]
        ).astype(jnp.int8)
        u = jax.vmap(lambda k: jax.random.bernoulli(k, q, (T, m)))(
            kk[:, 1]
        ).astype(jnp.int8)
    else:
        ke, ku = jax.random.split(key)
        e = jax.random.bernoulli(ke, p, (batch, T, n)).astype(jnp.int8)
        u = jax.random.bernoulli(ku, q, (batch, T, m)).astype(jnp.int8)

    return _detectors(e, u, H, batch, T)


def _detectors(e, u, H, batch: int, T: int):
    """Shared detector math: d_t = H e_t + u_t + u_{t-1} (u_0 = 0)."""
    m, n = H.shape
    Hf = jnp.asarray(np.asarray(H), jnp.float32)
    s = jnp.mod(
        jnp.einsum("btn,mn->btm", e.astype(jnp.float32), Hf), 2.0
    ).astype(jnp.int8)
    u_prev = jnp.concatenate([jnp.zeros_like(u[:, :1]), u[:, :-1]], axis=1)
    d = (s + u + u_prev) % 2

    errors = jnp.concatenate(
        [e.reshape(batch, T * n), u.reshape(batch, T * m)], axis=1
    )
    return errors, d.reshape(batch, T * m)


def sample_space_time_counters(
    key, base, H, p, batch: int, n_rounds: int, q=None
) -> tuple[jax.Array, jax.Array]:
    """Counter-mode variant of :func:`sample_space_time` (utils/rng.py):
    sample i's first ``nT`` uniforms are its data errors and the next ``mT``
    its measurement errors — a pure function of the global sample id, so
    the stream is mesh-invariant without per-sample keys. ``base`` is the
    shard's first global sample id (traced)."""
    from qldpc_jax.utils.rng import counter_uniform

    H = np.asarray(H)
    m, n = H.shape
    T = n_rounds
    q = p if q is None else q
    u_all = counter_uniform(key, base, batch, T * n + T * m)
    e = (u_all[:, : T * n].reshape(batch, T, n) < p).astype(jnp.int8)
    u = (u_all[:, T * n :].reshape(batch, T, m) < q).astype(jnp.int8)
    return _detectors(e, u, H, batch, T)


def fold_data_correction(v: jax.Array, n: int, n_rounds: int) -> jax.Array:
    """Collapse a space-time variable vector to the net per-qubit data flip.

    ``(B, n*T + m*T) -> (B, n)``: XOR of the T per-round data-error blocks.
    This is the per-qubit time fold that studies/studyTT.py:58 got wrong
    (it summed a 1-D vector to a scalar).
    """
    data = v[..., : n * n_rounds].reshape(*v.shape[:-1], n_rounds, n)
    return jnp.sum(data.astype(jnp.int32), axis=-2) % 2


def space_time_prior_llr(n: int, m: int, n_rounds: int, p, q=None) -> jax.Array:
    """Per-variable prior LLRs: log((1-p)/p) on data vars, likewise q on
    measurement vars."""
    q = p if q is None else q
    p = jnp.asarray(p, jnp.float32)
    q = jnp.asarray(q, jnp.float32)
    lp = jnp.log((1 - p) / p)
    lq = jnp.log((1 - q) / q)
    return jnp.concatenate(
        [jnp.broadcast_to(lp, (n * n_rounds,)), jnp.broadcast_to(lq, (m * n_rounds,))]
    )
