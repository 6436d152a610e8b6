"""Alvarado-style consistency-corrected min-sum normalization (alpha).

Functional parity with rework/Alvarado.py:10-66: Monte-Carlo the
*unnormalized* one-iteration min-sum check messages R over the Tanner edges,
split them by the true value of the edge's variable, histogram both
populations, and fit log(f0(x)/f1(x)) = alpha * x through the origin.
The fitted alpha is the consistency-corrected scaling factor fed back into
the normalized min-sum decoder (rework/Alvarado.py:141,153-155).

Device-first: sampling + the 1-iteration min-sum + edge/bit pairing run batched
on device; only the histogram fit (tiny) happens on host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from qldpc_jax.decoders.bp import BPConfig, BPDecoder

__all__ = ["estimate_alpha"]


def estimate_alpha(
    H: np.ndarray,
    error_rate: float,
    trials: int = 5000,
    bins: int = 50,
    seed: int = 0,
    at_iter: int = 0,
    method: str = "min-sum",
    batch_size: int = 1024,
) -> float:
    """Estimate the min-sum normalization alpha for a code at one error rate.

    Args:
      H: parity-check matrix used for decoding.
      error_rate: physical error rate of the code-capacity channel.
      trials: number of Monte-Carlo samples.
      bins: histogram bins for the message populations.
      at_iter: which iteration's messages to use (0 == first pass, the
        reference's min-sum default; its tanh variant uses 10).
      method: "min-sum" (reference default) or "sum-product".
    """
    H = (np.asarray(H) % 2).astype(np.uint8)
    n = H.shape[1]
    dec = BPDecoder(H, BPConfig(max_iter=1, method=method, alpha=1.0))
    var_of_edge = dec.graph.var_of_edge
    prior = jnp.full((n,), float(np.log((1 - error_rate) / error_rate)), jnp.float32)

    @jax.jit
    def messages_for(key):
        errors = jax.random.bernoulli(key, error_rate, (batch_size, n)).astype(
            jnp.int8
        )
        syn = jnp.mod(
            jnp.dot(errors.astype(jnp.float32), jnp.asarray(H, jnp.float32).T),
            2.0,
        ).astype(jnp.int8)
        R = dec._raw_check_messages(syn, prior, at_iter=at_iter)
        bit = errors[:, jnp.asarray(var_of_edge)]
        return R, bit

    key = jax.random.key(seed)
    msgs, bits = [], []
    for b in range(-(-trials // batch_size)):
        R, bit = messages_for(jax.random.fold_in(key, b))
        msgs.append(np.asarray(R).ravel())
        bits.append(np.asarray(bit).ravel())
    msgs = np.concatenate(msgs)
    bits = np.concatenate(bits)

    true0 = msgs[bits == 0]
    true1 = msgs[bits == 1]
    if true1.size == 0 or true0.size == 0:
        return 1.0
    lo = min(true0.min(), true1.min())
    hi = max(true0.max(), true1.max())
    h0, edges = np.histogram(true0, bins=bins, range=(lo, hi), density=True)
    h1, _ = np.histogram(true1, bins=bins, range=(lo, hi), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ok = (h0 > 0) & (h1 > 0)
    x = centers[ok]
    y = np.log(h0[ok] / h1[ok])
    if x.size == 0 or not np.any(x != 0):
        return 1.0
    # least-squares fit of y = alpha * x through the origin
    return float(np.dot(x, y) / np.dot(x, x))
