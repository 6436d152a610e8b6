"""Counter-mode Monte-Carlo RNG: mesh-invariant AND vectorization-friendly.

The engine draws per-sample randomness from *global sample ids* so counters
are bit-identical across mesh shapes. The obvious implementation — one
``jax.random.fold_in`` per sample + a vmapped ``bernoulli`` — makes every
sample pay a full threefry key derivation, and the vmapped draws defeat
XLA's fused counter layout.

Counter mode gets both properties at once: ONE key per (batch, rate) and
global draw counters fed straight to the threefry2x32 block cipher via its
raw primitive. Sample ``g``'s draw ``j`` is

    u[g, j] = convert( threefry2x32(key, g*P + j//2, 0)[j % 2] )

with ``P = ceil(stride/2)`` counter pairs per sample — a pure function of
the global sample id, so any shard generates exactly the bits of its global
slice and resharding cannot change the stream. Both 32-bit cipher outputs
are consumed, halving the cipher work.

Formulation notes:
  * the layout is flat (B*P,) counters, f32 conversion, then
    ``stack(axis=1).reshape(B, 2P)``;
  * the high-level ``jax.extend.random.threefry_2x32`` pairs array
    POSITIONS (count[i] with count[i+len/2]), so its output depends on the
    array length — NOT usable for shard-invariant streams;
  * on the accelerator the code was first written for, constant-folded
    (offset-free) iota counters, an int8-mask interleave and major-axis
    sample pairing each hit pathological XLA lowerings, orders of magnitude
    slower. Keep the base offset traced and do not "optimize" the layout
    without re-measuring on the GPU (times there: not measured).

Counters are uint32: callers must keep ``global_batch * ceil(stride/2) <
2^32`` (one batch's counter space; each batch re-keys via fold_in, so
ranges may repeat across batches).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.extend import random as jex_random

__all__ = ["counter_uniform", "counter_bernoulli"]


def counter_uniform(key, first_sample, batch: int, stride: int) -> jax.Array:
    """(batch, stride) uniforms in [0, 1) for global samples
    ``first_sample .. first_sample + batch``.

    ``key``: a threefry PRNG key (one per batch/rate). ``first_sample``:
    TRACED global id of this shard's first sample — a compile-time-constant
    zero sends the threefry lowering down a ~1000x slower path (see module
    notes), so callers must thread a traced zero through the jit boundary
    even for shard 0.
    """
    P = (stride + 1) // 2  # counter pairs per sample
    kd = jax.random.key_data(key)
    base = first_sample.astype(jnp.uint32) * jnp.uint32(P)
    cnt = base + jnp.arange(batch * P, dtype=jnp.uint32)
    k1 = jnp.broadcast_to(kd[0], cnt.shape)
    k2 = jnp.broadcast_to(kd[1], cnt.shape)
    o1, o2 = jex_random.threefry2x32_p.bind(k1, k2, cnt, jnp.zeros_like(cnt))
    # 24-bit mantissa trick (same uniform family as jax.random.uniform)
    conv = lambda o: (o >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        2.0**-24
    )
    u = jnp.stack([conv(o1), conv(o2)], axis=1).reshape(batch, 2 * P)
    return u[:, :stride] if 2 * P != stride else u


def counter_bernoulli(key, p, first_sample, shape: tuple[int, int]) -> jax.Array:
    """Bernoulli(p) int8 draws, one global counter stream per sample row."""
    batch, stride = shape
    u = counter_uniform(key, first_sample, batch, stride)
    return (u < p).astype(jnp.int8)
