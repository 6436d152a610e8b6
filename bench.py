"""Headline benchmark: decoded syndromes/s on one GPU, [[144,12,12]] BP.

Workload: code-capacity syndromes at p = 0.01, sum-product BP with
max_iter = 50 on the fused GPU kernel (ops/bp_triton.py), batches of
262144 syndromes made on the device. Each timed call decodes a fresh batch
and ends in ``block_until_ready``; compilation and a warm-up call come
before the timed region.

    python bench.py

Fails without a GPU. Prints one JSON line naming the device, the card and
its power limit.
"""

import json
import math
import subprocess
import sys
import time

BATCH = 262144
REPS = 8
P = 0.01


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0].strip()

    import jax.numpy as jnp

    import qldpc_jax
    from qldpc_jax.codes import get_code
    from qldpc_jax.decoders import BPConfig, BPDecoder

    qldpc_jax.enable_compilation_cache()
    H = get_code("[[144, 12, 12]]").Hx
    n = H.shape[1]
    dec = BPDecoder(H, BPConfig(max_iter=50, backend="pallas"))
    prior = jnp.full((n,), math.log((1 - P) / P), jnp.float32)
    Ht = jnp.asarray(H.T, jnp.int32)

    @jax.jit
    def make_batch(key):
        errors = jax.random.bernoulli(key, P, (BATCH, n))
        return (jnp.dot(errors.astype(jnp.int32), Ht) % 2).astype(jnp.int8)

    @jax.jit
    def step(syn):
        res = dec.decode_fn(syn, prior)
        return res.converged.sum(), res.iterations.sum()

    batches = [make_batch(jax.random.key(i)) for i in range(REPS + 1)]
    conv, _ = jax.block_until_ready(step(batches[-1]))  # compile + warm up
    if int(conv) < 0.99 * BATCH:
        raise AssertionError(f"decoder sanity check failed: {int(conv)} converged")

    t0 = time.perf_counter()
    for syn in batches[:REPS]:
        out = step(syn)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "metric": "decoded_syndromes_per_s_144_bp50",
        "value": BATCH * REPS / dt,
        "unit": "syndromes/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
