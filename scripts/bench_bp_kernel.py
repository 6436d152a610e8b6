"""Time the GPU BP kernel (ops/bp_triton.py) against the XLA path.

    python scripts/bench_bp_kernel.py [--batch 262144] [--p 0.01]
        [--tiles 8 16 32] [--warps 4 8 16] [--reps 3]

Workload: bench.py's, [[144,12,12]] Hx, sum-product BP(50), code-capacity
syndromes at rate p. For each (tile, warps) the kernel's wall time per
batch is printed beside the XLA path's (chunk_size=10 early exit), with the
number of lanes whose decisions differ from the XLA path. Needs a GPU;
every line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--p", type=float, default=0.01)
    ap.add_argument("--tiles", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--warps", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import qldpc_jax
    from qldpc_jax.codes import get_code
    from qldpc_jax.decoders import BPConfig, BPDecoder
    from qldpc_jax.ops.bp_triton import TritonBPKernel

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.splitlines()[0].strip()
    qldpc_jax.enable_compilation_cache()

    H = get_code("[[144, 12, 12]]").Hx
    n = H.shape[1]
    B, p = args.batch, args.p
    errors = jax.random.bernoulli(jax.random.key(7), p, (B, n)).astype(jnp.int8)
    syn = (jnp.dot(errors.astype(jnp.int32), jnp.asarray(H.T, jnp.int32)) % 2
           ).astype(jnp.int8)
    prior = jnp.full((n,), math.log((1 - p) / p), jnp.float32)

    def timed(fn):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(syn, prior))
        first = time.perf_counter() - t0
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(syn, prior))
            ts.append(time.perf_counter() - t0)
        return out, first, ts

    xla_dec = BPDecoder(H, BPConfig(max_iter=50, chunk_size=10))
    (xh, xc, xi), first, ts = (lambda r: ((np.asarray(r[0].hard),
                                           np.asarray(r[0].converged),
                                           np.asarray(r[0].iterations)),
                                          r[1], r[2]))(
        timed(jax.jit(xla_dec.decode_fn)))
    base = {"card": card, "device_kind": dev.device_kind, "batch": B, "p": p}
    print(json.dumps({**base, "path": "xla", "first_call_s": first,
                      "wall_s": ts, "syndromes_per_s": B / min(ts),
                      "converged": int(xc.sum())}), flush=True)
    for tile in args.tiles:
        for warps in args.warps:
            k = TritonBPKernel(xla_dec.graph, max_iter=50, batch_tile=tile,
                               num_warps=warps)
            (v, c, it), first, ts = timed(jax.jit(k))
            hard = np.asarray(v) < 0
            diff = int(((hard != xh.astype(bool)).any(axis=1)
                        | (np.asarray(c) != xc) | (np.asarray(it) != xi)).sum())
            print(json.dumps({**base, "path": "kernel", "tile": tile,
                              "warps": warps, "first_call_s": first,
                              "wall_s": ts, "syndromes_per_s": B / min(ts),
                              "converged": int(np.asarray(c).sum()),
                              "lanes_differing_from_xla": diff}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
