"""Engine overhead profile: where does the Monte-Carlo step spend time?

Profiles the code-capacity engine's stages at low and high p. Builds cumulative
jitted programs (sample | +BP | +OSD tiers | +classify psum) over one local
batch and times each, so stage cost = difference between consecutive rows.

    PYTHONPATH=. python scripts/profile_engine.py \
        [--batch 262144] [--p 0.01 0.03 0.05] [--backend pallas|xla]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=262144)
    ap.add_argument("--p", type=float, nargs="+", default=[0.01, 0.03, 0.05])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--backend", default="pallas", choices=["xla", "pallas"])
    ap.add_argument("--out", default="results/profile_engine.json")
    args = ap.parse_args()

    import qldpc_jax

    qldpc_jax.enable_compilation_cache()
    import jax
    import jax.numpy as jnp

    from qldpc_jax.codes import get_code
    from qldpc_jax.decoders.bp import BPConfig
    from qldpc_jax.decoders.osd import OSDConfig
    from qldpc_jax.mc import EngineConfig, MonteCarloEngine

    code = get_code("[[144, 12, 12]]")
    eng = MonteCarloEngine(
        code,
        EngineConfig(
            batch_size=args.batch,
            bp=BPConfig(max_iter=50, backend=args.backend),
            osd=OSDConfig(order=0),
            channel="code-capacity",
        ),
    )
    B = eng.local_batch
    key = jax.random.key(3)
    base0 = jnp.uint32(0)

    def sample_only(p):
        e, s, pr = eng._sample(key, base0, p)
        return e.sum().astype(jnp.float32) + s.sum().astype(jnp.float32)

    def plus_bp(p):
        e, s, pr = eng._sample(key, base0, p)
        r = eng._bp.decode_fn(s, pr)
        return r.converged.sum().astype(jnp.float32) + e.sum().astype(jnp.float32)

    def plus_osd(p):
        e, s, pr = eng._sample(key, base0, p)
        r = eng._bp.decode_fn(s, pr)
        conv = r.converged
        n_fail = jnp.sum((~conv).astype(jnp.int32))
        sel = jnp.argsort(conv, stable=True)[:1024]
        sol = eng._osd._decode(s[sel], r.llrs[sel], r.hard[sel])
        return sol.sum().astype(jnp.float32) + n_fail.astype(jnp.float32)

    def full(p):
        # the real local step incl. classify + histograms (single shard)
        e, s, pr = eng._sample(key, base0, p)
        r = eng._bp.decode_fn(s, pr)
        counters = eng._classify(e, r.hard, s, r, jnp.ones((B,), bool))
        return counters.trials.astype(jnp.float32) + counters.logical_errors.astype(jnp.float32)

    stages = [("sample", sample_only), ("sample+bp", plus_bp),
              ("sample+bp+osd1024", plus_osd), ("sample+bp+classify", full)]
    results = {"batch": B, "backend": args.backend,
               "device_kind": jax.devices()[0].device_kind}
    for p in args.p:
        pv = jnp.float32(p)
        for name, fn in stages:
            f = jax.jit(lambda acc, pp, fn=fn: acc + fn(pp))
            float(f(jnp.float32(0), pv))
            t0 = time.perf_counter()
            acc = jnp.float32(0)
            for _ in range(args.reps):
                acc = f(acc, pv)
            float(acc)
            dt = (time.perf_counter() - t0) / args.reps
            results[f"p{p}_{name}_ms"] = round(dt * 1e3, 2)
            results[f"p{p}_{name}_trials_per_s"] = round(B / dt, 1)
            print(f"p={p} {name:22s} {dt*1e3:9.2f} ms  ({B/dt:12.1f} trials/s)",
                  flush=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
