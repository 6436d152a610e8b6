"""How many BP iterations does circuit-level BP+OSD-0 actually need?

BP alone barely converges on circuit DEMs (~14% at p=0.003 on [[72,12,6]]:
hyperedge degeneracy) — OSD does the real decoding from BP's posterior LLR
ordering, which saturates long before 100 iterations. This study measures
the observable-error rate of the `complete-bposd` workload as a function of
BP max_iter, to pick the iteration budget for the presets and the LER
campaign.

    PYTHONPATH=. python scripts/dem_iters_study.py \
        --code "[[72, 12, 6]]" --trials 4096 --p 0.002 0.003
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", default="[[72, 12, 6]]")
    ap.add_argument("--trials", type=int, default=4096)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--p", type=float, nargs="+", default=[0.002, 0.003])
    ap.add_argument("--iters", type=int, nargs="+",
                    default=[10, 20, 30, 50, 100])
    ap.add_argument("--backend", default="xla")
    ap.add_argument("--method", default="sum-product")
    ap.add_argument("--out", default="results/dem_iters_study.json")
    args = ap.parse_args()

    import qldpc_jax

    qldpc_jax.enable_compilation_cache()
    from qldpc_jax.codes import get_code
    from qldpc_jax.decoders.bp import BPConfig
    from qldpc_jax.decoders.osd import OSDConfig
    from qldpc_jax.mc import DEMEngine, DEMEngineConfig
    from qldpc_jax.noise.circuit import parametric_memory_dem

    code = get_code(args.code)
    pdem = parametric_memory_dem(code)
    rows = []
    for mi in args.iters:
        eng = DEMEngine(
            pdem,
            DEMEngineConfig(
                batch_size=args.batch_size,
                bp=BPConfig(
                    max_iter=mi, method=args.method, backend=args.backend
                ),
                osd=OSDConfig(order=0),
            ),
            name=args.code,
        )
        for p in args.p:
            t0 = time.perf_counter()
            d = eng.run(args.trials, seed=7, p=p)
            dt = time.perf_counter() - t0
            rows.append(
                dict(max_iter=mi, p=p, ler=d["ler"],
                     bp_conv=d["bp_converged"] / d["trials"],
                     trials=d["trials"], trials_per_s=round(d["trials"] / dt, 1))
            )
            print(
                f"BP({mi:3d}) p={p:.4f}: obs-err={d['ler']:.5f} "
                f"bp-conv={d['bp_converged']/d['trials']:.3f} "
                f"({d['trials']/dt:7.1f} trials/s)",
                flush=True,
            )
    with open(args.out, "w") as f:
        json.dump(dict(code=args.code, trials=args.trials,
                       backend=args.backend, rows=rows), f, indent=1)
    print(json.dumps(rows[-1]))


if __name__ == "__main__":
    main()
