"""OSD-e(order 7) on wide systems: cost and LER delta vs OSD-0.

Measures the transform-path pattern search (decoders/osd.py) on wide/DEM
systems. Two workloads:

  * [[288, 12, 18]] code capacity at p=0.04 (the rework+osde7 regime)
  * [[72, 12, 6]] circuit DEM (432 x 15765) at p=0.003

For each: per-batch OSD wall time at order 0 vs 7, and the engine-level
LER with both, written to results/bench_osde_wide.json.

    PYTHONPATH=. python scripts/bench_osde_wide.py
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def _time_osd(H, priors_llr, order, batch, seed=0, reps=3):
    import jax
    import jax.numpy as jnp

    from qldpc_jax.decoders.bp import BPConfig, BPDecoder
    from qldpc_jax.decoders.osd import OSDConfig, OSDDecoder

    rng = np.random.default_rng(seed)
    p_bit = 1.0 / (1.0 + np.exp(priors_llr))
    errors = (rng.random((batch, H.shape[1])) < p_bit[None, :]).astype(np.int8)
    syn = jnp.asarray((errors @ H.T) % 2)
    bp = BPDecoder(H, BPConfig(max_iter=5))
    res = bp(syn, jnp.asarray(priors_llr, jnp.float32))
    osd = OSDDecoder(H, OSDConfig(order=order))

    f = jax.jit(lambda s, l, h: osd._decode(s, l, h).sum())
    float(f(syn, res.llrs, res.hard))
    t0 = time.perf_counter()
    acc = 0.0
    for _ in range(reps):
        acc += float(f(syn, res.llrs, res.hard))
    dt = (time.perf_counter() - t0) / reps
    return dt


def _engine_ler(code_name, channel, p, order, trials, batch, backend="xla"):
    from qldpc_jax.codes import get_code
    from qldpc_jax.decoders.bp import BPConfig
    from qldpc_jax.decoders.osd import OSDConfig
    from qldpc_jax.mc import (
        DEMEngine,
        DEMEngineConfig,
        EngineConfig,
        MonteCarloEngine,
        counters_to_dict,
    )

    if channel == "circuit-level":
        from qldpc_jax.noise.circuit import parametric_memory_dem

        eng = DEMEngine(
            parametric_memory_dem(get_code(code_name)),
            DEMEngineConfig(
                batch_size=batch,
                bp=BPConfig(max_iter=30, backend=backend),
                osd=OSDConfig(order=order),
            ),
            name=code_name,
        )
        t0 = time.perf_counter()
        d = eng.run(trials, seed=11, p=p)
    else:
        eng = MonteCarloEngine(
            get_code(code_name),
            EngineConfig(
                batch_size=batch,
                bp=BPConfig(max_iter=50, backend=backend),
                osd=OSDConfig(order=order),
                channel=channel,
            ),
        )
        t0 = time.perf_counter()
        d = counters_to_dict(eng.run_rate(p, trials, seed=11))
    dt = time.perf_counter() - t0
    return d["ler"], d["trials"] / dt


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8192)
    ap.add_argument("--osd-batch", type=int, default=256)
    ap.add_argument("--out", default="results/bench_osde_wide.json")
    args = ap.parse_args()

    import qldpc_jax

    qldpc_jax.enable_compilation_cache()
    from qldpc_jax.codes import get_code
    from qldpc_jax.noise.circuit import parametric_memory_dem

    out = {}

    # --- [[288,12,18]] code capacity, p=0.04 ------------------------------
    code = get_code("[[288, 12, 18]]")
    p = 0.04
    llr = np.full(code.n, np.log((1 - p) / p), np.float32)
    for order in (0, 7):
        dt = _time_osd(code.Hx, llr, order, args.osd_batch)
        out[f"cc288_osd{order}_ms_per_{args.osd_batch}batch"] = round(dt * 1e3, 2)
        print(f"[[288]] OSD-{order}: {dt*1e3:.1f} ms/{args.osd_batch}-batch", flush=True)
    for order in (0, 7):
        ler, tps = _engine_ler("[[288, 12, 18]]", "code-capacity", p, order,
                               args.trials, 4096)
        out[f"cc288_osd{order}_ler_p0.04"] = ler
        out[f"cc288_osd{order}_trials_per_s"] = round(tps, 1)
        print(f"[[288]] engine OSD-{order}: ler={ler:.5f} ({tps:.0f}/s)", flush=True)

    # --- [[72,12,6]] circuit DEM, p=0.003 ----------------------------------
    dem = parametric_memory_dem(get_code("[[72, 12, 6]]")).at(0.003)
    for order in (0, 7):
        dt = _time_osd(dem.H, dem.llrs.astype(np.float32), order, args.osd_batch)
        out[f"dem72_osd{order}_ms_per_{args.osd_batch}batch"] = round(dt * 1e3, 2)
        print(f"DEM72 OSD-{order}: {dt*1e3:.1f} ms/{args.osd_batch}-batch", flush=True)
    for order in (0, 7):
        ler, tps = _engine_ler("[[72, 12, 6]]", "circuit-level", 0.003, order,
                               min(args.trials, 4096), 1024)
        out[f"dem72_osd{order}_obs_err_p0.003"] = ler
        out[f"dem72_osd{order}_trials_per_s"] = round(tps, 1)
        print(f"DEM72 engine OSD-{order}: obs-err={ler:.5f} ({tps:.0f}/s)", flush=True)

    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
