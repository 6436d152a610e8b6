"""Experiment runners: turn an ExperimentSpec into engine sweeps + artifacts.

Each reference driver (studies/study.py, paperResults.py, BP_per_Iteration.py,
spectrum.py, rework/main.py, rework/Alvarado.py) maps to `run_experiment`
with the corresponding preset; outputs preserve the reference npz schemas
(results dict-of-dicts keyed by code then metric / error rate) plus the
matching plots.
"""

from __future__ import annotations

import importlib.util
import json
import time
from pathlib import Path

import jax
import numpy as np

from qldpc_jax.codes import get_code
from qldpc_jax.decoders.alvarado import estimate_alpha
from qldpc_jax.decoders.bp import BPConfig
from qldpc_jax.decoders.osd import OSDConfig
from qldpc_jax.mc import CheckpointManager, EngineConfig, MonteCarloEngine
from qldpc_jax.utils import plotting
from qldpc_jax.utils.profiling import PhaseTimer

from .configs import ExperimentSpec

__all__ = ["run_experiment", "build_engine", "dem_batch_limit"]


def _bp_config(spec: ExperimentSpec, max_iter=None, alpha=None) -> BPConfig:
    return BPConfig(
        max_iter=max_iter if max_iter is not None else spec.bp_max_iter,
        method=spec.bp_method,
        alpha=alpha if alpha is not None else spec.alpha,
        offset=spec.offset,
        damping=spec.damping,
        clip_llr=spec.clip_llr,
        chunk_size=spec.bp_chunk_size,
        schedule=spec.bp_schedule,
        n_layers=spec.bp_layers,
        backend=spec.bp_backend,
    )


def _osd_config(spec: ExperimentSpec, order=None) -> OSDConfig | None:
    order = order if order is not None else spec.osd_order
    if order is None:
        return None
    return OSDConfig(
        order=order,
        max_combinations=spec.osd_max_combinations,
        backend=spec.osd_backend,
    )


def dem_batch_limit(H, batch: int, bytes_limit: int | None) -> int:
    """Lane count for a DEM engine on a device with ``bytes_limit`` bytes.

    The XLA slot path carries several slot-space (m * dc_pad) f32 arrays
    per lane through device memory, so big DEMs cap the lane count at what
    half the device holds (the other half is OSD's and XLA's), in multiples
    of 128 and never below 128. ``None`` (a backend that reports no limit,
    such as the CPU) leaves ``batch`` unchanged."""
    if bytes_limit is None:
        return batch
    m, n_mech = H.shape
    dcp = int(np.asarray(H.sum(1)).max())
    lane_bytes = m * dcp * 6 * 4 + n_mech * 12 * 4
    max_b = max(128, bytes_limit // 2 // lane_bytes // 128 * 128)
    return min(batch, max_b)


def build_engine(
    spec: ExperimentSpec, code_name: str, mesh=None, max_iter=None, alpha=None,
    osd_order=None,
) -> MonteCarloEngine:
    code = get_code(code_name)
    if spec.channel == "circuit-level":
        # studyComplete.py:72-109 in-repo: a parametric memory-experiment
        # DEM (Z basis, rounds=distance like the reference) decoded by
        # DEMEngine; priors are traced functions of p, so the whole rate
        # grid reuses one compiled program per code.
        from qldpc_jax.mc import DEMEngine, DEMEngineConfig
        from qldpc_jax.noise.circuit import parametric_memory_dem

        pdem = parametric_memory_dem(
            code, basis="z", rounds=spec.n_rounds or code.distance
        )
        stats = jax.local_devices()[0].memory_stats() or {}
        batch = dem_batch_limit(
            pdem.H, spec.batch_size, stats.get("bytes_limit")
        )
        if batch < spec.batch_size:
            print(
                f"[{spec.name}] {code_name}: batch_size clamped "
                f"{spec.batch_size} -> {batch} (DEM {pdem.H.shape} memory)",
                flush=True,
            )
        return DEMEngine(
            pdem,
            DEMEngineConfig(
                bp=_bp_config(spec, max_iter=max_iter, alpha=alpha),
                osd=_osd_config(spec, order=osd_order),
                batch_size=batch,
                osd_fraction=spec.osd_fraction,
            ),
            mesh=mesh,
            name=code_name,
        )
    return MonteCarloEngine(
        code,
        EngineConfig(
            bp=_bp_config(spec, max_iter=max_iter, alpha=alpha),
            osd=_osd_config(spec, order=osd_order),
            channel=spec.channel,
            n_rounds=spec.n_rounds,
            syndrome_flip_rate=spec.syndrome_flip_rate,
            batch_size=spec.batch_size,
            osd_fraction=spec.osd_fraction,
        ),
        mesh=mesh,
    )


def _llr_histograms(
    spec: ExperimentSpec, code_name: str, p: float, max_iter, alpha,
    seed: int = 0, batch: int = 2048, bins: int = 80, lim: float = 40.0,
):
    """Histogram posterior LLRs by true bit value (BP_per_Iteration.py's
    violin source data, binned for device-side accumulation)."""
    import jax
    import jax.numpy as jnp

    from qldpc_jax.decoders.bp import BPDecoder

    code = get_code(code_name)
    H = code.Hx
    n = code.n
    dec = BPDecoder(H, _bp_config(spec, max_iter=max_iter, alpha=alpha))
    key = jax.random.key(seed + 999)
    errors = jax.random.bernoulli(key, p, (batch, n)).astype(jnp.int8)
    syn = jnp.mod(
        jnp.dot(errors.astype(jnp.float32), jnp.asarray(H, jnp.float32).T), 2.0
    ).astype(jnp.int8)
    prior = jnp.full((n,), float(np.log((1 - p) / p)), jnp.float32)
    res = dec(syn, prior)
    llrs = np.asarray(res.llrs).ravel()
    bit = np.asarray(errors).ravel()
    edges = np.linspace(-lim, lim, bins + 1)
    h0, _ = np.histogram(np.clip(llrs[bit == 0], -lim, lim), bins=edges)
    h1, _ = np.histogram(np.clip(llrs[bit == 1], -lim, lim), bins=edges)
    return {"edges": edges, "true_0": h0, "true_1": h1}


def run_experiment(
    spec: ExperimentSpec, mesh=None, verbose: bool = True, checkpoint: bool = True
) -> dict:
    """Run a sweep and write <output_dir>/<name>.npz + plots.

    Returns the results dict: {code_name: {p: metrics_dict}} plus sweep
    metadata under "_meta".
    """
    out = Path(spec.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    ckpt = CheckpointManager(out / f"{spec.name}_ckpt") if checkpoint else None
    timer = PhaseTimer()

    results: dict = {}
    t0 = time.time()
    total_trials = 0
    for code_name in spec.codes:
        rates = [float(p) for p in spec.rates_for(code_name)]
        results[code_name] = {}
        iter_grid = spec.max_iter_grid or [None]
        order_grid = spec.osd_order_grid or [None]
        for max_iter in iter_grid:
          for osd_order in order_grid:
            eng = None
            for i, p in enumerate(rates):
                alpha = None
                if spec.estimate_alpha:
                    with timer.phase("alpha-estimation"):
                        alpha = estimate_alpha(
                            get_code(code_name).Hx, p,
                            method=spec.bp_method, seed=spec.seed + 17 * i,
                        )
                # the engine is p-independent (p is a traced scalar) and so
                # is a fitted alpha on xla backends (a traced per-rate
                # scalar): build once per (code, max_iter, osd_order). Only
                # pallas backends bake alpha and rebuild per rate.
                alpha_traced = spec.bp_backend != "pallas"
                if eng is None or (spec.estimate_alpha and not alpha_traced):
                    with timer.phase("engine-build"):
                        eng = build_engine(
                            spec, code_name, mesh=mesh, max_iter=max_iter,
                            alpha=None if alpha_traced else alpha,
                            osd_order=osd_order,
                        )
                run_alpha = alpha if (alpha is not None and alpha_traced) else None
                with timer.phase("sweep"):
                    if ckpt is not None:
                        counters = ckpt.run_rate(
                            eng, p, spec.trials, spec.seed + i, alpha=run_alpha
                        )
                    else:
                        counters = eng.run_rate(
                            p, spec.trials, seed=spec.seed + i, alpha=run_alpha
                        )
                from qldpc_jax.mc import counters_to_dict

                d = counters_to_dict(counters)
                if alpha is not None:
                    d["alpha"] = alpha
                if spec.osd_order_grid:
                    key = (max_iter, osd_order, p)
                elif max_iter is not None:
                    key = (max_iter, p)
                else:
                    key = p
                if spec.max_iter_grid and not spec.osd_order_grid:
                    # LLR-distribution diagnostics (the violin data of
                    # BP_per_Iteration.py): posterior LLRs of one batch,
                    # split by the true bit value, as fixed-bin histograms
                    d["llr_hist"] = _llr_histograms(
                        spec, code_name, p, max_iter, alpha, seed=spec.seed
                    )
                results[code_name][key] = d
                total_trials += d["trials"]
                if verbose:
                    extra = f" it={max_iter}" if max_iter is not None else ""
                    print(
                        f"[{spec.name}] {code_name}{extra} p={p:.5g}: "
                        f"ler={d['ler']:.5g} osd={d['osd']:.4g} "
                        f"avg_iters={d['average_iterations']:.2f}",
                        flush=True,
                    )

    wall = time.time() - t0
    results["_meta"] = {
        "spec": json.loads(spec.to_json()),
        "wall_time_s": wall,
        "throughput_trials_per_s": total_trials / max(wall, 1e-9),
    }
    _save_and_plot(spec, results, out)
    if verbose:
        print(timer.report())
        print(f"[{spec.name}] total {total_trials} trials in {wall:.1f}s "
              f"({total_trials/max(wall,1e-9):.0f}/s)")
    return results


def _save_and_plot(spec: ExperimentSpec, results: dict, out: Path) -> None:
    np.savez(
        out / f"{spec.name}.npz",
        results=np.array(results, dtype=object),
        allow_pickle=True,
    )
    _save_reference_format(spec, results, out)
    if importlib.util.find_spec("matplotlib") is None:
        print(f"[{spec.name}] matplotlib is not installed: plots skipped",
              flush=True)
        return
    _plot_results(spec, results, out)


def _save_reference_format(spec: ExperimentSpec, results: dict, out: Path) -> None:
    """Also emit the reference's archive schema (studies/study.py:105):
    ``physicalErrorRates`` + ``results`` = {code: {ler, BPs_fault,
    BPs_miscorrected, incorrectable, degeneracies}} so reference analysis
    scripts (loadResults.py style) consume our output unchanged.

    Only applies to common-grid, single-max_iter sweeps (the schema has no
    room for iteration grids or per-code rate grids); other specs still get
    the native npz + plots from :func:`_plot_results`."""
    codes = [c for c in results if c != "_meta"]
    if not codes or spec.max_iter_grid or spec.osd_order_grid:
        return
    rates0 = sorted(results[codes[0]])
    if not all(sorted(results[c]) == rates0 for c in codes):
        return  # per-code grids don't fit the common-grid schema
    ref = {}
    for c in codes:
        ref[c] = {
            "ler": [results[c][p]["ler"] for p in rates0],
            "BPs_fault": [results[c][p]["BPs_fault"] for p in rates0],
            "BPs_miscorrected": [results[c][p]["BPs_miscorrected"] for p in rates0],
            "incorrectable": [results[c][p]["incorrectable"] for p in rates0],
            "degeneracies": [results[c][p]["degeneracy_count"] for p in rates0],
        }
    np.savez(
        out / f"{spec.name}_reference_format.npz",
        physicalErrorRates=np.array(rates0),
        results=np.array(ref, dtype=object),
    )


def _plot_results(spec: ExperimentSpec, results: dict, out: Path) -> None:
    codes = [c for c in results if c != "_meta"]
    if not codes:
        return
    if spec.osd_order_grid:
        # (bp_iter x osd_order) configuration panels, one per (code, config)
        # (rework/main_different_orders.py's comparison plot)
        panels = {}
        for c in codes:
            for (mi, w, p), d in sorted(results[c].items()):
                panels.setdefault(f"{c} BP{mi}·OSD{w}", {})[p] = d
        plotting.plot_rework_panels(
            panels, path=out / f"{spec.name}_panels.png", title=spec.name
        )
        return
    if spec.max_iter_grid:
        # LER vs max_iter (BP_per_Iteration plot)
        import collections

        curves = {}
        for c in codes:
            by_iter = collections.defaultdict(list)
            for (mi, p), d in results[c].items():
                by_iter[mi].append(d["ler"])
            curves[c] = np.array([np.mean(by_iter[mi]) for mi in spec.max_iter_grid])
        plotting.plot_ler_curves(
            curves, spec.max_iter_grid, path=out / f"{spec.name}_ler_vs_iters.png",
            title=f"{spec.name}: LER vs BP iterations",
        )
        return

    rates = {c: sorted(results[c]) for c in codes}
    lers = {c: np.array([results[c][p]["ler"] for p in rates[c]]) for c in codes}
    # per-code rate grids can differ; plot on each code's own grid
    first = codes[0]
    if all(rates[c] == rates[first] for c in codes):
        plotting.plot_ler_curves(
            lers, rates[first], path=out / f"{spec.name}_ler.png", title=spec.name
        )
        per_code = {
            c: {
                k: np.array([results[c][p][k] for p in rates[c]])
                for k in ("BPs_fault", "BPs_miscorrected", "incorrectable")
            }
            for c in codes
        }
        plotting.plot_failure_decomposition(
            per_code, rates[first], path=out / f"{spec.name}_failures.png"
        )
        deg = {
            c: np.array([results[c][p]["degeneracy_count"] for p in rates[c]])
            for c in codes
        }
        plotting.plot_degeneracies(
            deg, rates[first], path=out / f"{spec.name}_degeneracies.png"
        )
    else:
        rework_style = {
            c: {p: results[c][p] for p in rates[c]} for c in codes
        }
        plotting.plot_rework_panels(
            rework_style, path=out / f"{spec.name}_panels.png", title=spec.name
        )
    # weight histograms (spectrum / rework plots)
    dists = {c: get_code(c).distance for c in codes}
    for key, suffix in [("weights_found_BP", "BP"), ("weights_found_OSD", "OSD")]:
        hists = {
            c: np.sum([results[c][p][key] for p in rates[c]], axis=0) for c in codes
        }
        if any(h.sum() for h in hists.values()):
            plotting.plot_weight_histograms(
                hists, dists, path=out / f"{spec.name}_weights_{suffix}.png",
                suffix=f"({suffix})",
            )
