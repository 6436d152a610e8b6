"""Full-scale LER validation campaign vs the reference's archived curves.

Workloads, each compared cell-by-cell against the archived values within
binomial error bars:

  * bp+osd0       — BP(50)+OSD-0, code capacity (BASELINE.md §1)
  * bp-only       — BP(50), code capacity (§2, CC-50k archives)
  * doubled+osde7 — BP(200)+OSD-e(7), doubled channel (§4: data/3-BPOSD.npz,
                    10k trials; see the archive-disambiguation note at
                    DOUBLED_REF below — BASELINE.md's §4 attribution of
                    2-BPOSD is wrong)
  * cc+osde7-200  — same decoder on the plain code-capacity channel
                    (data/2-BPOSD.npz, 50k trials). On in-image syndromes
                    OSD-e == OSD-0 by the early return (OSD_enhanced.py:59),
                    so the archived decoder's OSD variant cannot move these
                    cells.
  * rework+osde7  — BP(50)+OSD-e(7), code capacity (§5,
                    rework/simulation_results.npz; avg_iterations ~ 49-50 at
                    p=0.1 pins that archive's effective iteration cap at 50,
                    BASELINE.md §5 note)

Usage:  python scripts/validate_baseline.py [--trials 10000] [--out results/validation]
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import qldpc_jax

qldpc_jax.enable_compilation_cache()

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig
from qldpc_jax.decoders.osd import OSDConfig
from qldpc_jax.mc import EngineConfig, MonteCarloEngine, counters_to_dict

P_GRID = np.logspace(-3.2, -1.3, 8)

# BASELINE.md §1: BP(50)+OSD-0, 1000 trials (p index 5, 6, 7 of the grid)
BPOSD_REF = {
    "[[72, 12, 6]]": {5: 0.004, 6: 0.026, 7: 0.183},
    "[[90, 8, 10]]": {5: 0.002, 6: 0.005, 7: 0.053},
    "[[108, 8, 10]]": {5: 0.000, 6: 0.007, 7: 0.057},
    "[[144, 12, 12]]": {5: 0.000, 6: 0.003, 7: 0.048},
    "[[288, 12, 18]]": {5: 0.000, 6: 0.002, 7: 0.021},
}
BPOSD_REF_TRIALS = 1000

# BASELINE.md §2: BP-only, 50 000 trials (grid indices 2..7)
BP_REF = {
    "[[72, 12, 6]]": {2: 2e-05, 3: 1.8e-04, 4: 9.2e-04, 5: 5.26e-03, 6: 3.496e-02, 7: 0.18312},
    "[[90, 8, 10]]": {2: 0.0, 3: 8e-05, 4: 2.4e-04, 5: 1.50e-03, 6: 1.298e-02, 7: 0.11326},
    "[[108, 8, 10]]": {2: 2e-05, 3: 8e-05, 4: 3.2e-04, 5: 2.10e-03, 6: 1.088e-02, 7: 0.10140},
    "[[144, 12, 12]]": {2: 0.0, 3: 6e-05, 4: 6.2e-04, 5: 2.46e-03, 6: 1.306e-02, 7: 0.09014},
    "[[288, 12, 18]]": {2: 4e-05, 3: 1.2e-04, 4: 1.02e-03, 5: 5.48e-03, 6: 1.906e-02, 7: 0.09442},
}
BP_REF_TRIALS = 50_000

# BASELINE §4 archives, disambiguated by reproducing them (2026-08-18):
# the three `k-BPOSD.npz` files share the decoder but differ in channel/
# grid/scale — identified by integer error counts and by direct matches:
#   1-BPOSD: doubled channel, grid [0.05..0.008] (7 pts), 10k trials
#   2-BPOSD: PLAIN code-capacity channel, grid [0.01..0.0009], 50k trials
#            (BASELINE.md's "doubled, 10k" label is wrong on both counts —
#            doubled at p=0.01 gives LER 1.25e-2 for [[72]], the archive
#            says 1.54e-3, and its counts are integers only at /5e4)
#   3-BPOSD: doubled channel, grid [0.01..0.0009], 10k trials (our doubled
#            run reproduces [[72]] idx0 = 0.0125 exactly)
GRID_B = [0.01, 0.006, 0.005, 0.004]
DOUBLED_REF = {  # data/3-BPOSD.npz
    "[[72, 12, 6]]": {0: 0.0125, 1: 0.0024, 2: 0.0015, 3: 0.0008},
    "[[90, 8, 10]]": {0: 0.0014, 1: 0.0001, 2: 0.0, 3: 0.0},
    "[[108, 8, 10]]": {0: 0.002, 1: 0.0, 2: 0.0001, 3: 0.0},
    "[[144, 12, 12]]": {0: 0.0009, 1: 0.0001, 2: 0.0003, 3: 0.0},
    "[[288, 12, 18]]": {0: 0.0009, 1: 0.0002, 2: 0.0001, 3: 0.0},
}
DOUBLED_REF_TRIALS = 10_000
CC_BPOSD_REF = {  # data/2-BPOSD.npz
    "[[72, 12, 6]]": {0: 1.54e-3, 1: 4.4e-4, 2: 1e-4, 3: 4e-5},
    "[[90, 8, 10]]": {0: 1.4e-4, 1: 2e-5, 2: 2e-5, 3: 0.0},
    "[[108, 8, 10]]": {0: 2.6e-4, 1: 2e-5, 2: 2e-5, 3: 0.0},
    "[[144, 12, 12]]": {0: 1.8e-4, 1: 4e-5, 2: 6e-5, 3: 2e-5},
    "[[288, 12, 18]]": {0: 2.2e-4, 1: 2e-5, 2: 0.0, 3: 0.0},
}
CC_BPOSD_REF_TRIALS = 50_000

# BASELINE.md §5: rework per-code OSD-e(7) cells, 10k trials, BP cap ~50
REWORK_GRID = [0.04, 0.05, 0.06, 0.1]
REWORK_REF = {
    "[[72, 12, 6]]": {0: 0.0813, 1: 0.1525, 2: 0.2539, 3: 0.6637},
    "[[90, 8, 10]]": {0: 0.0243, 1: 0.0670, 2: 0.1358, 3: 0.5929},
    "[[108, 8, 10]]": {0: 0.0162, 1: 0.0538, 2: 0.1276, 3: 0.6130},
    "[[144, 12, 12]]": {0: 0.0157, 1: 0.0583, 2: 0.1432, 3: 0.7235},
    "[[288, 12, 18]]": {0: 0.0022, 1: 0.0216, 2: 0.1042, 3: 0.8329},
}
REWORK_REF_TRIALS = 10_000

# BASELINE.md §6: phenomenological (data errors + syndrome flips at the
# same rate, decoded on the plain H), BP-only, 100 trials — the reference's
# commented-out model at studies/study.py:58-60, archived in
# data/PH-LERS-BP.npz (ler == BPs_fault/100: a BP failure counts as a
# logical error, the same bp-only semantics as §2)
PH_REF = {
    "[[72, 12, 6]]": dict(enumerate([0.01, 0.03, 0.09, 0.13, 0.19, 0.4, 0.54, 0.87])),
    "[[90, 8, 10]]": dict(enumerate([0.02, 0.04, 0.12, 0.19, 0.25, 0.6, 0.7, 0.94])),
    "[[108, 8, 10]]": dict(enumerate([0.03, 0.07, 0.1, 0.2, 0.27, 0.57, 0.77, 0.91])),
    "[[144, 12, 12]]": dict(enumerate([0.08, 0.07, 0.1, 0.31, 0.35, 0.69, 0.89, 1.0])),
    "[[288, 12, 18]]": dict(enumerate([0.12, 0.22, 0.35, 0.51, 0.71, 0.93, 0.99, 1.0])),
}
PH_REF_TRIALS = 100

# Round-2 verdict's two contested rework cells ([[288]] p=0.04 sides with
# the reference's own 10k companion archive, which disagrees with its
# sibling by 3x; [[144]] p=0.06 was 4% off) — re-run at 100k trials:
#   python scripts/validate_baseline.py --workloads rework-contested --trials 100000
REWORK_CONTESTED_REF = {
    "[[144, 12, 12]]": {2: 0.1432},
    "[[288, 12, 18]]": {0: 0.0022},
}

# SURVEY §6 reproduction contract: notebooks/data/{BP,BPOSD}.npz — BP(50)
# alone vs BP(50)+OSD-0, 10k trials, full 8-point grid, all 5 codes
# (producer: notebooks/degeneracyCount.ipynb cells 3-9). The BP notebook's
# ler is ADDITIVE: a non-converged trial increments logical_error once for
# the fault and once more if the residual is logical (cell 5) — matched by
# our `ler_notebook` metric (bp_faults + residual_logicals)/trials.
NB_BP_REF = {
    "[[72, 12, 6]]": {2: 0.0001, 3: 0.0003, 4: 0.0012, 5: 0.0084, 6: 0.05, 7: 0.2712},
    "[[90, 8, 10]]": {2: 0.0, 3: 0.0, 4: 0.0002, 5: 0.002, 6: 0.0191, 7: 0.1877},
    "[[108, 8, 10]]": {2: 0.0, 3: 0.0, 4: 0.0007, 5: 0.0015, 6: 0.0137, 7: 0.17},
    "[[144, 12, 12]]": {2: 0.0, 3: 0.0, 4: 0.0002, 5: 0.001, 6: 0.014, 7: 0.1465},
    "[[288, 12, 18]]": {2: 0.0, 3: 0.0002, 4: 0.0009, 5: 0.0031, 6: 0.0164, 7: 0.1281},
}
NB_BPOSD_REF = {
    "[[72, 12, 6]]": {2: 0.0001, 3: 0.0003, 4: 0.0006, 5: 0.0057, 6: 0.0263, 7: 0.1629},
    "[[90, 8, 10]]": {2: 0.0, 3: 0.0, 4: 0.0, 5: 0.0006, 6: 0.0056, 7: 0.0687},
    "[[108, 8, 10]]": {2: 0.0, 3: 0.0001, 4: 0.0, 5: 0.0006, 6: 0.0034, 7: 0.0544},
    "[[144, 12, 12]]": {2: 0.0, 3: 0.0, 4: 0.0, 5: 0.0008, 6: 0.0031, 7: 0.0499},
    "[[288, 12, 18]]": {2: 0.0, 3: 0.0, 4: 0.0002, 5: 0.0003, 6: 0.0021, 7: 0.0225},
}
NB_REF_TRIALS = 10_000


def bars(p_ref, n_ref, p_got, n_got, sigmas=3.0, rel=0.0):
    """Two-sample binomial comparison tolerance.

    ``rel`` adds a relative slack used for the BP-only workloads: BP
    *failure rates* are implementation-sensitive, and since round 4 that is
    a measurement, not an argument — scripts/bp_sensitivity.py decodes
    identical syndrome sets through the f32 production decoder, a f64 build
    of the same algorithm, and a f64 decoder with the reference's exact
    formulation: per-sample convergence disagreement reaches 1e-2 at
    p=0.05, with a worst-case relative LER delta of 6.7% on cells with
    LER >= 1e-3 (docs/bp_sensitivity.md). rel=0.15 (~2x that worst case,
    allowing the archive's unknown third implementation the same step)
    catches real regressions without failing on measured sensitivity.
    BP+OSD cells (deterministic given syndrome + LLR order) use pure
    binomial bars and match with no slack.
    """
    var = p_ref * (1 - p_ref) / n_ref + p_got * (1 - p_got) / n_got
    return sigmas * np.sqrt(max(var, 1e-12)) + 2.0 / min(n_ref, n_got) + rel * p_ref


WORKLOADS = {
    "bp+osd0": dict(
        ref=BPOSD_REF, ref_trials=BPOSD_REF_TRIALS, grid=P_GRID,
        bp=dict(max_iter=50), osd=OSDConfig(order=0), channel="code-capacity",
        rel=0.0,
    ),
    "bp-only": dict(
        ref=BP_REF, ref_trials=BP_REF_TRIALS, grid=P_GRID,
        bp=dict(max_iter=50), osd=None, channel="code-capacity", rel=0.15,
    ),
    "doubled+osde7": dict(
        ref=DOUBLED_REF, ref_trials=DOUBLED_REF_TRIALS, grid=GRID_B,
        bp=dict(max_iter=200), osd=OSDConfig(order=7), channel="doubled",
        rel=0.0,
    ),
    "cc+osde7-200": dict(
        ref=CC_BPOSD_REF, ref_trials=CC_BPOSD_REF_TRIALS, grid=GRID_B,
        bp=dict(max_iter=200), osd=OSDConfig(order=7), channel="code-capacity",
        rel=0.0,
    ),
    "rework+osde7": dict(
        ref=REWORK_REF, ref_trials=REWORK_REF_TRIALS, grid=REWORK_GRID,
        # BP *failure* rates are implementation-sensitive (see bars());
        # at these p most failures route through OSD, whose output is
        # deterministic given the syndrome — a small relative slack covers
        # the residual BP-convergence sensitivity
        bp=dict(max_iter=50), osd=OSDConfig(order=7), channel="code-capacity",
        rel=0.05,
    ),
    "phenomenological": dict(
        ref=PH_REF, ref_trials=PH_REF_TRIALS, grid=P_GRID,
        bp=dict(max_iter=50), osd=None, channel="phenomenological", rel=0.0,
    ),
    "rework-contested": dict(
        ref=REWORK_CONTESTED_REF, ref_trials=REWORK_REF_TRIALS,
        grid=REWORK_GRID, bp=dict(max_iter=50), osd=OSDConfig(order=7),
        channel="code-capacity", rel=0.05,
    ),
    "notebooks-bp": dict(
        ref=NB_BP_REF, ref_trials=NB_REF_TRIALS, grid=P_GRID,
        bp=dict(max_iter=50), osd=None, channel="code-capacity",
        rel=0.15, metric="ler_notebook",  # BP failure rates are
        # implementation-sensitive — same slack rationale as bp-only
    ),
    "notebooks-bposd": dict(
        ref=NB_BPOSD_REF, ref_trials=NB_REF_TRIALS, grid=P_GRID,
        bp=dict(max_iter=50), osd=OSDConfig(order=0),
        channel="code-capacity", rel=0.0,
    ),
}


# (workload, code, grid_idx) cells allowed to pass while strictly below the
# archive WITHOUT an oracle recheck (OSD-e workloads, where a per-sample
# numpy oracle realization is impractical). Currently empty: no archived
# validation run has produced a BETTER cell on an OSD workload.
BETTER_ALLOWLIST: set[tuple[str, str, int]] = set()


def oracle_recheck_bp(code, p, metric, bp_kwargs, trials, seed):
    """Independent numpy Monte-Carlo realization of one BP-only
    code-capacity cell: own sampler, the float64 dense oracle decoder
    (tests/oracles.py — reference formulation), own classification.

    Used to gate 'BETTER' cells (round-4 advisor): a cell where the engine
    is strictly below the archive passes only if this independent pipeline
    reproduces the engine's LER within bars — so an undercounting bug
    (broken classification, too-easy sampler) cannot masquerade as a
    quality win.
    """
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    from oracles import bp_sum_product

    H = np.asarray(code.Hx) % 2
    L = np.asarray(code.Lx) % 2
    n = H.shape[1]
    prior = float(np.log((1 - p) / p))
    rng = np.random.default_rng(seed)
    faults = resid_log = log_or = 0
    for _ in range(trials):
        e = (rng.random(n) < p).astype(np.int8)
        s = (H @ e) % 2
        hard, conv, _, _ = bp_sum_product(H, s, prior, **bp_kwargs)
        residual = (hard.astype(np.int64) ^ e.astype(np.int64))
        lres = bool(((L @ residual) % 2).any())
        faults += int(not conv)
        resid_log += int(lres)
        log_or += int((not conv) or lres)
    if metric == "ler_notebook":
        return (faults + resid_log) / trials
    return log_or / trials


def run(trials, batch_size, out_dir, codes, workloads=None):
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    fails = 0
    for workload, w in WORKLOADS.items():
        if workloads and workload not in workloads:
            continue
        if workloads is None and workload == "rework-contested":
            continue  # subset of rework+osde7 — only run when asked (100k)
        for code_name in codes:
            if code_name not in w["ref"]:
                continue
            eng = MonteCarloEngine(
                get_code(code_name),
                EngineConfig(
                    bp=BPConfig(**w["bp"]),
                    osd=w["osd"],
                    channel=w["channel"],
                    batch_size=batch_size,
                ),
            )
            metric = w.get("metric", "ler")
            for idx, ref_ler in w["ref"][code_name].items():
                p = float(w["grid"][idx])
                d = counters_to_dict(eng.run_rate(p, trials=trials, seed=100 + idx))
                got = d[metric]
                tol = bars(ref_ler, w["ref_trials"], got, trials, rel=w["rel"])
                ok = abs(got - ref_ler) <= tol
                # Convergence-sensitive (rel>0) workloads guard against
                # REGRESSIONS: an archive pins one implementation's failure
                # rate, and a cell where ours fails strictly LESS often is a
                # quality difference, not an error (the [[288]] CC-50k cells
                # sit 1.4-3x above ours; our own f32/f64/reference-form
                # implementations agree to <=6.7% there — bp_sensitivity).
                # Round-4 advisor: accepting ANY got<ref makes the gate
                # one-sided (an undercounting bug would read as 'better'),
                # so a BETTER cell must now be CONFIRMED by an independent
                # oracle realization (BP-only cells) or an explicit
                # allowlist entry; unconfirmed cells count as failures.
                better = (not ok) and w["rel"] > 0 and got < ref_ler
                if better:
                    if w["osd"] is None and w["channel"] == "code-capacity":
                        n_check = min(2000, trials)
                        oracle = oracle_recheck_bp(
                            get_code(code_name), p, metric, w["bp"],
                            n_check, seed=7_000 + idx,
                        )
                        o_tol = bars(
                            oracle, n_check, got, trials, rel=w["rel"]
                        )
                        confirmed = abs(oracle - got) <= o_tol
                        print(
                            f"  better-cell oracle recheck: oracle={oracle:.5g}"
                            f" ({n_check} trials) got={got:.5g} tol={o_tol:.4f}"
                            f" -> {'CONFIRMED' if confirmed else 'UNCONFIRMED'}",
                            flush=True,
                        )
                        better = confirmed
                    else:
                        better = (workload, code_name, idx) in BETTER_ALLOWLIST
                fails += 0 if (ok or better) else 1
                status = "OK" if ok else ("BETTER" if better else "MISMATCH")
                rows.append(
                    dict(workload=workload, code=code_name, p=p, ref=ref_ler,
                         got=got, tol=tol, ok=bool(ok), better=bool(better),
                         trials=trials)
                )
                print(
                    f"{workload:14s} {code_name:16s} p={p:.5f} ref={ref_ler:.5g} "
                    f"got={got:.5g} tol={tol:.4f} {status}",
                    flush=True,
                )

    (out / "validation.json").write_text(json.dumps(rows, indent=2))
    lines = [
        "# LER validation vs reference archives", "",
        f"trials per cell: {rows[0]['trials']}", "",
        "| workload | code | p | reference | ours | tol | ok |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        mark = "✓" if r["ok"] else ("✓ (better)" if r.get("better") else "✗")
        lines.append(
            f"| {r['workload']} | {r['code']} | {r['p']:.5f} | {r['ref']:.5g} "
            f"| {r['got']:.5g} | {r['tol']:.4f} | {mark} |"
        )
    lines.append("")
    n_ok = sum(r["ok"] for r in rows)
    n_better = sum(1 for r in rows if r.get("better"))
    summary = f"**{n_ok}/{len(rows)} cells within bars**"
    if n_better:
        summary += f" (+{n_better} strictly better than the archive)"
    lines.append(summary)
    (out / "validation.md").write_text("\n".join(lines))
    print(f"\n{sum(r['ok'] for r in rows)}/{len(rows)} cells OK -> {out}/validation.md")
    return fails


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=10_000)
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--out", default="results/validation")
    ap.add_argument("--codes", nargs="+", default=list(BPOSD_REF))
    ap.add_argument("--workloads", nargs="+", default=None,
                    help=f"subset of {list(WORKLOADS)}; default all")
    a = ap.parse_args()
    raise SystemExit(
        min(run(a.trials, a.batch_size, a.out, a.codes, a.workloads), 1)
    )
