"""GPU smoke test: drive the decoding engine's main path once on the card.

    python chip_smoke.py          # phases a-e on one GPU
    python chip_smoke.py --four   # phase f only: 4-GPU mesh vs 1-GPU mesh

Phases (one process, one line of output each):

  a. device and card: fail unless JAX's first device is a GPU; print its
     kind, the device count, and the card's name and power limit;
  b. BP at full width: [[144,12,12]] Hx, sum-product BP(50), p=0.01,
     B=262144 lanes, on the XLA path and on the GPU kernel
     (ops/bp_triton.py); both compared with the float64 oracle
     (tests/oracles.py) on the first 2048 lanes and with each other on all
     lanes, with the compiled programs' memory analysis and wall times;
  c. code-capacity engine: MonteCarloEngine on [[144,12,12]] with the
     study preset's decoder (BP(50)+OSD-0) at p in {0.0268, 0.0501}; its
     counters against the same engine on a CPU mesh at the same seed
     (counter-mode sampling makes both decode the same errors), with the
     XLA BP path (the preset's) and with the kernel, and its LER against
     BASELINE.md's BP+OSD-0 archive;
  d. circuit level: the complete-bposd preset on [[72,12,6]] at p=0.003
     through the CLI, against the 10k-trial archive in results/circuit_ler;
  e. space-time: the space-time preset on [[72,12,6]] through the CLI.

Every phase raises on failure. The last line of standard output is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
CODE_144 = "[[144, 12, 12]]"
CODE_72 = "[[72, 12, 6]]"

# phase b
BP_BATCH = 262144
BP_P = 0.01
BP_ITERS = 50
ORACLE_LANES = 2048
# A lane on which BP oscillates without settling is chaotic: any rounding
# difference moves the iteration at which it happens to reproduce its
# syndrome. Reduction order and transcendentals (tanh, atanh) differ between
# float32 on the GPU, float32 on the CPU and the float64 oracle, and between
# XLA and the kernel, so such lanes disagree. Allowed: 0.1% of the lanes
# compared for the decision (hard decision or converged flag), and 0.25%
# for the iteration count (measured on an H100 at p=0.01: about 0.15% of
# lanes end at another iteration than float64 does, for XLA and the kernel
# alike).
LANE_TOL = 1e-3
ITER_TOL = 2.5e-3

# phase c
ENGINE_BATCH = 65536
ENGINE_TRIALS = 65536
ENGINE_RATES = (0.0268, 0.0501)
# BASELINE.md section 1, [[144,12,12]] row: BP(50)+OSD-0 LER, 1000 trials
# (the study preset's decoder); gated at 4 sigma
ARCHIVE_BPOSD = {0.0268: 0.003, 0.0501: 0.048}
ARCHIVE_BPOSD_TRIALS = 1000
# BASELINE.md section 2, [[144,12,12]] row: BP-only LER, 50 000 trials.
# Reported, not gated: this implementation's BP-only rate sits well below
# that archive at both rates (already at 10k trials in results/validation*),
# an open discrepancy recorded in PERF.md
ARCHIVE_BP_ONLY = {0.0268: 1.306e-02, 0.0501: 0.09014}
ARCHIVE_BP_ONLY_TRIALS = 50_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """Card name and power limit, read by a child that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def binomial_agree(k1, n1, rate2, n2, sigmas=4.0) -> tuple[bool, float]:
    """Two LER estimates agree within ``sigmas`` combined binomial bars."""
    r1 = k1 / n1
    pooled = max((k1 + rate2 * n2) / (n1 + n2), 1.0 / (n1 + n2))
    sd = math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    return abs(r1 - rate2) <= sigmas * sd, (r1 - rate2) / sd


# ---------------------------------------------------------------- phase a
def phase_device(expect_count: int | None = None):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}"
        )
    if expect_count is not None and len(devs) < expect_count:
        raise SystemExit(f"chip_smoke: needs {expect_count} GPUs, found {len(devs)}")
    card = card_line()
    log(f"[a] device kind={devs[0].device_kind} count={len(devs)} "
        f"card={card}")
    return devs, card


# ---------------------------------------------------------------- phase b
def _timed(fn, *args, reps=3):
    import jax

    out = jax.block_until_ready(fn(*args))  # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, times


def phase_bp(card: str, batch: int = BP_BATCH, oracle_lanes: int = ORACLE_LANES,
             interpret: bool = False) -> None:
    import jax
    import jax.numpy as jnp

    from qldpc_jax.codes import get_code
    from qldpc_jax.decoders import BPConfig, BPDecoder

    sys.path.insert(0, str(ROOT / "tests"))
    from oracles import bp_sum_product

    H = get_code(CODE_144).Hx
    m, n = H.shape
    key = jax.random.key(2026)
    errors = jax.random.bernoulli(key, BP_P, (batch, n)).astype(jnp.int8)
    syn = (
        jnp.dot(errors.astype(jnp.int32), jnp.asarray(H.T, jnp.int32)) % 2
    ).astype(jnp.int8)
    prior = jnp.full((n,), math.log((1 - BP_P) / BP_P), jnp.float32)
    syn_np = np.asarray(syn)

    results = {}
    for name, cfg in (
        ("xla", BPConfig(max_iter=BP_ITERS, backend="xla", chunk_size=10)),
        ("kernel", BPConfig(max_iter=BP_ITERS, backend="pallas")),
    ):
        dec = BPDecoder(H, cfg, interpret=interpret)
        t0 = time.perf_counter()
        fn = jax.jit(dec.decode_fn).lower(syn, prior).compile()
        t_compile = time.perf_counter() - t0
        res, times = _timed(fn, syn, prior)
        hard = np.asarray(res.hard)
        conv = np.asarray(res.converged)
        iters = np.asarray(res.iterations)
        # convergence is a claim about the syndrome: check it on the host
        s_hat = (hard.astype(np.float32) @ H.T.astype(np.float32)) % 2
        bad = int((s_hat[conv] != syn_np[conv]).any(axis=1).sum())
        if bad:
            raise AssertionError(f"[b] {name}: {bad} converged lanes miss "
                                 "their syndrome")
        results[name] = (hard, conv, iters)
        log(f"[b] {name}: B={batch} converged={int(conv.sum())} "
            f"mean_iters={iters.mean():.4f} wall_s={[round(t, 6) for t in times]} "
            f"syndromes_per_s={batch / min(times):.1f} "
            f"compile_s={t_compile:.3f} card={card} "
            f"memory_analysis=({fn.memory_analysis()})")

    def disagree(a, b, lanes):
        ha, ca, ia = (x[:lanes] for x in a)
        hb, cb, ib = (x[:lanes] for x in b)
        return (int((ha != hb).any(axis=1).sum()), int((ca != cb).sum()),
                int((ia != ib).sum()))

    oracle = [bp_sum_product(H, syn_np[i], np.asarray(prior), max_iter=BP_ITERS)
              for i in range(oracle_lanes)]
    ref = (
        np.stack([o[0] for o in oracle]),
        np.array([o[1] for o in oracle]),
        np.array([o[3] for o in oracle]),
    )
    checks = [
        ("xla vs oracle", disagree(results["xla"], ref, oracle_lanes), oracle_lanes),
        ("kernel vs oracle", disagree(results["kernel"], ref, oracle_lanes), oracle_lanes),
        ("kernel vs xla", disagree(results["kernel"], results["xla"], batch), batch),
    ]
    for label, (dh, dc, di), lanes in checks:
        limit, ilimit = LANE_TOL * lanes, ITER_TOL * lanes
        log(f"[b] {label}: lanes={lanes} disagree hard={dh} converged={dc} "
            f"iterations={di} (limits {limit:.3g} and {ilimit:.3g}: float32 "
            "rounding on chaotic lanes)")
        if max(dh, dc) > limit or di > ilimit:
            raise AssertionError(f"[b] {label} disagrees beyond tolerance")


# ---------------------------------------------------------------- phase c
def _engine(mesh, batch, bp_backend="xla"):
    from qldpc_jax.experiments.configs import get_preset
    from qldpc_jax.experiments.runners import build_engine

    spec = get_preset("study").replace(batch_size=batch, bp_backend=bp_backend)
    return build_engine(spec, CODE_144, mesh=mesh)


def phase_engine(card: str, batch: int = ENGINE_BATCH,
                 trials: int = ENGINE_TRIALS, check_archive: bool = True,
                 backends=("xla", "pallas")):
    """The study engine on the GPU, with the XLA BP path (the preset's) and
    with the kernel, against the preset's engine on the CPU."""
    import jax

    from qldpc_jax.mc import counters_to_dict
    from qldpc_jax.parallel import make_mesh

    engines = {b: _engine(make_mesh(n_devices=1), batch, b) for b in backends}
    cpu = _engine(make_mesh(devices=jax.devices("cpu")[:1]), batch)
    keys = ("BPs_fault", "bp_converged", "residual_logicals",
            "BPs_miscorrected", "incorrectable", "degeneracy_count")
    # per counter: 0.1% of the trials (decisions on chaotic lanes, above)
    limit = LANE_TOL * trials
    for i, p in enumerate(ENGINE_RATES):
        t0 = time.perf_counter()
        cc = cpu.run_rate(p, trials, seed=i)
        t_cpu = time.perf_counter() - t0
        dc = counters_to_dict(cc)
        for name, eng in engines.items():
            t0 = time.perf_counter()
            eng.run_rate(p, trials, seed=i)
            t_first = time.perf_counter() - t0
            t0 = time.perf_counter()
            cg = eng.run_rate(p, trials, seed=i)
            t_gpu = time.perf_counter() - t0
            dg = counters_to_dict(cg)
            diffs = {k: dg[k] - dc[k] for k in keys}
            diffs["logical_errors"] = (int(cg.logical_errors)
                                       - int(cc.logical_errors))
            log(f"[c] p={p} bp={name}: gpu vs cpu counter diff={diffs} "
                f"(limit {limit:.3g} trials) trials={dg['trials']} "
                f"gpu_ler={dg['ler']:.6f} cpu_ler={dc['ler']:.6f} "
                f"gpu_wall_s={t_gpu:.4f} (first call {t_first:.4f}, with "
                f"compile) trials_per_s={trials / t_gpu:.1f} "
                f"cpu_wall_s={t_cpu:.4f} card={card}")
            if (dg["trials"] != trials
                    or max(abs(v) for v in diffs.values()) > limit):
                raise AssertionError(
                    f"[c] p={p} bp={name}: GPU and CPU counters disagree")
            if check_archive:
                ok, z = binomial_agree(int(cg.logical_errors), trials,
                                       ARCHIVE_BPOSD[p], ARCHIVE_BPOSD_TRIALS)
                bp_only = (int(cg.logical_errors) - int(cg.osd_and_logical)
                           + int(cg.bp_faults))
                _, z_bp = binomial_agree(bp_only, trials, ARCHIVE_BP_ONLY[p],
                                         ARCHIVE_BP_ONLY_TRIALS)
                log(f"[c] p={p} bp={name}: BP+OSD-0 LER {dg['ler']:.6f} vs "
                    f"archive {ARCHIVE_BPOSD[p]} (BASELINE.md sec. 1, 1000 "
                    f"trials): z={z:.2f} (limit 4 sigma); BP-only LER "
                    f"{bp_only / trials:.6f} vs {ARCHIVE_BP_ONLY[p]} (sec. 2, "
                    f"50k trials): z={z_bp:.2f} (reported, not gated)")
                if not ok:
                    raise AssertionError(f"[c] p={p}: LER outside 4 sigma")


# ------------------------------------------------------------- phases d, e
def _cli(preset: str, code: str, trials: int, rates, out: str) -> dict:
    from qldpc_jax.experiments.cli import main

    argv = ["run", preset, "--codes", code, "--trials", str(trials),
            "--out", out, "--no-checkpoint", "--quiet"]
    if rates:
        argv += ["--error-rates", *map(str, rates)]
    t0 = time.perf_counter()
    if main(argv) != 0:
        raise AssertionError(f"cli run {preset} failed")
    wall = time.perf_counter() - t0
    res = np.load(Path(out) / f"{preset}.npz", allow_pickle=True)["results"].item()
    res["_wall"] = wall
    return res


def phase_circuit(card: str, trials: int = 4096) -> None:
    p = 0.003
    with tempfile.TemporaryDirectory() as out:
        res = _cli("complete-bposd", CODE_72, trials, [p], out)
    d = res[CODE_72][p]
    if d["trials"] != trials:
        raise AssertionError(f"[d] ran {d['trials']} trials, asked {trials}")
    arch = np.load(ROOT / "results/circuit_ler/complete-bposd.npz",
                   allow_pickle=True)["results"].item()[CODE_72][p]
    k = round(d["ler"] * trials)
    ok, z = binomial_agree(k, trials, arch["ler"], arch["trials"])
    log(f"[d] complete-bposd {CODE_72} p={p}: trials={trials} "
        f"ler={d['ler']:.6f} archive={arch['ler']} ({arch['trials']} trials) "
        f"z={z:.2f} (limit 4 sigma) wall_s={res['_wall']:.3f} "
        f"(with compile) card={card}")
    if not ok:
        raise AssertionError("[d] circuit-level LER outside 4 sigma")


def phase_spacetime(card: str, trials: int = 1024) -> None:
    with tempfile.TemporaryDirectory() as out:
        res = _cli("space-time", CODE_72, trials, None, out)
    rows = res[CODE_72]
    for p, d in sorted(rows.items()):
        if d["trials"] != trials or not 0.0 <= d["ler"] <= 1.0:
            raise AssertionError(f"[e] p={p}: bad result {d['trials']} {d['ler']}")
    lers = [rows[p]["ler"] for p in sorted(rows)]
    log(f"[e] space-time {CODE_72}: trials={trials} per rate, "
        f"ler by p={dict(zip(sorted(rows), lers))} "
        f"wall_s={res['_wall']:.3f} (with compile) card={card}")
    if lers[-1] < lers[0]:
        raise AssertionError("[e] LER does not grow with p")


# ---------------------------------------------------------------- phase f
def phase_four(card: str, batch: int = ENGINE_BATCH,
               trials: int = ENGINE_TRIALS, backends=("xla", "pallas")) -> None:
    """Phase c's engine on a 4-GPU mesh against the same engine on one GPU
    (counter-mode sampling makes the counters independent of the mesh),
    then a rate-sharded sweep on a (rate=2, mc=2) mesh against per-rate
    runs on one GPU."""
    from qldpc_jax.mc import counters_to_dict
    from qldpc_jax.parallel import make_mesh

    for backend in backends:
        one = _engine(make_mesh(n_devices=1), batch, backend)
        four = _engine(make_mesh(n_devices=4), batch, backend)
        for i, p in enumerate(ENGINE_RATES):
            c1 = counters_to_dict(one.run_rate(p, trials, seed=i))
            four.run_rate(p, trials, seed=i)  # compile + warm up
            t0 = time.perf_counter()
            c4 = counters_to_dict(four.run_rate(p, trials, seed=i))
            t4 = time.perf_counter() - t0
            t0 = time.perf_counter()
            one.run_rate(p, trials, seed=i)
            t1 = time.perf_counter() - t0
            same = all(
                np.array_equal(np.asarray(c1[k]), np.asarray(c4[k])) for k in c1
            )
            log(f"[f] p={p} bp={backend}: 4-GPU mesh vs 1-GPU counters "
                f"identical={same} trials={c4['trials']} ler={c4['ler']:.6f} "
                f"wall_s 1gpu={t1:.4f} 4gpu={t4:.4f} card={card}")
            if not same:
                raise AssertionError(
                    f"[f] p={p} bp={backend}: mesh shape changed the counters")
    rated = _engine(make_mesh(n_devices=4, rate_shards=2), batch // 2)
    seq = _engine(make_mesh(n_devices=1), batch // 2)
    got = rated.run_rates_sharded(list(ENGINE_RATES), trials, seed=0)
    for i, (p, c) in enumerate(zip(ENGINE_RATES, got)):
        ref = counters_to_dict(seq.run_rate(p, trials, seed=i))
        d = counters_to_dict(c)
        same = all(np.array_equal(np.asarray(d[k]), np.asarray(ref[k])) for k in d)
        log(f"[f] run_rates_sharded rate_shards=2 p={p}: identical to "
            f"run_rate on 1 GPU={same} ler={d['ler']:.6f}")
        if not same:
            raise AssertionError("[f] rate-sharded sweep changed the counters")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU mesh phase and its comparison")
    args = ap.parse_args(argv)

    count = 4 if args.four else 1
    devs, card = phase_device(expect_count=count)
    import qldpc_jax

    qldpc_jax.enable_compilation_cache()
    if args.four:
        phase_four(card)
    else:
        phase_bp(card)
        phase_engine(card)
        phase_circuit(card)
        phase_spacetime(card)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
