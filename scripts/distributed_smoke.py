"""Multi-process distributed smoke test (SURVEY.md §5.8 / BASELINE 2-host).

Launches N local processes that ``jax.distributed.initialize`` against a
localhost coordinator (CPU backend, gloo collectives, a few virtual devices
per process), build the GLOBAL device mesh through the same
``parallel.mesh.make_mesh`` path a pod would use, and run a
``MonteCarloEngine.run_rate`` sweep sharded over all processes. Because the
engine's RNG is counter-mode over global sample ids (mesh-shape-invariant,
utils/rng.py), every process must report counters bit-identical to a
single-process run on the same number of virtual devices — which this
script also runs and compares against.

Usage:
    python scripts/distributed_smoke.py                 # orchestrate + compare
    python scripts/distributed_smoke.py --child I N P   # (internal) worker

The reference has no distributed execution of any kind; this exercises the
``init_distributed`` bring-up path end-to-end without pod hardware.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

DEVICES_PER_PROC = 4
TRIALS = 512
BATCH = 64
P_ERR = 0.05
SEED = 3


def _run_workload() -> dict:
    """The shared workload: steane code-capacity sweep at one rate."""
    from qldpc_jax.experiments.configs import get_preset  # noqa: F401 (cache)
    from qldpc_jax import enable_compilation_cache
    from qldpc_jax.codes import get_code
    from qldpc_jax.mc.engine import EngineConfig, MonteCarloEngine
    from qldpc_jax.mc.metrics import counters_to_dict
    from qldpc_jax.decoders.bp import BPConfig

    enable_compilation_cache()
    code = get_code("steane")
    eng = MonteCarloEngine(
        code,
        EngineConfig(
            batch_size=BATCH,
            bp=BPConfig(max_iter=20),
            channel="code-capacity",
        ),
    )
    counters = eng.run_rate(P_ERR, TRIALS, seed=SEED)
    d = counters_to_dict(counters)
    # JSON-serializable: histogram arrays -> lists, numpy scalars -> python
    return {
        k: v.tolist() if hasattr(v, "tolist") else v for k, v in d.items()
    }


def child(proc_id: int, n_procs: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from qldpc_jax.parallel.mesh import init_distributed

    init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=n_procs,
        process_id=proc_id,
    )
    n_dev = len(jax.devices())
    assert n_dev == n_procs * DEVICES_PER_PROC, (
        f"global mesh has {n_dev} devices, expected "
        f"{n_procs * DEVICES_PER_PROC}"
    )
    out = _run_workload()
    out["_global_devices"] = n_dev
    out["_process_id"] = proc_id
    print("SMOKE_RESULT " + json.dumps(out, sort_keys=True))
    jax.distributed.shutdown()


def single() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = _run_workload()
    print("SMOKE_RESULT " + json.dumps(out, sort_keys=True))


def _spawn(args: list[str], n_virtual: int) -> subprocess.Popen:
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_virtual}"
    ).strip()
    env.setdefault("PYTHONPATH", "")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        x for x in (repo, env["PYTHONPATH"]) if x
    )
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__)] + args,
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


def _collect(proc: subprocess.Popen, label: str, timeout: int) -> dict:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise SystemExit(f"{label} timed out\n--- stderr ---\n{err[-4000:]}")
    if proc.returncode:
        raise SystemExit(
            f"{label} exited rc={proc.returncode}\n--- stdout ---\n"
            f"{out[-2000:]}\n--- stderr ---\n{err[-4000:]}"
        )
    for line in out.splitlines():
        if line.startswith("SMOKE_RESULT "):
            return json.loads(line[len("SMOKE_RESULT "):])
    raise SystemExit(f"{label} printed no SMOKE_RESULT\n{out[-2000:]}")


def orchestrate(n_procs: int, timeout: int) -> int:
    import socket

    with socket.socket() as s:  # free localhost port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    workers = [
        _spawn(["--child", str(i), str(n_procs), str(port)], DEVICES_PER_PROC)
        for i in range(n_procs)
    ]
    ref = _spawn(["--single"], n_procs * DEVICES_PER_PROC)

    results = [
        _collect(w, f"worker {i}", timeout) for i, w in enumerate(workers)
    ]
    expect = _collect(ref, "single-process reference", timeout)

    ok = True
    for i, got in enumerate(results):
        assert got.pop("_global_devices") == n_procs * DEVICES_PER_PROC
        got.pop("_process_id")
        if got != expect:
            ok = False
            print(f"worker {i} MISMATCH:\n  got    {got}\n  expect {expect}")
    if ok:
        print(
            f"distributed smoke OK: {n_procs} processes x "
            f"{DEVICES_PER_PROC} devices, counters bit-identical to the "
            f"single-process {n_procs * DEVICES_PER_PROC}-device run"
        )
        print(json.dumps(expect, sort_keys=True))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", nargs=3, type=int, metavar=("ID", "N", "PORT"))
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=600)
    args = ap.parse_args()
    if args.child:
        child(args.child[0], args.child[1], args.child[2])
        return 0
    if args.single:
        single()
        return 0
    return orchestrate(args.procs, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
