"""Multi-process distributed execution smoke (SURVEY.md §5.8).

Runs scripts/distributed_smoke.py: 2 processes x 4 virtual CPU devices
``jax.distributed.initialize`` against a localhost coordinator, build the
global mesh via parallel.mesh, run a MonteCarloEngine sweep sharded over
both processes, and compare counters bit-for-bit with a single-process
8-device run (exact because the RNG is counter-mode over global sample
ids). This is the only test that actually executes ``init_distributed``.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_counters_match_single_process():
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(REPO, "scripts", "distributed_smoke.py"),
            "--timeout",
            "240",
        ],
        capture_output=True,
        text=True,
        timeout=300,
        env={
            **os.environ,
            "PYTHONPATH": os.pathsep.join(
                x
                for x in (REPO, os.environ.get("PYTHONPATH", ""))
                if x
            ),
        },
    )
    assert proc.returncode == 0, (
        f"stdout:\n{proc.stdout[-3000:]}\nstderr:\n{proc.stderr[-3000:]}"
    )
    assert "distributed smoke OK" in proc.stdout
