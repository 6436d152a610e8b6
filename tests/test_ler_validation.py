"""Statistical LER regression against the reference's archived curves.

Reproduction contract (SURVEY.md §6 / BASELINE.md): same decoder settings,
not the same RNG stream — assert agreement within generous binomial error
bars. Trial counts are kept small enough for CI; the full-scale campaign
lives in scripts/validate_baseline.py.
"""

import numpy as np
import pytest

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig
from qldpc_jax.decoders.osd import OSDConfig
from qldpc_jax.mc import EngineConfig, MonteCarloEngine, counters_to_dict


def run_ler(code_name, p, trials, osd_order=0, max_iter=50, channel="code-capacity"):
    eng = MonteCarloEngine(
        get_code(code_name),
        EngineConfig(
            bp=BPConfig(max_iter=max_iter),
            osd=None if osd_order is None else OSDConfig(order=osd_order),
            channel=channel,
            batch_size=512,
        ),
    )
    return counters_to_dict(eng.run_rate(p, trials=trials, seed=11))["ler"]


def binomial_bounds(p_ref, trials, sigmas=4.0, floor=0.01):
    err = sigmas * np.sqrt(max(p_ref * (1 - p_ref), 1e-9) / trials) + floor
    return max(p_ref - err, 0.0), min(p_ref + err, 1.0)


@pytest.mark.slow
class TestBaselineParity:
    def test_72_bposd_p05(self):
        """BASELINE §3: [[72,12,6]] BP+OSD-0 @ p=0.0501 -> 0.1629 (10k)."""
        trials = 2048
        ler = run_ler("[[72, 12, 6]]", 0.050119, trials)
        lo, hi = binomial_bounds(0.1629, trials)
        assert lo <= ler <= hi, f"ler={ler} outside [{lo:.4f}, {hi:.4f}]"

    def test_72_bp_only_p05(self):
        """BASELINE §2: [[72,12,6]] BP-only @ p=0.0501 -> 0.18312 (50k).

        BP-only LER here = P(BP fault OR logical residual), which reproduces
        the CC-50k archive. (The notebook archive's 0.2712 for the same
        nominal workload double-counts non-converged samples whose raw
        residual is also logical — degeneracyCount.ipynb cell 5 increments
        logical_error on the fault and again on the residual check; a
        reference bug we do not replicate.)"""
        trials = 2048
        ler = run_ler("[[72, 12, 6]]", 0.050119, trials, osd_order=None)
        lo, hi = binomial_bounds(0.18312, trials)
        assert lo <= ler <= hi, f"ler={ler} outside [{lo:.4f}, {hi:.4f}]"

    def test_90_bposd_p05(self):
        """BASELINE §3: [[90,8,10]] BP+OSD-0 @ p=0.0501 -> 0.0687 (10k)."""
        trials = 2048
        ler = run_ler("[[90, 8, 10]]", 0.050119, trials)
        lo, hi = binomial_bounds(0.0687, trials)
        assert lo <= ler <= hi, f"ler={ler} outside [{lo:.4f}, {hi:.4f}]"

    def test_144_bp_only_p0268(self):
        """BASELINE §2: [[144,12,12]] BP-only @ p=0.0268 -> 0.01306 (50k)."""
        trials = 4096
        ler = run_ler("[[144, 12, 12]]", 0.026827, trials, osd_order=None)
        lo, hi = binomial_bounds(0.01306, trials)
        assert lo <= ler <= hi, f"ler={ler} outside [{lo:.4f}, {hi:.4f}]"
