"""Experiment configuration: dataclasses + JSON round-trip + presets.

The reference hardcodes every sweep as module-level constants in each driver
(rework/main.py:8-50, paperResults_GPU.py:36-44; SURVEY.md §5.6). Here each
reference driver maps to a named preset of one config schema, overridable
from the CLI or JSON files.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from qldpc_jax.codes.registry import BB_CODE_NAMES

__all__ = ["ExperimentSpec", "PRESETS", "get_preset"]

# the canonical grid of studies/study.py:21
LOGSPACE_GRID = [float(p) for p in np.logspace(-3.2, -1.3, 8)]

# per-code grids of rework/main.py:8-39 (stop before the sub-threshold cliff)
REWORK_GRIDS = {
    "[[72, 12, 6]]": [0.1, 0.06, 0.05, 0.04, 0.03, 0.02, 0.01, 0.009],
    "[[90, 8, 10]]": [0.1, 0.06, 0.05, 0.04, 0.03, 0.02, 0.01],
    "[[108, 8, 10]]": [0.1, 0.06, 0.05, 0.04, 0.03, 0.02, 0.01],
    "[[144, 12, 12]]": [0.1, 0.06, 0.05, 0.04, 0.03, 0.02],
    "[[288, 12, 18]]": [0.1, 0.06, 0.05, 0.04],
}


@dataclasses.dataclass
class ExperimentSpec:
    """One sweep: codes x error rates x trials with a decoder configuration."""

    name: str = "study"
    codes: list = dataclasses.field(default_factory=lambda: list(BB_CODE_NAMES))
    error_rates: list | None = None  # None => per_code_rates or LOGSPACE_GRID
    per_code_rates: dict | None = None
    trials: int = 1000
    seed: int = 0
    batch_size: int = 1024

    # decoder
    bp_method: str = "sum-product"
    bp_max_iter: int = 50
    bp_chunk_size: int = 0
    bp_schedule: str = "flooding"  # "flooding" | "layered" (check-serial)
    bp_layers: int = 0  # layered: check groups per iteration; 0 = auto
    bp_backend: str = "xla"  # "xla" | "pallas" (GPU kernel, check-regular)
    osd_backend: str = "auto"  # "auto" | "lanes" | "vmap"
    osd_fraction: float = 1.0
    alpha: float = 1.0
    offset: float = 0.0  # offset min-sum (min-sum method only)
    damping: float = 1.0
    clip_llr: float | None = None
    estimate_alpha: bool = False  # Alvarado per-(code, p) alpha
    osd_order: int | None = 0  # None => BP-only
    osd_max_combinations: int | None = None

    # channel
    channel: str = "code-capacity"
    n_rounds: int = 0
    syndrome_flip_rate: float | None = None

    # sweep axis overrides
    max_iter_grid: list | None = None  # BP_per_Iteration-style axis
    osd_order_grid: list | None = None  # combined with max_iter_grid this is
    # the (bp_iter x osd_order) configuration grid of
    # rework/main_different_orders.py:44-49

    # io
    output_dir: str = "results"

    def rates_for(self, code_name: str) -> list:
        if self.per_code_rates is not None and code_name in self.per_code_rates:
            return self.per_code_rates[code_name]
        return self.error_rates if self.error_rates is not None else LOGSPACE_GRID

    # ---- JSON ----------------------------------------------------------------
    def to_json(self, path: str | Path | None = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    @classmethod
    def from_json(cls, src: str | Path) -> "ExperimentSpec":
        text = Path(src).read_text() if Path(str(src)).exists() else str(src)
        return cls(**json.loads(text))

    def replace(self, **kw) -> "ExperimentSpec":
        return dataclasses.replace(self, **kw)


PRESETS: dict[str, ExperimentSpec] = {
    # studies/study.py:20-24 — BP(50)+OSD-0, code capacity, 1000 trials
    "study": ExperimentSpec(name="study", trials=1000),
    # BP-only 50k-trial variant behind data/CC-50k-LERS-BP.npz
    "cc-50k": ExperimentSpec(name="cc-50k", trials=50_000, osd_order=None,
                             batch_size=4096),
    # notebooks/degeneracyCount.ipynb — BP vs BP+OSD at 10k trials
    "notebook-bp": ExperimentSpec(name="notebook-bp", trials=10_000, osd_order=None),
    "notebook-bposd": ExperimentSpec(name="notebook-bposd", trials=10_000),
    # paperResults.py:17-22 — doubled channel, BP(200)+OSD-0, 10k trials
    "paper": ExperimentSpec(
        name="paper", channel="doubled", trials=10_000, bp_max_iter=200,
        error_rates=[0.05, 0.04, 0.03, 0.02, 0.015, 0.01, 0.008, 0.007],
    ),
    # paperResults_GPU.py:36-44 — batched BP(150)+OSD-e(7), 10k trials
    "paper-gpu": ExperimentSpec(
        name="paper-gpu", channel="doubled", trials=10_000, bp_max_iter=150,
        osd_order=7, batch_size=4096,
        error_rates=[0.05, 0.04, 0.03, 0.02, 0.015, 0.01, 0.008, 0.007],
    ),
    # rework/main.py:43-50 — BP(100)+OSD-e(7), per-code grids, 10k trials
    "rework": ExperimentSpec(
        name="rework", trials=10_000, bp_max_iter=100, osd_order=7,
        per_code_rates=dict(REWORK_GRIDS),
    ),
    # rework/main_different_orders.py:44-49 — the (bp_iter x osd_order)
    # configuration grid {50,100} x {0,7} on the rework per-code rates
    "different-orders": ExperimentSpec(
        name="different-orders", trials=10_000,
        max_iter_grid=[50, 100], osd_order_grid=[0, 7],
        per_code_rates=dict(REWORK_GRIDS),
    ),
    # rework/Alvarado.py:69-155 — normalized min-sum with fitted alpha,
    # damping 0.7, clip 25, OSD-0 fallback
    "rework-minsum": ExperimentSpec(
        name="rework-minsum", trials=10_000, bp_method="min-sum",
        estimate_alpha=True, damping=0.7, clip_llr=25.0, osd_order=0,
        per_code_rates=dict(REWORK_GRIDS),
    ),
    # BP_per_Iteration.py:15-23 — sweep max_iter at p=0.01, 10k trials
    "bp-iteration": ExperimentSpec(
        name="bp-iteration", trials=10_000, error_rates=[0.01],
        max_iter_grid=[10, 20, 30, 40, 50, 60, 70, 80, 90],
    ),
    # spectrum.py:31-38 — 20k trials at p=0.005, degenerate-residual weights
    "spectrum": ExperimentSpec(
        name="spectrum", trials=20_000, error_rates=[0.005], batch_size=4096,
    ),
    # studies/study.py:58-60 phenomenological variant (PH-LERS archive)
    "phenomenological": ExperimentSpec(
        name="phenomenological", channel="phenomenological", trials=1000,
        codes=["[[72, 12, 6]]", "[[144, 12, 12]]", "[[288, 12, 18]]"],
    ),
    # studies/studyComplete.py — circuit-level memory experiments (the
    # reference ran a 2-trial stim smoke; this is the real sweep, BP-only
    # like the reference's decoder choice, rounds = distance)
    "complete": ExperimentSpec(
        name="complete", channel="circuit-level", trials=1000,
        bp_max_iter=100, osd_order=None, batch_size=1024,
    ),
    # recommended circuit-level config: BP alone barely converges on DEMs
    # (hyperedge degeneracy; ~14% at p=0.003 on [[72,12,6]]) — BP+OSD-0 via
    # the transform elimination decodes them properly (obs-err 0.0078 vs
    # 0.29 BP-only at p=0.001). BP(50): obs-err is flat in max_iter from 10
    # to 100 (OSD decodes from the LLR ordering, which saturates early —
    # results/dem_iters_study.json), so 50 is a quality-safe budget
    "complete-bposd": ExperimentSpec(
        name="complete-bposd", channel="circuit-level", trials=1000,
        bp_max_iter=50, osd_order=0, batch_size=1024,
        error_rates=[0.0005, 0.001, 0.002, 0.003],
    ),
    # studies/studyTT.py — space-time decoding, implemented correctly
    "space-time": ExperimentSpec(
        name="space-time", channel="space-time", trials=1000,
        bp_max_iter=100, batch_size=512,
        error_rates=[0.001, 0.002, 0.004, 0.008],
    ),
}


def get_preset(name: str) -> ExperimentSpec:
    import copy

    try:
        return copy.deepcopy(PRESETS[name])
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; known: {list(PRESETS)}") from None
