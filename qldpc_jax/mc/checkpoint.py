"""Mid-sweep checkpointing of Monte-Carlo counters.

The reference only saves results at the very end of a sweep
(studies/study.py:105, rework/main.py:134) — an interrupted 50k-trial run
loses everything (SURVEY.md §5.4). Counters are trivially mergeable, so this
module persists the partial counter bundle per (code, error-rate) after every
batch and resumes from the last completed batch.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np

from qldpc_jax.mc.metrics import Counters, zeros_counters

__all__ = ["CheckpointManager"]


@dataclasses.dataclass
class CheckpointManager:
    directory: str | Path
    every_n_batches: int = 1

    def __post_init__(self):
        self.directory = Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, engine, p: float, seed: int) -> Path:
        safe = (
            f"{engine.code.name}_{engine.config.channel}_p{p:.8g}_s{seed}".replace(
                " ", ""
            ).replace("/", "-")
        )
        return self.directory / f"{safe}.npz"

    def load(self, engine, p: float, seed: int) -> tuple[Counters, int]:
        path = self._path(engine, p, seed)
        if not path.exists():
            return zeros_counters(), 0
        d = np.load(path, allow_pickle=True)
        meta = json.loads(str(d["meta"]))
        fields = {k: jax.numpy.asarray(d[k]) for k in Counters._fields}
        return Counters(**fields), int(meta["next_batch"])

    def save(self, engine, p: float, seed: int, counters: Counters, next_batch: int):
        path = self._path(engine, p, seed)
        arrays = {k: np.asarray(v) for k, v in counters._asdict().items()}
        np.savez(path, meta=json.dumps({"next_batch": next_batch}), **arrays)

    def run_rate(
        self, engine, p: float, trials: int, seed: int, alpha=None
    ) -> Counters:
        """Drive ``engine.run_rate`` with resume + periodic persistence."""
        total, start = self.load(engine, p, seed)

        def on_batch(b, n_batches, running):
            if (b + 1) % self.every_n_batches == 0 or b + 1 == n_batches:
                self.save(engine, p, seed, running, b + 1)

        return engine.run_rate(
            p, trials, seed=seed, start_batch=start, init=total,
            on_batch=on_batch, alpha=alpha,
        )
