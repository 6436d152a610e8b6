"""Outcome counters for Monte-Carlo decoding runs.

Preserves the reference's metric schema (SURVEY.md §5.5): the study-driver
counters (studies/study.py:97-101: ler, BPs_fault, BPs_miscorrected,
incorrectable, degeneracies) and the richer rework schema
(rework/main.py:119-129: logical/osd/degeneracies/
OSD_invocation_AND_logicalError/average_iterations/weights_found_*).

Design twist: everything is a fixed-shape integer array so that counters
psum cleanly across the device mesh and add across batches — the per-sample
weight *lists* the reference accumulates become fixed-size binned histograms
(SURVEY.md §7 hard part e).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Counters", "zeros_counters", "counters_to_dict", "HIST_BINS"]

# residual weights above the last bin are clipped into it; 128 covers every
# distance-scale weight of interest (reference plots use bins 0..30,
# rework/main.py:212-226)
HIST_BINS = 128


class Counters(NamedTuple):
    """psum-able outcome counters for one (code, error-rate) cell."""

    trials: jax.Array  # () int32
    logical_errors: jax.Array  # () int32 — any(L @ residual) [or BP fault in bp-only mode]
    residual_logicals: jax.Array  # () int32 — any(L @ residual), NOT or-ed
    # with BP faults; the notebooks archives count ler = faults + these
    # (degeneracyCount.ipynb cell 5 increments logical_error twice)
    bp_converged: jax.Array  # () int32
    bp_faults: jax.Array  # () int32 — BP did not reproduce the syndrome
    osd_invocations: jax.Array  # () int32
    miscorrected: jax.Array  # () int32 — logical & wt(error) < d//2
    incorrectable: jax.Array  # () int32 — logical & wt(error) >= d//2
    degeneracies: jax.Array  # () int32 — no logical & detection != error (study.py:77)
    valid_degenerate: jax.Array  # () int32 — + solution reproduces syndrome (rework/main.py:190)
    osd_and_logical: jax.Array  # () int32 — logical & BP failed (rework/main.py:179)
    osd_overflow: jax.Array  # () int32 — BP failures beyond the OSD capacity
    sum_iterations: jax.Array  # () int32 — sum of per-sample BP exit iterations
    hist_bp: jax.Array  # (HIST_BINS,) int32 — residual wt, benign mismatch, BP converged
    hist_osd: jax.Array  # (HIST_BINS,) int32 — benign mismatch, OSD path
    hist_bp_error: jax.Array  # (HIST_BINS,) int32 — logical error, BP path
    hist_osd_error: jax.Array  # (HIST_BINS,) int32 — logical error, OSD path

    def __add__(self, other: "Counters") -> "Counters":
        return jax.tree.map(lambda a, b: a + b, self, other)


def zeros_counters() -> Counters:
    z = jnp.zeros((), jnp.int32)
    h = jnp.zeros((HIST_BINS,), jnp.int32)
    return Counters(z, z, z, z, z, z, z, z, z, z, z, z, z, h, h, h, h)


def counters_to_dict(c: Counters) -> dict:
    """Host-side dict with derived rates (reference-schema names included)."""
    c = jax.tree.map(lambda x: np.asarray(x), c)
    t = max(int(c.trials), 1)
    return {
        "trials": int(c.trials),
        # rates (rework schema)
        "logical": int(c.logical_errors) / t,
        "osd": int(c.osd_invocations) / t,
        "degeneracies": int(c.valid_degenerate) / t,
        "OSD_invocation_AND_logicalError": int(c.osd_and_logical) / t,
        "average_iterations": int(c.sum_iterations) / t,
        # counts (study schema)
        "ler": int(c.logical_errors) / t,
        "residual_logicals": int(c.residual_logicals),
        # the notebooks archives' additive ler (degeneracyCount.ipynb:
        # a BP fault AND a logical residual both increment logical_error)
        "ler_notebook": (int(c.bp_faults) + int(c.residual_logicals)) / t,
        "BPs_fault": int(c.bp_faults),
        "BPs_miscorrected": int(c.miscorrected),
        "incorrectable": int(c.incorrectable),
        "degeneracy_count": int(c.degeneracies),
        "bp_converged": int(c.bp_converged),
        "osd_overflow": int(c.osd_overflow),
        # histograms (rework's weights_found_* lists, binned)
        "weights_found_BP": c.hist_bp,
        "weights_found_OSD": c.hist_osd,
        "weights_found_BP_error": c.hist_bp_error,
        "weights_found_OSD_error": c.hist_osd_error,
    }
