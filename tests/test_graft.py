"""Driver contract: entry() compiles and runs; dryrun_multichip works."""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__  # noqa: E402


def test_entry_compiles_and_runs():
    fn, args = __graft_entry__.entry()
    res = jax.jit(fn)(*args)
    hard = np.asarray(res.hard)
    assert hard.shape == (256, 144)
    assert float(np.asarray(res.converged).mean()) > 0.9


def test_dryrun_multichip_8():
    __graft_entry__.dryrun_multichip(8)
