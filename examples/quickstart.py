"""Single-shot decoding walkthrough (the reference's main.py demo, batched).

Loads the Steane code, injects a 2-bit error, decodes with BP, falls back to
OSD-0 on failure, and prints every intermediate quantity.
"""

import os
import tempfile

import numpy as np

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder
from qldpc_jax.decoders.osd import OSDConfig, OSDDecoder
from qldpc_jax.utils.plotting import plot_matrix, plot_tanner_graph


def main():
    code = get_code("steane")
    H = code.Hx
    print(f"code: {code.name} [[{code.n}, {code.k}, {code.distance}]]")
    print("H =\n", H)

    # visualize the code (the reference demo's plotMatrix step, main.py:16,
    # plus the Tanner graph of drawUtils.py:4-35)
    out = os.environ.get("QLDPC_PLOT_DIR", tempfile.gettempdir())
    plot_matrix(H, os.path.join(out, "steane_matrix.png"), title="Steane Hx")
    plot_tanner_graph(H, os.path.join(out, "steane_tanner.png"))
    print(f"wrote steane_matrix.png / steane_tanner.png to {out}")

    p = 0.1
    prior = np.full(code.n, np.log((1 - p) / p), np.float32)

    error = np.zeros(code.n, np.int8)
    error[[1, 4]] = 1  # inject a 2-bit error
    syndrome = (error @ H.T) % 2
    print("error    =", error)
    print("syndrome =", syndrome)

    bp = BPDecoder(H, BPConfig(max_iter=50))
    res = bp(syndrome[None, :], prior)
    hard = np.asarray(res.hard[0])
    print("BP decision =", hard, "converged =", bool(res.converged[0]),
          "iterations =", int(res.iterations[0]))

    if not bool(res.converged[0]):
        osd = OSDDecoder(H, OSDConfig(order=0))
        hard = np.asarray(osd(syndrome[None, :], res.llrs, res.hard)[0])
        print("OSD decision =", hard)

    residual = (hard + error) % 2
    logical = (code.Lx @ residual) % 2
    print("residual =", residual)
    print("logical flip =", logical, "->", "LOGICAL ERROR" if logical.any() else "corrected OK")


if __name__ == "__main__":
    main()
