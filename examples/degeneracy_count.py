"""BP vs BP+OSD-0 comparison (the degeneracyCount notebook, as a sweep).

Runs both decoders over the full code list at one error rate and prints the
LER / degeneracy comparison table the notebook plots.
"""

import numpy as np

from qldpc_jax.codes import BB_CODE_NAMES, get_code
from qldpc_jax.decoders import BPConfig
from qldpc_jax.decoders.osd import OSDConfig
from qldpc_jax.mc import EngineConfig, MonteCarloEngine, counters_to_dict


def main(trials=2000, p=0.050119):
    print(f"p = {p}, trials = {trials}")
    print(f"{'code':18s} {'BP-only LER':>12s} {'BP+OSD LER':>12s} {'degenerate':>11s}")
    for name in BB_CODE_NAMES:
        code = get_code(name)
        row = [name]
        for osd in (None, OSDConfig(order=0)):
            eng = MonteCarloEngine(
                code,
                EngineConfig(bp=BPConfig(max_iter=50), osd=osd, batch_size=1000),
            )
            d = counters_to_dict(eng.run_rate(p, trials=trials, seed=7))
            row.append(d["ler"])
        row.append(d["degeneracies"])
        print(f"{row[0]:18s} {row[1]:12.4f} {row[2]:12.4f} {row[3]:11.4f}")


if __name__ == "__main__":
    main()
