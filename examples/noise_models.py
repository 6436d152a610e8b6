"""Noise-model walkthrough (parity with the reference's noise_models.ipynb).

Samples each channel the framework supports, shows the induced syndrome
statistics, and decodes a batch under each — all on device.
"""

import jax
import numpy as np

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig, BPDecoder
from qldpc_jax.noise import (
    DEMData,
    code_capacity,
    doubled_channel,
    phenomenological,
    sample_space_time,
    space_time_matrix,
    space_time_prior_llr,
    syndrome_of,
    uniform_prior_llr,
)


def main():
    code = get_code("[[72, 12, 6]]")
    H = code.Hx
    p, B = 0.02, 1024
    key = jax.random.key(0)
    dec = BPDecoder(H, BPConfig(max_iter=50))
    prior = uniform_prior_llr(code.n, p)

    print(f"code {code.name}, p={p}, batch={B}\n")

    k1, k2, k3, k4 = jax.random.split(key, 4)

    e = code_capacity(k1, 0, p, B, code.n)
    s = syndrome_of(H, e)
    res = dec(s, prior)
    print(f"code capacity:       mean wt={float(e.sum(1).mean()):.2f} "
          f"syndrome wt={float(s.sum(1).mean()):.2f} "
          f"BP converged={float(res.converged.mean()):.3f}")

    e = doubled_channel(k2, 0, p, B, code.n)
    s = syndrome_of(H, e)
    res = dec(s, prior)
    print(f"doubled (e1^e2):     mean wt={float(e.sum(1).mean()):.2f} "
          f"BP converged={float(res.converged.mean()):.3f}")

    e, flips = phenomenological(k3, 0, p, B, code.n, H.shape[0])
    s = (syndrome_of(H, e) + flips) % 2
    res = dec(s, prior)
    print(f"phenomenological:    syndrome flips={float(flips.sum(1).mean()):.2f} "
          f"BP converged={float(res.converged.mean()):.3f}  (noisy syndromes "
          "often have no exact solution -> OSD territory)")

    T = 4
    Hst = space_time_matrix(H, T)
    est, det = sample_space_time(k4, H, p / 4, B, T)
    dec_st = BPDecoder(Hst, BPConfig(max_iter=50))
    res = dec_st(det, space_time_prior_llr(code.n, H.shape[0], T, p / 4))
    print(f"space-time (T={T}):    vars={Hst.shape[1]} checks={Hst.shape[0]} "
          f"BP converged={float(res.converged.mean()):.3f}")

    dem = DEMData(H=code.Hx, L=code.Lx, priors=np.full(code.n, p))
    _, det, obs = dem.sample(0, shots=B)
    res = dec(det.astype(np.int8), dem.llrs)
    print(f"DEM (circuit-level): mechanisms={dem.priors.size} "
          f"BP converged={float(res.converged.mean()):.3f}")


if __name__ == "__main__":
    main()
