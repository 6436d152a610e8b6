"""Export a circuit-level detector error model to the framework's DEM format.

Reproduces the reference's stim pipeline (studies/studyComplete.py:72-84):
build a BB-code memory experiment with a depolarizing noise model, extract
the detector error model, convert it to (H, L, priors) matrices, and save as
an npz bundle that ``qldpc_jax.noise.DEMData.load`` / ``DEMEngine`` consume.

Requires the optional external packages ``qldpc``, ``stim`` and ``ldpc``
(not part of this framework's core dependencies — decoding itself never
needs them; only this exporter does). Run on any host, copy the npz to the
machine that runs the sweep.

Usage:
  python scripts/export_dem.py --code "[[72, 12, 6]]" --p 0.003 --rounds 6 \
      --out dems/72_p003.npz
"""

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--code", required=True, help="BB code name, e.g. '[[72, 12, 6]]'")
    ap.add_argument("--p", type=float, required=True, help="depolarizing rate")
    ap.add_argument("--rounds", type=int, default=0, help="memory rounds (0 => distance)")
    ap.add_argument("--basis", default="z", choices=["x", "z"])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    try:
        from qldpc import circuits, codes  # external (reference's L0 dep)
        from qldpc.objects import Pauli
        from ldpc.ckt_noise.dem_matrices import detector_error_model_to_check_matrices
    except ImportError as e:
        print(
            f"error: optional dependency missing ({e.name}); this exporter "
            "needs qldpc+stim+ldpc installed. The decoding framework itself "
            "does not.",
            file=sys.stderr,
        )
        return 2

    import numpy as np

    from qldpc_jax.codes.registry import BB_CODE_DEFS
    from qldpc_jax.noise import DEMData

    if args.code not in BB_CODE_DEFS:
        print(f"unknown code {args.code}", file=sys.stderr)
        return 2
    l, m, a_terms, b_terms, distance = BB_CODE_DEFS[args.code]
    from sympy.abc import x, y

    poly = lambda terms: sum(x**i * y**j for i, j in terms)
    code = codes.BBCode({x: l, y: m}, poly(a_terms), poly(b_terms))

    rounds = args.rounds or distance
    noise = circuits.DepolarizingNoiseModel(args.p)
    circuit = circuits.get_memory_experiment(
        code=code,
        basis=Pauli.Z if args.basis == "z" else Pauli.X,
        num_rounds=rounds,
        noise_model=noise,
    )
    dem = circuit.detector_error_model(decompose_errors=False)
    mats = detector_error_model_to_check_matrices(
        dem, allow_undecomposed_hyperedges=True
    )
    bundle = DEMData(
        H=np.asarray(mats.check_matrix.todense()),
        L=np.asarray(mats.observables_matrix.todense()),
        priors=np.asarray(mats.priors),
    )
    bundle.save(args.out)
    print(
        f"{args.code} p={args.p} rounds={rounds}: H{bundle.H.shape} "
        f"L{bundle.L.shape} -> {args.out}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
