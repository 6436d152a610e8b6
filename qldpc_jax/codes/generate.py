"""Generate the built-in code files: ``python -m qldpc_jax.codes.generate [dir]``.

Parity with generateCodeMatrices.py: writes each registered code to
``<dir>/<name>.npz`` in the reference-compatible format (Hx, Hz, Lx, Lz,
distance) — built entirely from this framework's own circulant constructor
and GF(2) logical-operator extraction.
"""

from __future__ import annotations

import sys
from pathlib import Path

from .registry import ALL_CODE_NAMES, get_code


def main(out_dir: str = "codes") -> None:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for name in ALL_CODE_NAMES:
        code = get_code(name)
        path = out / f"{name}.npz"
        code.save(path)
        print(
            f"{name}: n={code.n} k={code.k} d={code.distance} "
            f"Hx{code.Hx.shape} Lx{code.Lx.shape} -> {path}"
        )


if __name__ == "__main__":
    main(*sys.argv[1:2])
