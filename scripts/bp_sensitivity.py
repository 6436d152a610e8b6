"""BP convergence sensitivity: f32 production decoder vs f64, same syndromes.

Purpose: the bp-only validation workload compares
our decoder against the reference's CC-50k archives with a rel=0.25 slack on
top of binomial bars, justified by the *argument* that BP failure rates are
implementation-sensitive. This script replaces the argument with data: it
runs the identical syndrome sets through the float32 production decoder and
a float64 decoder of the same algorithm, and measures

  * the per-sample convergence disagreement rate (samples where one
    precision converges within max_iter and the other does not),
  * the resulting bp-only LER delta per archive cell (|ler32 - ler64| and
    its ratio to the cell's LER).

It also measures the *formulation* axis: a float64 decoder implementing the
reference's exact update (dense masked (m, n), tanh row-product divided by
each entry with the 1e-15 floor — decoding/beliefPropagation.py:110-126)
runs the same syndromes, quantifying how far the reference's own math sits
from ours at equal precision. The max observed |delta|/ler across both
axes, with margin, is the derived tolerance for `validate_baseline.py`'s
bp-only/notebooks-bp workloads (documented in docs/bp_sensitivity.md).
Reference cells: BASELINE.md §2 grid indices 2..7.

Usage: python scripts/bp_sensitivity.py [--trials 50000] [--cpu]
       [--codes "[[72, 12, 6]]" ...] [--out results/bp_sensitivity.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--codes", nargs="+", default=None)
    ap.add_argument("--out", default="results/bp_sensitivity.json")
    args = ap.parse_args()

    import qldpc_jax

    qldpc_jax.enable_compilation_cache()
    import jax

    jax.config.update("jax_enable_x64", True)  # the f64 axis is the point
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from qldpc_jax.codes import get_code
    from qldpc_jax.decoders import BPConfig, BPDecoder

    P_GRID = np.logspace(-3.2, -1.3, 8)
    CLIP = 0.9999999

    def make_ref64(H):
        """Batched f64 decoder with the REFERENCE's update formulation
        (product-by-division on the dense mask, per-sample freeze-on-
        convergence — output-equivalent to the early-exit loop)."""
        Hf = jnp.asarray(H, jnp.float64)
        mask = Hf != 0

        @jax.jit
        def run(syn, prior):
            B = syn.shape[0]
            ssign = (1.0 - 2.0 * syn.astype(jnp.float64))[:, :, None]
            pr = jnp.broadcast_to(prior.astype(jnp.float64), (B, Hf.shape[1]))
            Q0 = jnp.where(mask[None], pr[:, None, :], 0.0)

            def step(carry, _):
                Q, values, conv = carry
                t = jnp.where(mask[None], jnp.tanh(Q * 0.5), 1.0)
                row_prod = jnp.prod(t, axis=2, keepdims=True)
                t_safe = jnp.where(jnp.abs(t) < 1e-15, 1e-15, t)
                others = row_prod / t_safe
                R = jnp.where(
                    mask[None],
                    2.0 * jnp.arctanh(jnp.clip(others * ssign, -CLIP, CLIP)),
                    0.0,
                )
                vals_new = R.sum(axis=1) + pr
                Qn = jnp.where(mask[None], vals_new[:, None, :] - R, 0.0)
                hard = (vals_new < 0).astype(jnp.int8)
                s_hat = jnp.mod(hard.astype(jnp.float64) @ Hf.T, 2.0)
                match = jnp.all(s_hat == syn.astype(jnp.float64), axis=1)
                values = jnp.where(conv[:, None], values, vals_new)
                Q = jnp.where(conv[:, None, None], Q, Qn)
                conv = conv | match
                return (Q, values, conv), None

            conv0 = jnp.zeros((B,), bool)
            state = (Q0, pr, conv0, jnp.int32(0))

            def cond(s):
                return (s[3] < 50) & ~jnp.all(s[2])

            def body(s):
                (Q, values, conv), _ = jax.lax.scan(
                    step, s[:3], None, length=5
                )
                return (Q, values, conv, s[3] + 5)

            Q, values, conv, _ = jax.lax.while_loop(cond, body, state)
            return (values < 0).astype(jnp.int8), conv, values

        return run
    codes = args.codes or [
        "[[72, 12, 6]]", "[[90, 8, 10]]", "[[108, 8, 10]]",
        "[[144, 12, 12]]", "[[288, 12, 18]]",
    ]

    rows = []
    for code_name in codes:
        code = get_code(code_name)
        H, Lx, n = code.Hx, code.Lx, code.n
        # f64 decoding runs on CPU regardless of the main backend; the f32
        # decoder runs wherever the session's backend is
        cpu = jax.devices("cpu")[0]
        dec32 = BPDecoder(H, BPConfig(max_iter=50, dtype="float32"))
        dec64 = BPDecoder(H, BPConfig(max_iter=50, dtype="float64"))
        with jax.default_device(cpu):
            ref64 = make_ref64(H)
        Hf = np.asarray(H, np.float64)
        Lf = np.asarray(Lx, np.float64)
        # the dense (B, m, n) reference-formulation state bounds the chunk
        ref_chunk = max(64, min(args.batch, int(2.5e8 // (H.size * 8))))

        for idx in range(2, 8):
            p = float(P_GRID[idx])
            rng = np.random.default_rng(7_000 + idx)
            prior = float(np.log((1 - p) / p))
            acc = {k: 0 for k in (
                "dis_32_64", "dis_64_ref", "dis_32_ref",
                "c32", "c64", "cref", "lg32", "lg64", "lgref",
            )}
            done = 0
            while done < args.trials:
                B = min(ref_chunk, args.trials - done)
                errors = (rng.random((B, n)) < p).astype(np.int8)
                syn = ((errors @ Hf.T) % 2).astype(np.int8)
                pv = np.full((n,), prior, np.float32)
                r32 = dec32(jnp.asarray(syn), jnp.asarray(pv))
                with jax.default_device(cpu):
                    r64 = dec64(
                        jnp.asarray(syn), jnp.asarray(pv, jnp.float64)
                    )
                    hard_r, conv_r, _ = ref64(
                        jnp.asarray(syn), jnp.asarray(pv, jnp.float64)
                    )
                out = {}
                for tag, conv, hard in (
                    ("32", r32.converged, r32.hard),
                    ("64", r64.converged, r64.hard),
                    ("ref", conv_r, hard_r),
                ):
                    conv = np.asarray(conv)
                    hard = np.asarray(hard)
                    resid = (hard.astype(np.int64) + errors) % 2
                    logical = ((resid @ Lf.T) % 2).any(axis=1) | ~conv
                    out[tag] = (conv, logical)
                acc["dis_32_64"] += int((out["32"][0] != out["64"][0]).sum())
                acc["dis_64_ref"] += int((out["64"][0] != out["ref"][0]).sum())
                acc["dis_32_ref"] += int((out["32"][0] != out["ref"][0]).sum())
                for tag in ("32", "64", "ref"):
                    acc["c" + ("ref" if tag == "ref" else tag)] += int(
                        out[tag][0].sum()
                    )
                    acc["lg" + ("ref" if tag == "ref" else tag)] += int(
                        out[tag][1].sum()
                    )
                done += B
            t = args.trials
            ler32, ler64, lerref = acc["lg32"] / t, acc["lg64"] / t, acc["lgref"] / t
            base = max(lerref, 1e-12)
            rows.append(dict(
                code=code_name, p=p, idx=idx, trials=t,
                conv32=acc["c32"] / t, conv64=acc["c64"] / t,
                convref=acc["cref"] / t,
                dis_32_64=acc["dis_32_64"] / t,
                dis_64_ref=acc["dis_64_ref"] / t,
                dis_32_ref=acc["dis_32_ref"] / t,
                ler32=ler32, ler64=ler64, lerref=lerref,
                ratio_prec=abs(ler32 - ler64) / max(ler64, 1e-12),
                ratio_form=abs(ler32 - lerref) / base,
            ))
            print(
                f"{code_name:16s} p={p:.5f} conv32={acc['c32']/t:.4f} "
                f"convref={acc['cref']/t:.4f} "
                f"dis(32,64)={acc['dis_32_64']/t:.2e} "
                f"dis(32,ref)={acc['dis_32_ref']/t:.2e} "
                f"ler32={ler32:.5g} lerref={lerref:.5g} "
                f"ratio_form={rows[-1]['ratio_form']:.3f}",
                flush=True,
            )

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    wp = max(rows, key=lambda r: r["ratio_prec"])
    wf = max(rows, key=lambda r: r["ratio_form"])
    print(f"\nmax precision ratio |ler32-ler64|/ler64 = "
          f"{wp['ratio_prec']:.3f} ({wp['code']} p={wp['p']:.5f})")
    print(f"max formulation ratio |ler32-lerref|/lerref = "
          f"{wf['ratio_form']:.3f} ({wf['code']} p={wf['p']:.5f})")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
