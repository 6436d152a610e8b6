"""Independent FORWARD Pauli-frame DEM oracle for tests.

``qldpc_jax.noise.circuit.circuit_to_dem`` derives fault signatures with a
single *backward* sensitivity pass (circuit.py:126-191). This module
re-derives them the opposite way — per elementary fault, inject a Pauli
frame at the fault location and propagate it FORWARD through the remaining
circuit, reading off which measurement records flip — so a bug in any
conjugation rule of the backward pass cannot be reproduced here by
construction (the update rules run in the opposite direction and are
written independently).

Forward frame semantics (standard stabilizer-frame simulation):
  CX(c,t): X_c -> X_c X_t  (fx[t] ^= fx[c]),  Z_t -> Z_c Z_t (fz[c] ^= fz[t])
  H(q):    X <-> Z
  M(q):    record flips iff an X frame is on q; frame survives
  MR(q):   record flips iff an X frame is on q; frame is destroyed
  R(q):    frame is destroyed

Vectorized over faults: all fault frames propagate simultaneously as rows
of (F, n_qubits) uint8 arrays, so the whole circuit is walked once.
"""

from __future__ import annotations

import numpy as np

_NOISE_TAGS = ("XE", "ZE", "DEP1", "DEP2")


def _enumerate_faults(ops):
    """Yield (op_index, weight, [(qubit, pauli), ...]) per elementary fault,
    pauli in {"X", "Z", "Y"}."""
    singles = ("X", "Z", "Y")
    for i, op in enumerate(ops):
        tag = op[0]
        if tag == "XE":
            yield i, op[1], [(op[2], "X")]
        elif tag == "ZE":
            yield i, op[1], [(op[2], "Z")]
        elif tag == "DEP1":
            p, q = op[1], op[2]
            for pauli in singles:
                yield i, p / 3.0, [(q, pauli)]
        elif tag == "DEP2":
            p, a, b = op[1], op[2], op[3]
            w = p / 15.0
            for pa in singles:
                yield i, w, [(a, pa)]
            for pb in singles:
                yield i, w, [(b, pb)]
            for pa in singles:
                for pb in singles:
                    yield i, w, [(a, pa), (b, pb)]


def forward_fault_table(circuit):
    """(weights (F,), det_flips (F, n_det) uint8, obs_flips (F, n_obs) uint8)
    for every elementary fault, in enumeration order."""
    faults = list(_enumerate_faults(circuit.ops))
    F = len(faults)
    nq = circuit.n_qubits
    n_rec = circuit.num_records

    # rows to activate, grouped by op index
    by_op: dict[int, list[tuple[int, list]]] = {}
    for row, (i, _w, paulis) in enumerate(faults):
        by_op.setdefault(i, []).append((row, paulis))

    fx = np.zeros((F, nq), np.uint8)
    fz = np.zeros((F, nq), np.uint8)
    rec_flip = np.zeros((F, n_rec), np.uint8)

    rec = 0
    for i, op in enumerate(circuit.ops):
        tag = op[0]
        if tag in _NOISE_TAGS:
            for row, paulis in by_op.get(i, ()):
                for q, pauli in paulis:
                    if pauli in ("X", "Y"):
                        fx[row, q] ^= 1
                    if pauli in ("Z", "Y"):
                        fz[row, q] ^= 1
        elif tag == "CX":
            c, t = op[1], op[2]
            fx[:, t] ^= fx[:, c]
            fz[:, c] ^= fz[:, t]
        elif tag == "H":
            q = op[1]
            tmp = fx[:, q].copy()
            fx[:, q] = fz[:, q]
            fz[:, q] = tmp
        elif tag == "M":
            rec_flip[:, rec] = fx[:, op[1]]
            rec += 1
        elif tag == "MR":
            rec_flip[:, rec] = fx[:, op[1]]
            rec += 1
            fx[:, op[1]] = 0
            fz[:, op[1]] = 0
        elif tag == "R":
            fx[:, op[1]] = 0
            fz[:, op[1]] = 0
        else:
            raise ValueError(f"unknown op {tag!r}")
    assert rec == n_rec

    n_det = len(circuit.detectors)
    n_obs = len(circuit.observables)
    det_inc = np.zeros((n_rec, n_det), np.uint8)
    for k, recs in enumerate(circuit.detectors):
        for j in recs:
            det_inc[j, k] ^= 1
    obs_inc = np.zeros((n_rec, n_obs), np.uint8)
    for k, recs in enumerate(circuit.observables):
        for j in recs:
            obs_inc[j, k] ^= 1

    det_flips = (rec_flip.astype(np.int32) @ det_inc.astype(np.int32)) % 2
    obs_flips = (rec_flip.astype(np.int32) @ obs_inc.astype(np.int32)) % 2
    weights = np.array([w for _i, w, _p in faults], np.float64)
    return weights, det_flips.astype(np.uint8), obs_flips.astype(np.uint8)


def forward_dem(circuit):
    """Merged DEM via forward simulation: dict ``signature_bitset -> prior``
    (bit k = detector k, bit n_det+k = observable k), XOR-convolving merged
    mechanisms exactly like circuit_to_dem."""
    n_det = len(circuit.detectors)
    weights, det_flips, obs_flips = forward_fault_table(circuit)
    mech: dict[int, float] = {}
    for w, dr, orow in zip(weights, det_flips, obs_flips):
        sig = 0
        for k in np.flatnonzero(dr):
            sig |= 1 << int(k)
        for k in np.flatnonzero(orow):
            sig |= 1 << (n_det + int(k))
        if sig == 0 or w <= 0.0:
            continue
        q = mech.get(sig, 0.0)
        mech[sig] = q * (1.0 - w) + w * (1.0 - q)
    return mech
