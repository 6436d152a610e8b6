"""Native circuit-level noise: memory-experiment circuits and exact DEMs.

The reference's circuit-level pipeline is external: ``qldpc`` builds a
memory-experiment circuit, stim extracts the detector error model, and
``ldpc.ckt_noise`` converts it to check matrices
(studies/studyComplete.py:72-84). None of those packages are core
dependencies here, so this module makes the pipeline self-contained:

  * :func:`memory_experiment` builds the standard CSS syndrome-extraction
    memory circuit (ancilla-per-check, CX fan-in, both stabilizer types
    measured every round, basis-appropriate boundary detectors) with a
    depolarizing circuit noise model — the same experiment family
    ``qldpc.circuits.get_memory_experiment`` + ``DepolarizingNoiseModel``
    produce (studies/studyComplete.py:72-78).
  * :func:`circuit_to_dem` derives the exact detector error model from the
    noisy Clifford circuit: every elementary fault location is a Pauli
    inserted at a known position; a single *backward sensitivity pass*
    computes, for each circuit position and qubit, the set of detectors and
    observables an X / Z frame there flips. Mechanisms with identical
    (detector, observable) signatures are merged with the XOR-convolution
    ``p <- p1(1-p2) + p2(1-p1)``, exactly as stim merges DEM error terms.

The result is a :class:`~qldpc_jax.noise.dem.DEMData` bundle that
``DEMEngine`` samples and decodes entirely on device — closing the
circuit-level loop (studyComplete.py:88-109) without stim.

Why backward sensitivities instead of per-fault forward simulation: with F
fault locations and G gates, forward propagation costs O(F*G); the backward
pass costs O(G) bitset updates total, after which each fault's signature is
a constant number of XORs. Conjugation rules used (all Clifford):

  CX(c,t):  X_c -> X_c X_t,  Z_t -> Z_c Z_t   (X_t, Z_c commute through)
  H(q):     X <-> Z
  M(q):     Z-basis measurement outcome flips iff an X frame is on q
  R / MR:   reset destroys the frame (faults before a reset cannot
            propagate through it)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from qldpc_jax.noise.dem import DEMData

__all__ = [
    "Circuit",
    "DepolarizingNoise",
    "ParametricDEM",
    "memory_experiment",
    "circuit_to_dem",
    "circuit_to_parametric_dem",
    "memory_experiment_dem",
    "parametric_memory_dem",
]


@dataclasses.dataclass(frozen=True)
class DepolarizingNoise:
    """Uniform depolarizing circuit noise (reference: DepolarizingNoiseModel(p),
    studies/studyComplete.py:72).

    Attributes:
      p: base physical error rate.
      after_clifford1 / after_clifford2: DEPOLARIZE1/2 strength after every
        1-/2-qubit Clifford gate (default ``p``).
      before_measure: classical-equivalent X flip before every measurement
        (default ``p``).
      after_reset: X flip after every reset (default ``p``).
    """

    p: float
    after_clifford1: float | None = None
    after_clifford2: float | None = None
    before_measure: float | None = None
    after_reset: float | None = None

    @property
    def p1(self) -> float:
        return self.p if self.after_clifford1 is None else self.after_clifford1

    @property
    def p2(self) -> float:
        return self.p if self.after_clifford2 is None else self.after_clifford2

    @property
    def pm(self) -> float:
        return self.p if self.before_measure is None else self.before_measure

    @property
    def pr(self) -> float:
        return self.p if self.after_reset is None else self.after_reset


@dataclasses.dataclass
class Circuit:
    """A Clifford circuit with interleaved Pauli-noise locations.

    ``ops`` entries (plain tuples, executed in order):
      ("R", q)            reset q to |0>
      ("H", q)            Hadamard
      ("CX", c, t)        controlled-X
      ("M", q)            Z-basis measurement (non-destructive), appends a record
      ("MR", q)           measure then reset, appends a record
      ("XE", p, q)        X error with probability p (fault location)
      ("ZE", p, q)        Z error with probability p
      ("DEP1", p, q)      single-qubit depolarizing (X/Y/Z each p/3)
      ("DEP2", p, a, b)   two-qubit depolarizing (15 non-identity pairs, p/15)

    ``detectors``: list of measurement-record index lists whose XOR is
    deterministically 0 in the noiseless circuit. ``observables``: record
    index lists whose XOR is the logical readout.
    """

    n_qubits: int
    ops: list = dataclasses.field(default_factory=list)
    detectors: list = dataclasses.field(default_factory=list)
    observables: list = dataclasses.field(default_factory=list)

    @property
    def num_records(self) -> int:
        return sum(1 for op in self.ops if op[0] in ("M", "MR"))


def _fault_signatures(circuit: Circuit, emit) -> None:
    """Backward Pauli-frame sensitivity pass.

    Walks ``circuit.ops`` in reverse maintaining, per qubit, the bitset of
    detectors+observables flipped by an X (``Sx``) or Z (``Sz``) frame at
    the current position; calls ``emit(signature_bitset, weight)`` once per
    elementary fault mechanism at each noise location (DEP1 -> 3 calls at
    weight p/3, DEP2 -> 15 at p/15, XE/ZE -> 1 at p)."""
    n_det = len(circuit.detectors)

    # per-record signature over (detectors | observables) bit positions
    record_sig = [0] * circuit.num_records
    for k, recs in enumerate(circuit.detectors):
        for j in recs:
            record_sig[j] ^= 1 << k
    for k, recs in enumerate(circuit.observables):
        for j in recs:
            record_sig[j] ^= 1 << (n_det + k)

    Sx = [0] * circuit.n_qubits
    Sz = [0] * circuit.n_qubits

    rec = circuit.num_records
    for op in reversed(circuit.ops):
        tag = op[0]
        if tag == "M":
            rec -= 1
            Sx[op[1]] ^= record_sig[rec]
        elif tag == "MR":
            rec -= 1
            Sx[op[1]] = record_sig[rec]
            Sz[op[1]] = 0
        elif tag == "R":
            Sx[op[1]] = 0
            Sz[op[1]] = 0
        elif tag == "H":
            q = op[1]
            Sx[q], Sz[q] = Sz[q], Sx[q]
        elif tag == "CX":
            c, t = op[1], op[2]
            Sx[c] ^= Sx[t]
            Sz[t] ^= Sz[c]
        elif tag == "XE":
            emit(Sx[op[2]], op[1])
        elif tag == "ZE":
            emit(Sz[op[2]], op[1])
        elif tag == "DEP1":
            p, q = op[1], op[2]
            emit(Sx[q], p / 3.0)
            emit(Sz[q], p / 3.0)
            emit(Sx[q] ^ Sz[q], p / 3.0)
        elif tag == "DEP2":
            p, a, b = op[1], op[2], op[3]
            sa = (Sx[a], Sz[a], Sx[a] ^ Sz[a])
            sb = (Sx[b], Sz[b], Sx[b] ^ Sz[b])
            w = p / 15.0
            for s in sa:
                emit(s, w)
            for s in sb:
                emit(s, w)
            for s1 in sa:
                for s2 in sb:
                    emit(s1 ^ s2, w)
        else:
            raise ValueError(f"unknown op {tag!r}")
    assert rec == 0, "record bookkeeping out of sync"


def _sigs_to_matrices(sigs, n_det: int, n_obs: int):
    """Unpack signature bitsets into dense (H, L) uint8 incidence matrices."""
    M = len(sigs)
    H = np.zeros((n_det, M), np.uint8)
    L = np.zeros((n_obs, M), np.uint8)
    for col, sig in enumerate(sigs):
        s = sig
        while s:
            lsb = s & -s
            bit = lsb.bit_length() - 1
            if bit < n_det:
                H[bit, col] = 1
            else:
                L[bit - n_det, col] = 1
            s ^= lsb
    return H, L


def circuit_to_dem(circuit: Circuit) -> DEMData:
    """Exact detector error model of a noisy Clifford circuit.

    Identical (detector, observable) signatures merge with XOR-convolution
    of probabilities; signatures that flip nothing are dropped (they are
    unobservable). Matches stim's
    ``detector_error_model(decompose_errors=False)`` semantics — hyperedges
    are kept (studyComplete.py:80-81).
    """
    mech: dict[int, float] = {}

    def emit(sig: int, p: float) -> None:
        if sig == 0 or p <= 0.0:
            return
        q = mech.get(sig, 0.0)
        mech[sig] = q * (1.0 - p) + p * (1.0 - q)

    _fault_signatures(circuit, emit)
    sigs = sorted(mech)  # deterministic column order
    H, L = _sigs_to_matrices(sigs, len(circuit.detectors), len(circuit.observables))
    return DEMData(H=H, L=L, priors=np.array([mech[s] for s in sigs], np.float64))


@dataclasses.dataclass(frozen=True)
class ParametricDEM:
    """A DEM whose priors are exact closed-form functions of a base rate p.

    When every noise-location strength in the circuit is a fixed multiple
    ``r*p`` of one physical rate (the uniform depolarizing model:
    r in {1, 1/3, 1/15}), the XOR-convolved prior of a merged mechanism with
    ``c_j`` elementary contributions at ratio ``r_j`` is exactly

        q(p) = (1 - prod_j (1 - 2 r_j p)^{c_j}) / 2.

    Storing (ratios, counts) instead of numeric priors makes the mechanism
    set, H and L *independent of p* — so one compiled decode program sweeps
    the whole error-rate grid with p as a traced scalar (no per-grid-point
    recompiles; cf. the reference rebuilding the stim DEM per p,
    studyComplete.py:70-81).

    Attributes:
      H, L: incidence matrices as in :class:`DEMData`.
      ratios: (R,) distinct elementary-fault ratios r_j.
      counts: (M, R) int32 — elementary contributions per mechanism/ratio.
    """

    H: np.ndarray
    L: np.ndarray
    ratios: np.ndarray
    counts: np.ndarray

    def priors_at(self, p: float) -> np.ndarray:
        lg = np.log1p(-2.0 * np.asarray(self.ratios, np.float64) * float(p))
        return 0.5 * (1.0 - np.exp(self.counts.astype(np.float64) @ lg))

    def at(self, p: float) -> DEMData:
        return DEMData(H=self.H, L=self.L, priors=self.priors_at(p))

    def save(self, path) -> None:
        np.savez(path, H=self.H, L=self.L, ratios=self.ratios, counts=self.counts)

    @classmethod
    def load(cls, path) -> "ParametricDEM":
        d = np.load(path)
        return cls(H=d["H"], L=d["L"], ratios=d["ratios"], counts=d["counts"])


def circuit_to_parametric_dem(circuit: Circuit) -> ParametricDEM:
    """Like :func:`circuit_to_dem`, but noise-op strengths in the circuit
    are interpreted as *ratios* of a base physical rate p (build the circuit
    with ``DepolarizingNoise(1.0)``), and the result's priors are exact
    functions of p via per-mechanism (ratio, count) bookkeeping."""
    mech: dict[int, dict[float, int]] = {}

    def emit(sig: int, ratio: float) -> None:
        if sig == 0 or ratio <= 0.0:
            return
        d = mech.setdefault(sig, {})
        d[ratio] = d.get(ratio, 0) + 1

    _fault_signatures(circuit, emit)
    sigs = sorted(mech)
    ratios = sorted({r for d in mech.values() for r in d})
    counts = np.zeros((len(sigs), len(ratios)), np.int32)
    for i, sig in enumerate(sigs):
        for j, r in enumerate(ratios):
            counts[i, j] = mech[sig].get(r, 0)
    H, L = _sigs_to_matrices(sigs, len(circuit.detectors), len(circuit.observables))
    return ParametricDEM(H=H, L=L, ratios=np.array(ratios, np.float64), counts=counts)


def memory_experiment(
    code,
    basis: str = "z",
    rounds: int | None = None,
    noise: DepolarizingNoise | None = None,
) -> Circuit:
    """Standard CSS memory experiment with ancilla-based extraction.

    Basis "z": data prepared in |0>^n (Z-stabilizers deterministic),
    ``rounds`` rounds measuring every stabilizer of both types, final
    transversal Z-basis data measurement, observables = rows of ``Lz``.
    Detectors: deterministic-basis checks get a round-0 absolute detector,
    consecutive-round differences, and a final data-vs-last-round
    comparison; the complementary checks get consecutive differences only
    (their first outcome is random). Basis "x" is the Hadamard-dual
    construction. Same experiment family as the reference's
    ``get_memory_experiment(code, Pauli.Z, num_rounds=distance, noise)``
    (studies/studyComplete.py:72-78); gate scheduling within a round is a
    fixed check-sequential order (hook faults arise from the per-CX
    DEPOLARIZE2 locations either way).
    """
    if basis not in ("z", "x"):
        raise ValueError("basis must be 'z' or 'x'")
    R = rounds if rounds else max(int(code.distance), 1)
    nz = noise or DepolarizingNoise(0.0)

    # det_H: checks whose outcomes are deterministic given the preparation
    # basis; rnd_H: the complementary type. Z memory: |0>^n stabilizes the
    # Z-type checks (Hz) and reads out Lz transversally.
    if basis == "z":
        det_H, rnd_H, L_obs = code.Hz, code.Hx, code.Lz
    else:
        det_H, rnd_H, L_obs = code.Hx, code.Hz, code.Lx
    n = det_H.shape[1]
    m_det, m_rnd = det_H.shape[0], rnd_H.shape[0]
    det_supp = [np.flatnonzero(det_H[k]).tolist() for k in range(m_det)]
    rnd_supp = [np.flatnonzero(rnd_H[k]).tolist() for k in range(m_rnd)]
    a_det = [n + k for k in range(m_det)]
    a_rnd = [n + m_det + k for k in range(m_rnd)]

    c = Circuit(n_qubits=n + m_det + m_rnd)
    ops = c.ops
    rec_i = 0
    rec_det = np.zeros((R, m_det), np.int64)  # record ids per round/check
    rec_rnd = np.zeros((R, m_rnd), np.int64)

    def noisy_reset(q):
        ops.append(("R", q))
        ops.append(("XE", nz.pr, q))

    def noisy_h(q):
        ops.append(("H", q))
        ops.append(("DEP1", nz.p1, q))

    def noisy_cx(a, b):
        ops.append(("CX", a, b))
        ops.append(("DEP2", nz.p2, a, b))

    # --- preparation
    for q in range(n):
        noisy_reset(q)
        if basis == "x":
            noisy_h(q)
    for a in a_det + a_rnd:
        noisy_reset(a)

    def extract(anc, supp, xtype):
        """One stabilizer extraction: Z-type checks use a |0> ancilla with
        CX(data -> ancilla) fan-in; X-type checks use a |+> ancilla with
        CX(ancilla -> data) fan-out and an X-basis readout (H before MR)."""
        if xtype:
            noisy_h(anc)
        for q in supp:
            if xtype:
                noisy_cx(anc, q)
            else:
                noisy_cx(q, anc)
        if xtype:
            noisy_h(anc)

    det_is_xtype = basis == "x"  # det_H rows are X-type stabilizers in X memory

    # --- extraction rounds
    for r in range(R):
        for k in range(m_det):
            extract(a_det[k], det_supp[k], det_is_xtype)
        for k in range(m_rnd):
            extract(a_rnd[k], rnd_supp[k], not det_is_xtype)
        for k in range(m_det):
            ops.append(("XE", nz.pm, a_det[k]))
            ops.append(("MR", a_det[k]))
            rec_det[r, k] = rec_i
            rec_i += 1
            ops.append(("XE", nz.pr, a_det[k]))  # reset half of MR
        for k in range(m_rnd):
            ops.append(("XE", nz.pm, a_rnd[k]))
            ops.append(("MR", a_rnd[k]))
            rec_rnd[r, k] = rec_i
            rec_i += 1
            ops.append(("XE", nz.pr, a_rnd[k]))

    # --- final transversal data measurement in the memory basis
    rec_data = np.zeros((n,), np.int64)
    for q in range(n):
        if basis == "x":
            noisy_h(q)
        ops.append(("XE", nz.pm, q))
        ops.append(("M", q))
        rec_data[q] = rec_i
        rec_i += 1

    # --- detectors
    for k in range(m_det):  # round-0 outcomes are deterministic
        c.detectors.append([int(rec_det[0, k])])
    for r in range(1, R):
        for k in range(m_det):
            c.detectors.append([int(rec_det[r - 1, k]), int(rec_det[r, k])])
        for k in range(m_rnd):
            c.detectors.append([int(rec_rnd[r - 1, k]), int(rec_rnd[r, k])])
    for k in range(m_det):  # data readout reconstructs the last round
        c.detectors.append(
            [int(rec_det[R - 1, k])] + [int(rec_data[q]) for q in det_supp[k]]
        )

    # --- observables
    for row in np.atleast_2d(L_obs):
        c.observables.append([int(rec_data[q]) for q in np.flatnonzero(row)])
    return c


def memory_experiment_dem(
    code, p: float, basis: str = "z", rounds: int | None = None, **noise_kw
) -> DEMData:
    """Convenience: build the memory experiment at depolarizing rate ``p``
    and return its exact DEM (the in-repo equivalent of
    studyComplete.py:72-84's stim+ldpc chain)."""
    return circuit_to_dem(
        memory_experiment(
            code, basis=basis, rounds=rounds, noise=DepolarizingNoise(p, **noise_kw)
        )
    )


def parametric_memory_dem(
    code, basis: str = "z", rounds: int | None = None
) -> ParametricDEM:
    """Uniform-depolarizing memory-experiment DEM, parametric in the
    physical rate p: build once per (code, basis, rounds), decode any p
    with one compiled program."""
    return circuit_to_parametric_dem(
        memory_experiment(code, basis=basis, rounds=rounds, noise=DepolarizingNoise(1.0))
    )
