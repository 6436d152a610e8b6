"""Tests for the native circuit-level pipeline (noise/circuit.py).

Strategy: hand-verified DEMs of tiny Clifford circuits pin the backward
sensitivity pass; structural limits of the memory experiment pin the
builder (final-measurement noise must reproduce the code's own check
matrix, a noiseless circuit has an empty DEM); an end-to-end DEMEngine run
closes the studyComplete.py:88-109 loop in-repo.
"""

import numpy as np
import pytest

from qldpc_jax.codes import get_code
from qldpc_jax.decoders import BPConfig
from qldpc_jax.decoders.osd import OSDConfig
from qldpc_jax.mc import DEMEngine, DEMEngineConfig
from qldpc_jax.noise.circuit import (
    Circuit,
    DepolarizingNoise,
    circuit_to_dem,
    memory_experiment,
    memory_experiment_dem,
)


class TestCircuitToDEM:
    def test_single_qubit_measure_flip(self):
        c = Circuit(n_qubits=1, ops=[("R", 0), ("XE", 0.1, 0), ("M", 0)])
        c.detectors.append([0])
        dem = circuit_to_dem(c)
        assert dem.H.shape == (1, 1) and dem.H[0, 0] == 1
        assert dem.priors[0] == pytest.approx(0.1)

    def test_z_error_invisible_to_z_measurement(self):
        c = Circuit(n_qubits=1, ops=[("R", 0), ("ZE", 0.1, 0), ("M", 0)])
        c.detectors.append([0])
        dem = circuit_to_dem(c)
        assert dem.priors.size == 0  # unobservable mechanism dropped

    def test_cx_propagates_x_control_to_target(self):
        c = Circuit(
            n_qubits=2,
            ops=[("R", 0), ("R", 1), ("XE", 0.2, 0), ("CX", 0, 1), ("M", 1), ("M", 0)],
        )
        c.detectors += [[0], [1]]
        dem = circuit_to_dem(c)
        # X on qubit 0 flips BOTH measurements (X_0 -> X_0 X_1)
        assert dem.H.shape == (2, 1)
        assert dem.H[:, 0].tolist() == [1, 1]

    def test_hadamard_swaps_frames(self):
        # Z before H becomes X, which flips the Z measurement
        c = Circuit(n_qubits=1, ops=[("R", 0), ("ZE", 0.3, 0), ("H", 0), ("M", 0)])
        c.detectors.append([0])
        dem = circuit_to_dem(c)
        assert dem.priors.tolist() == [pytest.approx(0.3)]

    def test_reset_blocks_propagation(self):
        c = Circuit(n_qubits=1, ops=[("XE", 0.1, 0), ("R", 0), ("M", 0)])
        c.detectors.append([0])
        assert circuit_to_dem(c).priors.size == 0

    def test_identical_mechanisms_merge_xor(self):
        p1, p2 = 0.1, 0.2
        c = Circuit(
            n_qubits=1, ops=[("R", 0), ("XE", p1, 0), ("XE", p2, 0), ("M", 0)]
        )
        c.detectors.append([0])
        dem = circuit_to_dem(c)
        assert dem.priors.size == 1
        assert dem.priors[0] == pytest.approx(p1 * (1 - p2) + p2 * (1 - p1))

    def test_dep2_mechanism_split(self):
        # DEP2 after a CX feeding two independent measurements: the 15 Pauli
        # pairs collapse onto the 3 visible signatures {10, 01, 11} in
        # detector space (Z components invisible to Z measurements)
        c = Circuit(
            n_qubits=2,
            ops=[("R", 0), ("R", 1), ("DEP2", 0.15, 0, 1), ("M", 0), ("M", 1)],
        )
        c.detectors += [[0], [1]]
        dem = circuit_to_dem(c)
        sigs = {tuple(dem.H[:, j]) for j in range(dem.priors.size)}
        assert sigs == {(1, 0), (0, 1), (1, 1)}
        # each signature aggregates X?/Y? x {I,Z,X,Y} partners: for (1,0)
        # the pairs {X,Y}x{I,Z} = 4 of the 15, each p/15
        # XOR-convolution q<-q(1-p)+p(1-q) of n equal p: (1-(1-2p)^n)/2
        w = 0.15 / 15
        agg4 = (1 - (1 - 2 * w) ** 4) / 2
        for j in range(3):
            assert dem.priors[j] == pytest.approx(agg4)


class TestForwardOracle:
    """Exact cross-validation of the backward sensitivity pass against an
    independent per-fault FORWARD Pauli-frame propagator
    (tests/forward_dem_oracle.py). Any wrong conjugation rule in
    circuit.py:149-190 shows up as a signature or prior mismatch here —
    the two passes share no code and walk the circuit in opposite
    directions (VERDICT round-2 item 2)."""

    @staticmethod
    def _backward_mech(circ):
        from qldpc_jax.noise.circuit import _fault_signatures

        mech = {}

        def emit(sig, p):
            if sig == 0 or p <= 0.0:
                return
            q = mech.get(sig, 0.0)
            mech[sig] = q * (1.0 - p) + p * (1.0 - q)

        _fault_signatures(circ, emit)
        return mech

    @staticmethod
    def _assert_dems_equal(circ):
        from forward_dem_oracle import forward_dem

        fwd = forward_dem(circ)
        bwd = TestForwardOracle._backward_mech(circ)
        only_fwd = set(fwd) - set(bwd)
        only_bwd = set(bwd) - set(fwd)
        assert not only_fwd and not only_bwd, (
            f"signature sets differ: {len(only_fwd)} forward-only, "
            f"{len(only_bwd)} backward-only "
            f"(of {len(fwd)}/{len(bwd)} total)"
        )
        for sig, p in fwd.items():
            assert abs(bwd[sig] - p) < 1e-12, f"prior mismatch at {sig:b}"

    @pytest.mark.parametrize("rounds", [2, 3])
    @pytest.mark.parametrize("basis", ["z", "x"])
    def test_steane_memory(self, rounds, basis):
        code = get_code("steane")
        circ = memory_experiment(
            code, basis=basis, rounds=rounds, noise=DepolarizingNoise(0.004)
        )
        self._assert_dems_equal(circ)

    def test_steane_nonuniform_noise(self):
        """Distinct per-location strengths make merged priors sensitive to
        WHICH elementary faults merged, not just how many."""
        code = get_code("steane")
        circ = memory_experiment(
            code,
            rounds=2,
            noise=DepolarizingNoise(
                0.003,
                after_clifford1=0.001,
                after_clifford2=0.007,
                before_measure=0.011,
                after_reset=0.002,
            ),
        )
        self._assert_dems_equal(circ)

    def test_bb_72_memory(self):
        """The reference's flagship circuit-level code at 2 rounds
        (studyComplete.py:72-84 semantics), ~27k elementary faults."""
        code = get_code("[[72, 12, 6]]")
        circ = memory_experiment(
            code, rounds=2, noise=DepolarizingNoise(0.002)
        )
        self._assert_dems_equal(circ)

    def test_matches_public_dem_matrices(self):
        """End-to-end: rebuild (H, L, priors) from the forward table and
        compare with circuit_to_dem's public output column-for-column."""
        from forward_dem_oracle import forward_dem

        code = get_code("steane")
        circ = memory_experiment(
            code, rounds=2, noise=DepolarizingNoise(0.005)
        )
        dem = circuit_to_dem(circ)
        fwd = forward_dem(circ)
        n_det = dem.H.shape[0]
        sigs = sorted(fwd)  # circuit_to_dem's deterministic column order
        assert len(sigs) == dem.H.shape[1]
        for col, sig in enumerate(sigs):
            h_col = [(sig >> k) & 1 for k in range(n_det)]
            l_col = [(sig >> (n_det + k)) & 1 for k in range(dem.L.shape[0])]
            assert np.array_equal(dem.H[:, col], h_col)
            assert np.array_equal(dem.L[:, col], l_col)
            assert abs(dem.priors[col] - fwd[sig]) < 1e-12


class TestMemoryExperiment:
    def test_noiseless_dem_is_empty(self):
        code = get_code("steane")
        dem = circuit_to_dem(memory_experiment(code, rounds=3))
        assert dem.priors.size == 0

    def test_detector_and_observable_counts(self):
        code = get_code("steane")
        R = 3
        c = memory_experiment(code, basis="z", rounds=R)
        m = code.Hz.shape[0]
        mx = code.Hx.shape[0]
        # round-0 absolute (m) + diffs ((R-1)*(m+mx)) + final compare (m)
        assert len(c.detectors) == m + (R - 1) * (m + mx) + m
        assert len(c.observables) == code.Lz.shape[0]

    @pytest.mark.parametrize("basis", ["z", "x"])
    def test_final_measurement_noise_reproduces_check_matrix(self, basis):
        """With noise ONLY before measurements, the mechanisms that touch no
        mid-circuit detector are exactly the final data flips: their
        detector signature is the memory-basis check matrix and their
        observable signature the memory-basis logicals — the code-capacity
        structure embedded in the space-time DEM."""
        code = get_code("steane")
        R = 2
        noise = DepolarizingNoise(0.0, before_measure=0.05)
        dem = circuit_to_dem(memory_experiment(code, basis=basis, rounds=R, noise=noise))
        det_H = code.Hz if basis == "z" else code.Hx
        L_obs = code.Lz if basis == "z" else code.Lx
        m = det_H.shape[0]
        n_final = m  # final comparison detectors are the last m rows
        bulk = dem.H[:-n_final]
        final = dem.H[-n_final:]
        is_data_flip = bulk.sum(0) == 0
        cols = {
            tuple(final[:, j]) + tuple(dem.L[:, j])
            for j in np.flatnonzero(is_data_flip)
        }
        expected = {
            tuple(det_H[:, q]) + tuple(L_obs[:, q]) for q in range(code.n)
        }
        assert cols == expected

    def test_ancilla_measurement_flip_hits_consecutive_detectors(self):
        """A measurement flip on a deterministic-basis ancilla in round r
        flips exactly the detectors comparing round r to its neighbors —
        the temporal-pair structure of the space-time graph."""
        code = get_code("steane")
        R = 3
        noise = DepolarizingNoise(0.0, before_measure=0.05)
        dem = circuit_to_dem(memory_experiment(code, rounds=R, noise=noise))
        weights = dem.H.sum(0)
        # every mechanism here is a measurement flip: ancilla flips touch
        # exactly 2 detectors (or 1+final block for the last round); data
        # flips touch their column weight in Hz
        assert set(weights.tolist()) <= {1, 2, 3, 4}
        assert (weights >= 1).all()

    def test_priors_in_range_and_columns_nonzero(self):
        code = get_code("steane")
        dem = memory_experiment_dem(code, 0.01, rounds=3)
        assert dem.priors.size > 0
        assert ((dem.priors > 0) & (dem.priors < 0.5)).all()
        assert (dem.H.sum(0) + dem.L.sum(0) > 0).all()


class TestParametricDEM:
    def test_matches_numeric_dem_exactly(self):
        """(ratios, counts) closed-form priors == XOR-convolved numeric
        priors at any p, with identical H, L and column order."""
        from qldpc_jax.noise.circuit import parametric_memory_dem

        code = get_code("steane")
        pdem = parametric_memory_dem(code, rounds=3)
        for p in (0.001, 0.01, 0.05):
            ndem = memory_experiment_dem(code, p, rounds=3)
            assert np.array_equal(pdem.H, ndem.H)
            assert np.array_equal(pdem.L, ndem.L)
            np.testing.assert_allclose(
                pdem.priors_at(p), ndem.priors, rtol=1e-12, atol=1e-15
            )

    def test_save_load_roundtrip(self, tmp_path):
        from qldpc_jax.noise.circuit import ParametricDEM, parametric_memory_dem

        pdem = parametric_memory_dem(get_code("steane"), rounds=2)
        pdem.save(tmp_path / "p.npz")
        back = ParametricDEM.load(tmp_path / "p.npz")
        assert np.array_equal(back.counts, pdem.counts)
        np.testing.assert_allclose(back.priors_at(0.01), pdem.priors_at(0.01))

    def test_engine_traced_p_matches_static_dem(self):
        """One DEMEngine over a ParametricDEM, run at two rates with the
        same compiled program, matches per-rate static-DEM engines within
        sampling error (the on-device f32 closed form and the host f64
        priors differ by ULPs, so occasional threshold-adjacent Bernoulli
        draws flip — exact counter equality is not expected)."""
        from qldpc_jax.noise.circuit import parametric_memory_dem

        code = get_code("steane")
        pdem = parametric_memory_dem(code, rounds=2)
        cfg = DEMEngineConfig(
            bp=BPConfig(max_iter=30), osd=OSDConfig(order=0), batch_size=512
        )
        eng_p = DEMEngine(pdem, cfg)
        for p in (0.004, 0.02):
            shots = 4096
            d_param = eng_p.run(shots=shots, seed=11, p=p)
            d_static = DEMEngine(pdem.at(p), cfg).run(shots=shots, seed=11)
            assert d_param["trials"] == d_static["trials"] == shots
            ler = d_static["ler"]
            sigma = np.sqrt(max(ler * (1 - ler), 1e-9) / shots)
            assert abs(d_param["ler"] - ler) < 5 * sigma + 0.01

    def test_parametric_requires_rate(self):
        from qldpc_jax.noise.circuit import parametric_memory_dem

        pdem = parametric_memory_dem(get_code("steane"), rounds=2)
        eng = DEMEngine(pdem, DEMEngineConfig(batch_size=128))
        with pytest.raises(ValueError):
            eng.run(shots=128)


class TestCircuitLevelEndToEnd:
    def test_decode_steane_memory(self):
        """The full studyComplete loop in-repo: circuit -> DEM -> sharded
        on-device sampling + BP+OSD decode -> logical error rate."""
        code = get_code("steane")
        dem = memory_experiment_dem(code, 0.005, rounds=3)
        eng = DEMEngine(
            dem,
            DEMEngineConfig(
                bp=BPConfig(max_iter=40), osd=OSDConfig(order=0), batch_size=256
            ),
            name="steane-circuit",
        )
        d = eng.run(shots=1024, seed=0)
        assert d["trials"] == 1024
        assert 0 <= d["ler"] < 0.5

    @pytest.mark.slow
    def test_ler_increases_with_physical_rate(self):
        code = get_code("steane")
        lers = []
        for p in (0.002, 0.02):
            dem = memory_experiment_dem(code, p, rounds=3)
            eng = DEMEngine(
                dem,
                DEMEngineConfig(
                    bp=BPConfig(max_iter=40), osd=OSDConfig(order=0), batch_size=512
                ),
            )
            lers.append(eng.run(shots=4096, seed=1)["ler"])
        assert lers[0] < lers[1]
