import json
import os

import numpy as np
import pytest

from qldpc_jax.experiments import PRESETS, ExperimentSpec, get_preset, run_experiment
from qldpc_jax.experiments.cli import build_parser, main as cli_main
from qldpc_jax.experiments.results_io import load_reference_archive, load_results, replot


class TestSpec:
    def test_all_presets_valid(self):
        for name, spec in PRESETS.items():
            assert spec.name == name
            for code in spec.codes:
                assert spec.rates_for(code), name

    def test_json_roundtrip(self, tmp_path):
        spec = get_preset("rework")
        path = tmp_path / "spec.json"
        spec.to_json(path)
        back = ExperimentSpec.from_json(path)
        assert back == spec

    def test_preset_isolation(self):
        a = get_preset("study")
        b = get_preset("study")
        a.codes.append("steane")
        assert "steane" not in b.codes

    def test_rates_for_per_code(self):
        spec = get_preset("rework")
        assert spec.rates_for("[[288, 12, 18]]") == [0.1, 0.06, 0.05, 0.04]


class TestCLI:
    def test_presets_command(self, capsys):
        assert cli_main(["presets"]) == 0
        out = capsys.readouterr().out
        assert "study" in out and "rework" in out

    def test_parser_overrides(self):
        args = build_parser().parse_args(
            ["run", "study", "--trials", "64", "--bp-only", "--out", "/tmp/x"]
        )
        assert args.preset == "study" and args.trials == 64 and args.bp_only


class TestRunAndIO:
    def test_run_and_reload(self, tmp_path):
        spec = get_preset("study").replace(
            codes=["steane"], trials=128, batch_size=128,
            error_rates=[0.02, 0.05], output_dir=str(tmp_path),
        )
        results = run_experiment(spec, verbose=False, checkpoint=False)
        assert "_meta" in results
        back = load_results(tmp_path / "study.npz")
        assert set(back) == set(results)
        assert back["steane"][0.05]["trials"] == 128
        png = replot(tmp_path / "study.npz")
        assert png.exists()

    def test_load_reference_archive(self):
        ref = os.environ.get("QLDPC_REFERENCE_DIR")
        if not ref:
            pytest.skip("the reference archives are not distributed with this "
                        "repository; set QLDPC_REFERENCE_DIR to a checkout of "
                        "michelebanfi/qLDPC to read its data/LERS.npz")
        arch = load_reference_archive(os.path.join(ref, "data", "LERS.npz"))
        assert "physicalErrorRates" in arch
        assert "[[144, 12, 12]]" in arch
        assert len(arch["[[144, 12, 12]]"]["ler"]) == 8

    def test_bp_iteration_grid(self, tmp_path):
        spec = get_preset("bp-iteration").replace(
            codes=["steane"], trials=64, batch_size=64,
            max_iter_grid=[5, 10], output_dir=str(tmp_path),
        )
        results = run_experiment(spec, verbose=False, checkpoint=False)
        keys = [k for k in results["steane"]]
        assert (5, 0.01) in keys and (10, 0.01) in keys
        # the LER-vs-iterations plot must be emitted for iteration grids
        assert (tmp_path / "bp-iteration_ler_vs_iters.png").exists()

    def test_combined_order_grid(self, tmp_path):
        """(bp_iter x osd_order) configuration grid of
        rework/main_different_orders.py: keys are (max_iter, order, p) and
        the comparison panels are emitted."""
        spec = get_preset("different-orders").replace(
            codes=["steane"], trials=64, batch_size=64,
            max_iter_grid=[5, 10], osd_order_grid=[0, 2],
            per_code_rates={"steane": [0.03, 0.06]},
        ).replace(output_dir=str(tmp_path))
        results = run_experiment(spec, verbose=False, checkpoint=False)
        keys = set(results["steane"])
        assert (5, 0, 0.03) in keys and (10, 2, 0.06) in keys
        assert len(keys) == 8
        assert (tmp_path / "different-orders_panels.png").exists()

    def test_circuit_level_preset(self, tmp_path):
        """The studyComplete-equivalent preset: parametric memory-experiment
        DEM per code, one engine build for the whole rate grid."""
        spec = get_preset("complete").replace(
            codes=["steane"], trials=128, batch_size=128,
            error_rates=[0.003, 0.02], output_dir=str(tmp_path),
        )
        results = run_experiment(spec, verbose=False, checkpoint=False)
        d = results["steane"]
        assert d[0.003]["trials"] == 128
        assert d[0.003]["ler"] <= d[0.02]["ler"]
        assert (tmp_path / "complete_ler.png").exists()
        assert (tmp_path / "complete_reference_format.npz").exists()

    def test_per_code_grid_emits_panels(self, tmp_path):
        """Per-code rate grids skip the common-grid reference export but must
        still produce the rework-style multi-panel plot."""
        spec = get_preset("study").replace(
            name="grids", codes=["steane", "[[72, 12, 6]]"], trials=64,
            batch_size=64, output_dir=str(tmp_path),
            per_code_rates={
                "steane": [0.02, 0.05],
                "[[72, 12, 6]]": [0.03, 0.06],
            },
        )
        run_experiment(spec, verbose=False, checkpoint=False)
        assert (tmp_path / "grids_panels.png").exists()
        assert not (tmp_path / "grids_reference_format.npz").exists()


def test_reference_format_export(tmp_path):
    """The reference's archive schema is emitted alongside our format and
    parses with the same loader that reads real reference archives."""
    from qldpc_jax.experiments import get_preset, run_experiment
    from qldpc_jax.experiments.results_io import load_reference_archive

    spec = get_preset("study").replace(
        codes=["steane"], trials=64, batch_size=64,
        error_rates=[0.02, 0.05], output_dir=str(tmp_path),
    )
    run_experiment(spec, verbose=False, checkpoint=False)
    arch = load_reference_archive(tmp_path / "study_reference_format.npz")
    assert list(arch["physicalErrorRates"]) == [0.02, 0.05]
    assert len(arch["steane"]["ler"]) == 2


class TestDEMBatchLimit:
    """The circuit-level runner sizes its lane count from the device's
    memory limit (experiments/runners.py::dem_batch_limit)."""

    @staticmethod
    def _H():
        H = np.zeros((432, 16000), np.uint8)
        for r in range(432):
            H[r, (r * 37 + np.arange(300) * 53) % 16000] = 1
        return H

    def test_no_limit_keeps_batch(self):
        from qldpc_jax.experiments.runners import dem_batch_limit

        assert dem_batch_limit(self._H(), 4096, None) == 4096

    def test_large_limit_keeps_batch(self):
        from qldpc_jax.experiments.runners import dem_batch_limit

        assert dem_batch_limit(self._H(), 1024, 80 * 2**30) == 1024

    def test_clamps_to_multiple_of_128(self):
        from qldpc_jax.experiments.runners import dem_batch_limit

        H = self._H()
        lane = 432 * 300 * 6 * 4 + 16000 * 12 * 4
        got = dem_batch_limit(H, 1 << 20, 2 * 1000 * lane)
        assert got == 896  # 1000 lanes fit, rounded down to 128s
        assert got % 128 == 0

    def test_never_below_128(self):
        from qldpc_jax.experiments.runners import dem_batch_limit

        assert dem_batch_limit(self._H(), 4096, 1 << 20) == 128
