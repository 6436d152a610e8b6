import hashlib

import numpy as np
import pytest

from qldpc_jax.codes import CSSCode, get_code, gf2, ALL_CODE_NAMES, BB_CODE_NAMES

# SHA-256 of (H % 2) as C-ordered uint8 bytes, (Hx, Hz, distance), for the
# constructed BB codes. Pinned from the construction that matched the
# reference's codes/*.npz bit for bit; a construction change fails here.
BB_DIGESTS = {
    "[[72, 12, 6]]": (
        "7ab0973bfd02e399d69728d26e67dbfa0e95bbc6ad2c5cf8bf309d667244a5a8",
        "267f345c09710ec0cfad1e49e0786b2636ab052fbfb660e5a76ae9919ba22614",
        6,
    ),
    "[[90, 8, 10]]": (
        "ff57bf512c40823c6ae89aa0062f3e74ceb337eff24a66b9dd824ed304184b59",
        "72cbb4962f1444480e1b417356f7703ea6fd0e016e20b461f2a335476422d6e9",
        10,
    ),
    "[[108, 8, 10]]": (
        "6ed504c815418f90551f83ee7a5023b5aa61aaf710404afde4f35d9f1dd91d6a",
        "b3b366f06e93c6c39a9eecc01f98dba6b8bef6c19b108f228eb7b1395b8b3ea0",
        10,
    ),
    "[[144, 12, 12]]": (
        "195d5586a406f0194b89649b6a2499ec2b481edb81c91293daf1745d8b806641",
        "72dc3b9cefec7d45c99325c8f8d0787174e3cea207a41cd5b740a8b05f263918",
        12,
    ),
    "[[288, 12, 18]]": (
        "c06e721ec6ea114b60e0e6f7187324f6e150e229b8d008888e8a4cc3f4a324a2",
        "599e3888110b72dd10de5d22583c12fb3832de67b63052c378e0c828b5968d23",
        18,
    ),
}


def _digest(M) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(np.asarray(M) % 2, dtype=np.uint8).tobytes()
    ).hexdigest()


class TestGF2:
    def test_row_reduce_identity(self):
        R, piv = gf2.row_reduce(np.eye(4, dtype=int))
        assert piv == [0, 1, 2, 3]
        assert np.array_equal(R, np.eye(4, dtype=np.uint8))

    def test_rank_and_nullspace(self, rng):
        M = rng.integers(0, 2, size=(20, 37), dtype=np.uint8)
        r = gf2.rank(M)
        ns = gf2.null_space(M)
        assert ns.shape == (37 - r, 37)
        assert not ((M @ ns.T) % 2).any()
        assert gf2.rank(ns) == ns.shape[0]

    def test_solve_consistent(self, rng):
        M = rng.integers(0, 2, size=(15, 30), dtype=np.uint8)
        x_true = rng.integers(0, 2, size=30, dtype=np.uint8)
        b = (M @ x_true) % 2
        x = gf2.solve(M, b)
        assert x is not None
        assert np.array_equal((M @ x) % 2, b)

    def test_solve_inconsistent(self):
        M = np.array([[1, 0], [1, 0]], dtype=np.uint8)
        assert gf2.solve(M, np.array([1, 0])) is None

    def test_in_row_space(self, rng):
        M = rng.integers(0, 2, size=(5, 12), dtype=np.uint8)
        combo = M[[0, 2, 4]].sum(axis=0) % 2
        assert gf2.in_row_space(M, combo)


class TestBBCodes:
    @pytest.mark.parametrize("name", BB_CODE_NAMES)
    def test_matches_reference_matrices(self, name):
        """Our from-scratch BB construction is bit-exact vs the reference
        matrices, pinned as digests (BB_DIGESTS)."""
        code = get_code(name)
        hx, hz, distance = BB_DIGESTS[name]
        assert _digest(code.Hx) == hx
        assert _digest(code.Hz) == hz
        assert code.distance == distance

    @pytest.mark.parametrize("name", ALL_CODE_NAMES)
    def test_logical_operator_invariants(self, name):
        code = get_code(name)
        k = code.k
        assert code.Lx.shape == (k, code.n)
        assert code.Lz.shape == (k, code.n)
        # commutation with stabilizers
        assert not ((code.Hz @ code.Lx.T) % 2).any()
        assert not ((code.Hx @ code.Lz.T) % 2).any()
        # symplectic pairing is the identity
        assert np.array_equal((code.Lx @ code.Lz.T) % 2, np.eye(k, dtype=np.uint8))

    def test_bb_row_col_weights(self):
        code = get_code("[[144, 12, 12]]")
        assert set(code.Hx.sum(axis=1)) == {6}
        assert set(code.Hx.sum(axis=0)) == {3}

    def test_params(self):
        assert get_code("[[144, 12, 12]]").params == (144, 12, 12)
        assert get_code("steane").params == (7, 1, 3)

    def test_npz_roundtrip(self, tmp_path):
        code = get_code("[[72, 12, 6]]")
        path = tmp_path / "code.npz"
        code.save(path)
        back = CSSCode.load(path, name=code.name)
        assert np.array_equal(back.Hx, code.Hx)
        assert np.array_equal(back.Lz, code.Lz)
        assert back.distance == code.distance

    def test_load_reference_steane_without_logicals(self, tmp_path):
        """Reference-format npz files carry only Hx/Hz (codes/steane.npz)."""
        steane = get_code("steane")
        path = tmp_path / "steane.npz"
        np.savez(path, Hx=steane.Hx, Hz=steane.Hz)
        back = CSSCode.load(path)
        assert back.name == "steane"
        assert np.array_equal(back.Hx, steane.Hx)
        assert back.Hx.shape == (3, 7)
        assert back.Lx.shape == (0, 7)
        assert back.distance == 0

    def test_css_condition_enforced(self):
        with pytest.raises(ValueError):
            CSSCode(
                name="bad",
                Hx=np.array([[1, 1, 0]]),
                Hz=np.array([[1, 0, 0]]),
                Lx=np.zeros((0, 3)),
                Lz=np.zeros((0, 3)),
            )
