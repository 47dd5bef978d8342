import numpy as np

from artes.io.fitsio import read_fits, read_fits_map, write_fits


def test_roundtrip_multi_hdu(tmp_path):
    path = tmp_path / "test.fits"
    a = np.arange(24, dtype=np.float64).reshape(2, 3, 4)
    b = np.linspace(0, 1, 7, dtype=np.float64)
    c = np.arange(10, dtype=np.float32).reshape(5, 2)
    write_fits(path, [("radial", a), ("polar", b), ("floats", c)])
    hdus = read_fits(path)
    assert [h[0] for h in hdus] == ["radial", "polar", "floats"]
    np.testing.assert_array_equal(hdus[0][1], a)
    np.testing.assert_array_equal(hdus[1][1], b)
    np.testing.assert_array_equal(hdus[2][1], c)
    assert hdus[2][1].dtype == np.float32


def test_block_padding_and_big_endian(tmp_path):
    path = tmp_path / "pad.fits"
    a = np.array([[1.5, -2.5]])
    write_fits(path, [("x", a)])
    raw = path.read_bytes()
    assert len(raw) % 2880 == 0
    # header says BITPIX=-64, NAXIS1=2
    head = raw[:2880].decode("ascii")
    assert "BITPIX  =" in head and "-64" in head
    assert "NAXIS1  =" in head

    m = read_fits_map(path)
    np.testing.assert_array_equal(m["x"], a)


def test_int_dtypes(tmp_path):
    path = tmp_path / "ints.fits"
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    write_fits(path, [(None, a)])
    hdus = read_fits(path)
    np.testing.assert_array_equal(hdus[0][1], a)


def test_reference_artifact_layout(tmp_path):
    """atmosphere.fits layout: NAXIS1 must be the last numpy axis."""
    path = tmp_path / "atm.fits"
    sca = np.random.default_rng(0).random((3, 2, 4, 5))  # (nl,nphi,nt,nr)
    write_fits(path, [("scattering", sca)])
    raw = path.read_bytes()[:2880].decode("ascii")
    # NAXIS1 = nr = 5
    line = [raw[i:i + 80] for i in range(0, 2880, 80) if raw[i:i + 80].startswith("NAXIS1")][0]
    assert int(line.split("=")[1].split("/")[0]) == 5


def test_native_reader_matches_python(tmp_path):
    """The C++ loader (cfitsio equivalent) returns identical data."""
    from artes.io.fitsio import read_fits_native

    path = tmp_path / "n.fits"
    rng = np.random.default_rng(5)
    a = rng.random((3, 4, 5))
    b = (rng.random((7,)) * 100).astype(np.int32)
    c = rng.random((2, 6)).astype(np.float32)
    write_fits(path, [("one", a), ("ints", b), ("f32", c)])
    native = read_fits_native(path)
    assert native is not None, "native FITS library unavailable"
    py = read_fits(path)
    assert [h[0] for h in native] == [h[0] for h in py]
    for (_, dn), (_, dp) in zip(native, py):
        np.testing.assert_array_equal(dn, np.asarray(dp, np.float64))
