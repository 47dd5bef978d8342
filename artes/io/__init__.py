from artes.io.fitsio import read_fits, write_fits  # noqa: F401
