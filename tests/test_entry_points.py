"""Process-level contracts: the compile-cache directory, and chip_smoke.py
refusing to run (or to report a result) without a GPU."""

import os
import shutil
import subprocess
import sys

import artes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, **env):
    e = {k: v for k, v in os.environ.items()
         if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    e.update(env)
    return subprocess.run([sys.executable] + args, cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_compile_cache_dir_follows_env(tmp_path):
    assert artes.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR":
                                    str(tmp_path)}) == str(tmp_path)


def test_compile_cache_dir_default_is_in_checkout():
    d = artes.compile_cache_dir({})
    assert d == artes.CHECKOUT_CACHE_DIR
    assert os.path.dirname(d) == ROOT and os.path.basename(d) == ".jax_cache"


def test_import_sets_no_other_cache_dir(tmp_path):
    code = ("import artes, jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    got = _run(["-c", code], JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == str(tmp_path)
    got = _run(["-c", code], JAX_PLATFORMS="cpu")
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == artes.CHECKOUT_CACHE_DIR


def test_chip_smoke_refuses_cpu_platform():
    got = _run(["chip_smoke.py"], JAX_PLATFORMS="cpu")
    assert got.returncode != 0
    assert '"ok": true' not in got.stdout
    assert "no GPU" in got.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    got = _run(["chip_smoke.py"], cwd=tmp_path, JAX_PLATFORMS="cpu")
    assert got.returncode != 0
    assert '"ok": true' not in got.stdout
