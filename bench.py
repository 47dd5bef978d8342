"""Benchmark: photon-transport throughput through the runner, on the GPU.

    python bench.py [PHOTONS]

Runs each cell once to compile (reported as set-up), then once timed with a
``block_until_ready`` fence, through ``runner.run_wavelength`` — the path a
user's run takes (the regeneration pool, ``transport/kernel.run_stream``).
Prints the device (JAX's platform, device_kind and count; nvidia-smi's name
and power limit) and ONE JSON line. Without a GPU it exits non-zero.

Cells: the flagship Rayleigh tau=5 reflected-light spectrum (BASELINE #1,
full Stokes peel), 25x25 and 101x101 Stokes images of it, the nr=39 graded
hydrostatic spectrum with and without flow diagnostics, the 39x8x8 patchy
3-D deck, and a thermal emission shell.
"""

import json
import sys
import time

import chip_smoke as cs


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 1 << 25
    import jax
    import jax.numpy as jnp

    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (default backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    from artes import presets
    from artes.config import detector_setup
    from artes.runner import pool_width, run_wavelength

    d0 = jax.devices()[0]
    smi = cs.card_name_and_power()
    print(f"platform={d0.platform} device_kind={d0.device_kind} "
          f"count={len(jax.devices())} nvidia-smi: {smi}", flush=True)
    jax.monitoring.register_event_duration_secs_listener(
        cs.on_duration_event)

    flag = presets.rayleigh_single_layer(tau=5.0)
    graded = presets.graded_column((0.7,))
    flow = cs.spectrum_cfg()
    flow.flow_global = flow.flow_theta = True
    thermal = cs.spectrum_cfg()
    thermal.photon_source = "planet"
    cells = {
        "flagship": (flag, cs.spectrum_cfg(), n),
        "imaging_25px": (flag, cs.spectrum_cfg("imaging_mono", 25), n // 4),
        "imaging_101px": (flag, cs.spectrum_cfg("imaging_mono", 101), n // 8),
        "hydrostatic39": (graded, cs.spectrum_cfg(), n // 4),
        "hydrostatic39_flow": (graded, flow, n // 8),
        "grid3d_2496": (presets.patchy_deck(), cs.spectrum_cfg(), n // 8),
        "thermal": (presets.thermal_shell(tau_abs=0.8, nr=4), thermal, n),
    }
    result = {"platform": d0.platform, "device_kind": d0.device_kind,
              "count": len(jax.devices()), "nvidia_smi": smi,
              "unit": "photons/s", "cells": {}}
    for name, (atm, cfg, photons) in cells.items():
        det = detector_setup(cfg, float(atm.rfront[-1]))
        kw = dict(seed=11, dtype=jnp.float32)
        c0 = cs.compile_seconds()
        t0 = time.perf_counter()
        # one pool's worth of photons: the same pool width, so the same
        # compiled program as the timed run
        run_wavelength(atm, cfg, det, 0, pool_width(photons), **kw)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run_wavelength(atm, cfg, det, 0, photons, **kw)
        dt = time.perf_counter() - t0      # host reduction = the fence
        result["cells"][name] = {
            "photons": photons, "seconds": dt, "photons_per_s": photons / dt,
            "setup_s": setup, "compile_s": cs.compile_seconds() - c0,
            "rounds_per_photon": res.n_rounds / photons,
            "n_error": res.n_error, "n_alive_at_cap": res.n_alive_at_cap,
            "detector_I": float(res.photometry[0])}
        print(f"{name}: {photons / dt:.6g} photons/s", file=sys.stderr,
              flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
