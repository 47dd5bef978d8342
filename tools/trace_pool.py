"""Trace the regeneration pool on the GPU and reduce the trace to metrics.

    python tools/trace_pool.py [--photons N] [--out DIR]

Runs the flagship (BASELINE #1: Rayleigh tau=5 reflected-light spectrum,
f32) once to compile, then once under ``jax.profiler.trace`` through
``runner.run_wavelength``, and prints one JSON line with:

* ``lane_rounds_per_photon``: pool rounds times pool width per photon
  (a photon's lifetime in rounds, plus the pool's drain tail);
* ``device_us_per_round``: device busy time per pool round;
* ``launches_per_round``: device operations (kernels, copies) per round;
* ``busy_share``: union of device-operation intervals over the traced
  window (first to last device event);
* ``compile_s``: seconds of XLA backend compiles before the window.

:func:`summarize` is the reduction, kept here so every run computes the
numbers the same way.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _device_events(path: str):
    """(line name, event name, start ns, duration ns) of every event on a
    GPU device plane of one ``.xplane.pb`` file."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                yield line.name, ev.name, ev.start_ns, ev.duration_ns


def summarize(log_dir: str, n_rounds: int) -> dict:
    """:func:`reduce_events` of the newest trace under ``log_dir``."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    out = reduce_events(_device_events(paths[-1]), n_rounds)
    out["trace"] = os.path.relpath(paths[-1], log_dir)
    return out


def reduce_events(events, n_rounds: int) -> dict:
    """Device busy share, operations and busy time per pool round from
    (line name, event name, start ns, duration ns) device events. Only
    stream lines count as device work (the per-module and per-op summary
    lines repeat the same time); busy time is the union of the intervals."""
    lines: dict[str, int] = {}
    spans = []
    names: dict[str, float] = {}
    for line, name, start, dur in events:
        lines[line] = lines.get(line, 0) + 1
        if "stream" not in line.lower():
            continue
        spans.append((start, start + dur))
        names[name] = names.get(name, 0.0) + dur
    if not spans:
        raise ValueError(f"no device stream events; lines: {lines}")
    spans.sort()
    busy = 0.0
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return {
        "device_lines": lines,
        "launches": len(spans),
        "launches_per_round": len(spans) / max(n_rounds, 1),
        "window_s": window * 1e-9,
        "busy_s": busy * 1e-9,
        "busy_share": busy / window if window else 0.0,
        "device_us_per_round": busy * 1e-3 / max(n_rounds, 1),
        "top_ops_us": {k: v * 1e-3 for k, v in top},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--photons", type=int, default=1 << 24)
    p.add_argument("--out", default=os.path.join(ROOT, "artifacts",
                                                 "trace_pool"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from artes import presets
    from artes.config import ArtesConfig, detector_setup
    from artes.runner import pool_width, run_wavelength

    if jax.default_backend() != "gpu":
        print("trace_pool: no GPU", file=sys.stderr)
        return 2
    jax.monitoring.register_event_duration_secs_listener(
        cs.on_duration_event)
    atm = presets.rayleigh_single_layer(tau=5.0)
    cfg = ArtesConfig()
    cfg.mode = "spectrum"
    det = detector_setup(cfg, float(atm.rfront[-1]))
    kw = dict(seed=3, dtype=jnp.float32)
    run_wavelength(atm, cfg, det, 0, args.photons, **kw)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        res = run_wavelength(atm, cfg, det, 0, args.photons, **kw)
    wall = time.perf_counter() - t0
    out = summarize(args.out, res.n_rounds)
    out.update(photons=args.photons, wall_s=wall, n_rounds=res.n_rounds,
               lane_rounds_per_photon=(res.n_rounds * pool_width(args.photons)
                                       / args.photons),
               compile_s=cs.compile_seconds(),
               device_kind=jax.devices()[0].device_kind)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
