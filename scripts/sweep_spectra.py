#!/usr/bin/env python3
"""Sweep the spectra kernel's tiling (KernelConfig) on a GPU.

    python scripts/sweep_spectra.py [--ms 4096 1000] [--block 32768]
                                    [--calls 5]

For each m and each (tile_k, block_n, super_r) point, times the kernel on
one block of samples for packed f32, planar bf16 and power bf16 output:
the median of ``--calls`` calls after a warm-up call, each ending in
block_until_ready.  Prints the card's name and power limit first, one row
per point, and the fastest point per m.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import itertools
import pathlib
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

POINTS = [(k, n, r) for k, n, r in itertools.product((32, 64), (32, 64, 128),
                                                       (2, 4))]


def median_ms(fn, calls):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ms", type=int, nargs="+", default=[4096, 1000])
    ap.add_argument("--block", type=int, default=32768)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("sweep_spectra: JAX found no GPU", file=sys.stderr)
        return 1
    from sdft_tpu import FAST_PRECISION, Plan, init_state
    from sdft_tpu.kernels import (KernelConfig, forward_block_pallas,
                                  forward_block_power)
    from sdft_tpu.runtime import setup_compile_cache

    setup_compile_cache()
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    x = jnp.asarray(np.random.default_rng(0).uniform(
        -0.5, 0.5, args.block).astype(np.float32))
    print(f"{'m':>5} {'tile_k':>6} {'block_n':>7} {'super_r':>7} "
          f"{'packed f32':>10} {'planar bf16':>11} {'power bf16':>10}  ms")
    for m in args.ms:
        plan = Plan(m, window="hann", precision=FAST_PRECISION)
        st = init_state(plan)
        best = None
        for point in POINTS:
            cfg = KernelConfig(*point)
            t = (median_ms(lambda: forward_block_pallas(plan, st, x,
                                                        config=cfg),
                           args.calls),
                 median_ms(lambda: forward_block_pallas(
                     plan, st, x, layout="planar", out_dtype="bfloat16",
                     config=cfg), args.calls),
                 median_ms(lambda: forward_block_power(
                     plan, st, x, out_dtype="bfloat16", config=cfg),
                     args.calls))
            print(f"{m:>5} {point[0]:>6} {point[1]:>7} {point[2]:>7} "
                  f"{t[0]:>10.4f} {t[1]:>11.4f} {t[2]:>10.4f}", flush=True)
            if best is None or sum(t) < sum(best[1]):
                best = (point, t)
        print(f"fastest at m={m} (sum of the three): {best[0]}")
        jax.clear_caches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
