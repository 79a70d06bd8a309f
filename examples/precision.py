"""Precision-tier tour: the reference's TD/FD dtype matrix in JAX terms.

The reference exposes float/double/long-double FD tiers via template
parameters (c/src/sdft/sdft.h:21-37,101-125).  This framework mirrors
them as `Precision` configurations and adds a double-word extended tier:

  * float32 fast path       — the throughput configuration (~2e-8..5e-7)
  * float32x2 (double-word) — f64-class spectra from float32 arithmetic

(The framework's remaining tiers — float64 JAX compute for CPU x64
parity runs, and the refresh cadence for drift-free endless streams —
are exercised by the CLI parity mode and tests/test_refresh.py.)

Each tier's forward spectra are compared against the native C++ engine
computing in true float64 (the same differential oracle the test suite
gates against), so the residuals are meaningful on ANY backend: the
oracle runs on the host CPU, and the float32x2 row shows its real ~1e-13
class whether or not JAX's x64 mode is on.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import os

import jax

# honor JAX_PLATFORMS even where an installed plugin would pick another
# default (config wins while no backend is initialized)
if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np


def main():
    from sdft_tpu import Plan, Precision, df_to_float64, init_state, sdft
    from sdft_tpu.cplx import to_complex
    from sdft_tpu.oracle import NativeSDFT

    m, M = 512, 2048
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(M), -2, 2).astype(np.float32) / 2

    # float64 reference: the native per-sample C++ engine (true f64 on the
    # host regardless of the JAX backend — the differential oracle of
    # tests/test_gpu.py and scripts/crosscheck.py)
    eng = NativeSDFT(m, "hann", td_bits=64)
    want = eng.sdft(x.astype(np.float64))          # complex128 (M, m)
    scale = np.abs(want).max()

    rows = []

    plan32 = Plan(m, window="hann", precision=Precision("float32", "float32"))
    _, d32 = sdft(plan32, init_state(plan32), x)
    rows.append(("float32 fast path", to_complex(np.asarray(d32))))

    planx2 = Plan(m, window="hann",
                  precision=Precision("float32", "float32x2"))
    _, dx2 = sdft(planx2, init_state(planx2), x)
    packed = df_to_float64((np.asarray(dx2[..., 0]), np.asarray(dx2[..., 1])))
    rows.append(("float32x2 double-word", to_complex(packed)))

    print(f"m={m}, {M} samples, backend={jax.default_backend()}")
    print(f"{'tier':24s} max |err| / scale  (vs f64 native oracle)")
    for name, got in rows:
        err = np.abs(got - want).max() / scale
        print(f"{name:24s} {err:.3e}")


if __name__ == "__main__":
    main()
