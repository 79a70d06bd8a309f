"""Latency vs SNR trade-off example (reference: python/examples/latency.py).

Round trips truncated-normal noise through sdft/isdft at several synthesis
latency factors and reports the SNR in dB after removing the (m-1)*latency
sample algorithmic delay — demonstrating that lower latency costs SNR
(c/src/sdft/sdft.h:408-410).
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

from sdft_tpu import Plan, init_state, isdft, sdft
from sdft_tpu.metrics import roundtrip_snr_db


def main():
    sr = 44100
    n = sr
    m = 1000

    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(n), -2, 2) / 2

    for latency in (1.0, 0.75, 0.5, 0.25):
        plan = Plan(m, window="hann", latency=latency)
        state = init_state(plan)
        _, dfts = sdft(plan, state, x)
        y = np.asarray(isdft(plan, dfts), dtype=np.float64)
        print(f"latency {latency:4.2f}: delay {plan.synthesis_delay:5d} samples, "
              f"SNR {roundtrip_snr_db(x, y, plan):6.2f} dB")


if __name__ == "__main__":
    main()
