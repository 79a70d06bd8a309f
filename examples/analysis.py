"""Tone + chirp analysis example (reference: python/examples/analysis.py;
cpp/examples/analysis.cpp:44-49 uses the same single-tone signal).

Generates one second of a 1 kHz tone plus a 100 Hz -> 10 kHz linear chirp at
44.1 kHz, runs the sliding DFT with m=1000 bins, checks the tone's peak bin
analytically, and renders the dB spectrogram to analysis.png (if matplotlib
is available) — the tone shows as a horizontal line, the chirp as the
rising diagonal.
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

from sdft_tpu import Plan, init_state, sdft, to_complex


def main():
    sr = 44100
    n = sr
    m = 1000
    f = 1000.0

    t = np.arange(n) / sr
    tone = np.sin(2 * np.pi * f * t)
    # linear chirp 100 Hz -> 10 kHz over the second: phase = 2π∫f(τ)dτ
    f0, f1 = 100.0, 10000.0
    chirp = 0.5 * np.sin(2 * np.pi * (f0 * t + 0.5 * (f1 - f0) * t * t / t[-1]))
    x = tone + chirp

    plan = Plan(m, window="hann")
    state = init_state(plan)
    _, dfts = sdft(plan, state, x)
    dfts = to_complex(dfts)

    # the tone's peak bin should sit at f / (sr / (2m)) = f * 2m / sr; probe
    # mid-signal where the chirp (then ~5 kHz) is far from the tone
    mid = n // 2
    lo, hi = 0, int(round(2000.0 * 2 * m / sr))
    mags = np.abs(dfts[mid][lo:hi])
    peak = int(np.argmax(mags))
    expect = int(round(f * 2 * m / sr))
    print(f"tone peak bin {peak} (expected ~{expect}), magnitude {mags[peak]:.4f}")
    assert abs(peak - expect) <= 1, (peak, expect)

    # the chirp's frequency as the SDFT sees it: the window spans the last
    # 2m samples, so the spectrum reflects the chirp ~m samples earlier
    f_inst = f0 + (f1 - f0) * ((mid - m) / n)
    cb = int(round(f_inst * 2 * m / sr))
    w = np.abs(dfts[mid][cb - 10:cb + 11])
    cpk = cb - 10 + int(np.argmax(w))
    print(f"chirp bin at t=0.5s: {cpk} (expected ~{cb})")
    assert abs(cpk - cb) <= 3, (cpk, cb)

    try:
        from sdft_tpu.viz import spectrogram
        ax = spectrogram(dfts[::100], samplerate=sr, hopsize=100)
        ax.figure.savefig("analysis.png", dpi=100)
        print("wrote analysis.png")
    except ImportError:
        print("matplotlib not available; skipping plot")


if __name__ == "__main__":
    main()
