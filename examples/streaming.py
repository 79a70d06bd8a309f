"""Driver-protocol streaming example: the reference's hop-chunked usage.

The reference test drivers stream hop-sized chunks through persistent plan
state, keeping each hop's first DFT vector (test/test.c:69-83).  On an
accelerator, dispatching one program per hop prices every hop at device
round-trip latency; this example streams the same protocol through
``Streamer.run_hopped``, which groups blocks into ONE compiled program per
chain (api.roundtrip_hopped: a lax.scan over the group).

Verifies the protocol contract as it goes: the chained hop spectra equal a
per-block reference path at 1e-12, and the synthesized stream reconstructs
the input at the algorithmic SNR (~31 dB on noise at latency 1).

    python examples/streaming.py [dftsize] [hop]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import os

import jax

if os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
# a true f64 contract check needs x64 (the CPU and the GPU both compute in
# f64) — the same policy as the CLI parity mode; the tolerance below
# calibrates to what actually ran
jax.config.update("jax_enable_x64", True)

import numpy as np

from sdft_tpu import Plan, Precision, init_state, sdft_hopped, roundtrip
from sdft_tpu.metrics import roundtrip_snr_db
from sdft_tpu.stream import Streamer, iter_blocks


def main(dftsize=256, hop=32):
    sr = 44100
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(40 * hop * 8), -3, 3) / 2
    block = 8 * hop

    plan = Plan(dftsize, window="hann",
                precision=Precision("float64", "float64"))

    streamer = Streamer(plan)
    hops, ys = [], []
    for hd, y in streamer.run_hopped(iter_blocks(x, block), hop, chain=16):
        hops.append(hd)
        ys.append(y)
    y = np.concatenate(ys)
    dfts = np.concatenate(hops)  # (n_hops, m, 2): first spectrum per hop

    # contract check vs the per-block path (one dispatch per block) — at
    # the class of what actually ran: 1e-12 when the f64 plan really
    # computed in f64; the f32 structural-difference class otherwise, where
    # the chained and per-block programs tile differently and agree to
    # ~1e-8
    want = []
    st = init_state(plan)
    for blk in iter_blocks(x, block):
        _, hd = sdft_hopped(plan, st, blk, hop)
        st, _ = roundtrip(plan, st, blk)
        want.append(np.asarray(hd))
    want = np.concatenate(want)
    atol = 1e-12 if jax.config.jax_enable_x64 else 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(dfts, want, atol=atol)

    snr = roundtrip_snr_db(x, y, plan)
    print(f"m={dftsize} hop={hop}: {x.size} samples, "
          f"{dfts.shape[0]} hop spectra, round-trip SNR {snr:.2f} dB")
    assert snr > 25.0, snr
    print("OK")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
