"""Property sweep: randomized odd-shaped configurations vs the naive
per-sample oracle (tests/reference_impl.py — written directly from the
reference spec, c/src/sdft/sdft.h:562-657).

The targeted suites pin the canonical configs; this sweep walks the shape
edges — m not a lane/tile multiple, hops that do not divide the block,
blocks smaller than a tile, latency extremes, every window — through the
full public surface (forward scan, collapsed round trip, hopped analysis,
chained driver protocol) on one deterministic seed per case.
"""

import numpy as np
import pytest

from sdft_tpu import (Plan, Precision, init_state, isdft, roundtrip,
                      roundtrip_hopped, sdft, sdft_hopped)
from tests.reference_impl import NaiveSDFT

F64 = Precision("float64", "float64")

CASES = [
    # (m, window, latency, block, hop)
    (17, "boxcar", 1.0, 23, 5),
    (33, "hann", 0.8, 50, 7),
    (65, "hamming", 0.35, 129, 13),
    (129, "blackman", 1.0, 64, 64),    # block < 2m, hop == block
    (48, "hann", 0.5, 97, 100),        # hop > block: one spectrum per block
    (200, "blackman", 0.6, 401, 3),
]


@pytest.mark.parametrize("m,window,latency,block,hop", CASES)
def test_odd_shapes_vs_naive_oracle(m, window, latency, block, hop):
    plan = Plan(m, window=window, latency=latency, precision=F64)
    rng = np.random.default_rng(m * 7 + block)
    nb = 3
    x = np.clip(rng.standard_normal(nb * block), -3, 3) / 2

    ref = NaiveSDFT(m, window, latency, td=np.float64)
    d_ref = ref.sdft(x)
    y_ref = ref.isdft(d_ref)

    # forward scan + inverse, chained across blocks
    st = init_state(plan)
    ds, ys = [], []
    for b in range(nb):
        blk = x[b * block:(b + 1) * block]
        st, d = sdft(plan, st, blk)
        ds.append(np.asarray(d))
        ys.append(np.asarray(isdft(plan, d)))
    got_d = np.concatenate(ds)
    got_d = got_d[..., 0] + 1j * got_d[..., 1]
    np.testing.assert_allclose(got_d, d_ref, atol=1e-11)
    np.testing.assert_allclose(np.concatenate(ys), y_ref, atol=1e-11)

    # collapsed round trip, same chaining
    st = init_state(plan)
    ys = []
    for b in range(nb):
        st, y = roundtrip(plan, st, x[b * block:(b + 1) * block])
        ys.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(ys), y_ref, atol=1e-11)

    # hopped analysis: first spectrum of every hop, partial last hop included
    st = init_state(plan)
    _, hd = sdft_hopped(plan, st, x, hop)
    hd = np.asarray(hd)
    np.testing.assert_allclose(hd[..., 0] + 1j * hd[..., 1], d_ref[::hop],
                               atol=1e-11)

    # chained driver protocol (block must be a multiple of hop: round down)
    bh = max(hop, (block // hop) * hop)
    n2 = (x.size // (2 * bh)) * 2
    if n2 >= 2:
        xs = x[:n2 * bh].reshape(n2, bh)
        st = init_state(plan)
        st, hd, yy = roundtrip_hopped(plan, st, xs, hop)
        hd = np.asarray(hd).reshape(-1, m, 2)
        np.testing.assert_allclose(hd[..., 0] + 1j * hd[..., 1],
                                   d_ref[:n2 * bh:hop], atol=1e-11)
        np.testing.assert_allclose(np.asarray(yy).reshape(-1),
                                   y_ref[:n2 * bh], atol=1e-11)


from sdft_tpu.kernels import KernelConfig  # noqa: E402

PALLAS_CASES = [
    # (m, window, roi, kwargs) — the spectra kernel across windows, ROI
    # and tilings (bin blocks narrower than m put block edges inside the
    # window stencil)
    (136, "hann", None, dict()),
    (136, "blackman", (3, 130), dict()),
    (256, "hamming", (32, 200), dict(config=KernelConfig(32, 32, 2))),
    (256, "boxcar", None, dict(config=KernelConfig(64, 128, 1))),
    (1000, "hann", None, dict(config=KernelConfig(32, 128, 3))),
]


@pytest.mark.parametrize("m,window,roi,kw", PALLAS_CASES)
def test_pallas_variants_odd_shapes(m, window, roi, kw):
    """The spectra kernel across odd shapes, ROI, tilings and a carried
    (offset != 0) stream, vs the XLA scan path (interpret mode)."""
    from sdft_tpu.kernels import forward_block_pallas
    from sdft_tpu.ops.analysis import sdft_block

    F32 = Precision("float32", "float32")
    plan = Plan(m, window=window, precision=F32, roi=roi)
    rng = np.random.default_rng(m + 3)
    blocks = [int(rng.integers(m // 2, 3 * m)) for _ in range(2)]
    x = np.clip(rng.standard_normal(sum(blocks)), -3, 3).astype(np.float32) / 2

    st_x = st_k = init_state(plan)
    pos = 0
    for blk_len in blocks:
        blk = x[pos:pos + blk_len]
        pos += blk_len
        st_x, d_x = sdft_block(plan, st_x, blk)
        st_k, d_k = forward_block_pallas(plan, st_k, blk, interpret=True,
                                         **kw)
        scale = max(np.abs(np.asarray(d_x)).max(), 1e-6)
        err = np.abs(np.asarray(d_k) - np.asarray(d_x)).max()
        assert err < 1e-3 * scale + 5e-6, (err, scale)
    np.testing.assert_allclose(np.asarray(st_k.accumulator),
                               np.asarray(st_x.accumulator), atol=5e-4)
    np.testing.assert_array_equal(np.asarray(st_k.delayline),
                                  np.asarray(st_x.delayline))
