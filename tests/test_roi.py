"""ROI (bin-range) restriction tests.

The reference carries a per-plan half-open bin range, always full-band
(analysis.roi/synthesis.roi, c/src/sdft/sdft.h:425-426); here it is public.
Contract: bins outside the ROI are never accumulated and read as zero; bins
inside the ROI and at least one window-halo away from its edges are exactly
the full-band result (edge bins differ because their zeroed neighbors feed
the window convolution — same as the reference's untouched buffer cells).
"""

import numpy as np
import pytest

from sdft_tpu import Plan, init_state, isdft, sdft, to_complex
from sdft_tpu.windows import WINDOW_HALO


@pytest.mark.parametrize("window", ["boxcar", "hann", "blackman"])
def test_roi_matches_full_band_interior(window):
    m, M = 64, 96
    first, last = 10, 40
    rng = np.random.default_rng(0)
    x = rng.standard_normal(M)

    full = Plan(m, window=window)
    part = full.with_(roi=(first, last))
    assert part.roi_bins == (first, last)

    _, d_full = sdft(full, init_state(full), x)
    _, d_part = sdft(part, init_state(part), x)
    d_full = to_complex(d_full)
    d_part = to_complex(d_part)

    # outside ROI: exactly zero
    assert np.all(d_part[:, :first] == 0)
    assert np.all(d_part[:, last:] == 0)

    # interior of ROI: identical to full band
    h = WINDOW_HALO[part.window]
    lo, hi = first + h, last - h
    np.testing.assert_allclose(d_part[:, lo:hi], d_full[:, lo:hi],
                               rtol=0, atol=1e-12)


def test_roi_synthesis_reduces_over_roi_only():
    m, M = 32, 64
    plan = Plan(m, window="hann", roi=(4, 20))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(M)
    st, d = sdft(plan, init_state(plan), x)
    y = np.asarray(isdft(plan, d))

    # equivalent: full-band synthesis of spectra zeroed outside the ROI
    full = plan.with_(roi=None)
    d_z = np.asarray(d).copy()
    d_z[:, :4] = 0
    d_z[:, 20:] = 0
    y_ref = np.asarray(isdft(full, d_z))
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-6)


def test_roi_validation():
    with pytest.raises(ValueError):
        Plan(32, roi=(5, 5))
    with pytest.raises(ValueError):
        Plan(32, roi=(-1, 5))
    with pytest.raises(ValueError):
        Plan(32, roi=(0, 33))
    # full-band roi canonicalizes to None (same jit cache key)
    assert Plan(32, roi=(0, 32)) == Plan(32)


@pytest.mark.parametrize("axes", [
    dict(channel=1, time=1, bins=8),
    dict(channel=1, time=8, bins=1),
    dict(channel=2, time=2, bins=2),
], ids=lambda a: "x".join(map(str, a.values())))
def test_roi_sharded_matches_unsharded(axes):
    """ROI under sharded execution: shards fully outside the ROI contribute
    zeros; results equal the unsharded ROI path on every mesh factorization
    (ROI on the fast paths)."""
    import jax

    from sdft_tpu.ops.lti import roundtrip_block_lti, sdft_hopped
    from sdft_tpu.parallel import (make_mesh, sharded_roundtrip, sharded_sdft,
                                   sharded_sdft_hopped)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    m = 32
    C, M, hop = 2, 8 * 2 * m, 32
    plan = Plan(m, window="hann", roi=(5, 21))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((C, M))
    mesh = make_mesh(**axes)

    # forward scan form
    ref_state, ref_dfts = sdft(plan, init_state(plan, channels=C), x)
    st, dfts = sharded_sdft(plan, mesh, init_state(plan, channels=C), x)
    np.testing.assert_allclose(np.asarray(dfts), np.asarray(ref_dfts),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(st.accumulator),
                               np.asarray(ref_state.accumulator), atol=1e-12)

    # collapsed round trip (ROI folded into the LTI constants)
    ref_st2, ref_y = roundtrip_block_lti(plan, init_state(plan, channels=C), x)
    st2, y = sharded_roundtrip(plan, mesh, init_state(plan, channels=C), x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref_y), atol=1e-12)
    np.testing.assert_allclose(np.asarray(st2.accumulator),
                               np.asarray(ref_st2.accumulator), atol=1e-12)

    # hopped driver protocol
    _, ref_hd = sdft_hopped(plan, init_state(plan, channels=C), x, hop)
    _, hd = sharded_sdft_hopped(plan, mesh, init_state(plan, channels=C), x,
                                hop)
    np.testing.assert_allclose(np.asarray(hd), np.asarray(ref_hd), atol=1e-12)

    # degenerate hop (stepped tiles): ROI folds into the stepped tables
    _, ref_h4 = sdft_hopped(plan, init_state(plan, channels=C), x, 4)
    _, h4 = sharded_sdft_hopped(plan, mesh, init_state(plan, channels=C), x,
                                4)
    np.testing.assert_allclose(np.asarray(h4), np.asarray(ref_h4),
                               atol=1e-12)
