"""Double-word (float32x2) extended FD tier vs the float64 scan path.

The reference's third FD tier is `long double`
(c/src/sdft/sdft.h:21-37,101-125); sdft_tpu reaches the f64 class with
two-float arithmetic from f32 alone (ops.twofloat).  Gates here run on CPU
at the ~1e-13 relative class; the on-card gate lives in tests/test_gpu.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sdft_tpu import Plan, Precision, init_state, sdft
from sdft_tpu.ops.analysis import sdft_block
from sdft_tpu.ops.twofloat import (df_to_float64, sdft_block_df, two_prod,
                                   two_sum)

F64 = Precision("float64", "float64")
XF = Precision("float32", "float32x2")


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(n), -2, 2).astype(np.float32) / 2


def test_error_free_primitives():
    """two_sum / two_prod are error-free transformations under jit (the
    splits are bitmasks, immune to XLA convert folding)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-6).astype(np.float32)
    s, e = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + b.astype(np.float64))
    p, pe = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(pe, np.float64),
        a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.parametrize("window", ["hann", "hamming", "blackman", "boxcar"])
def test_extended_tier_matches_f64(window):
    """Chained blocks of the double-word tier track the f64 scan path at
    the ~1e-13 relative class (the tier's phase tables are f64-exact)."""
    m, M, nb = 64, 160, 3
    plan64 = Plan(m, window=window, precision=F64)
    plan = Plan(m, window=window, precision=Precision("float32", "float32"))
    x = _signal(nb * M, seed=2)

    st64, st = init_state(plan64), init_state(plan)
    for b in range(nb):
        blk = x[b * M:(b + 1) * M]
        st64, d64 = sdft_block(plan64, st64, blk.astype(np.float64))
        st, ddf = sdft_block_df(plan, st, blk)
        got = df_to_float64((ddf[..., 0], ddf[..., 1]))
        scale = np.abs(np.asarray(d64)).max()
        assert np.abs(got - np.asarray(d64)).max() < 1e-13 * scale


def test_extended_tier_roi_and_channels():
    plan64 = Plan(96, window="hann", precision=F64, roi=(8, 60))
    plan = Plan(96, window="hann",
                precision=Precision("float32", "float32"), roi=(8, 60))
    C, M = 2, 200
    x = _signal(C * M, seed=3).reshape(C, M)
    st64 = init_state(plan64, channels=C)
    st = init_state(plan, channels=C)
    st64, d64 = jax.vmap(lambda s, xx: sdft_block(plan64, s, xx)
                         )(st64, jnp.asarray(x, jnp.float64))
    st, ddf = sdft_block_df(plan, st, x)
    got = df_to_float64((ddf[..., 0], ddf[..., 1]))
    scale = np.abs(np.asarray(d64)).max()
    assert np.abs(got - np.asarray(d64)).max() < 1e-13 * scale
    # ROI: bins outside are exactly zero
    assert np.all(got[..., :8, :] == 0)
    assert np.all(got[..., 60:, :] == 0)


def test_extended_tier_drift_free_long_stream():
    """The carry is rebuilt from the delayline every block (refresh
    identity), so error does NOT grow with stream length."""
    m, M, nb = 32, 64, 40
    plan64 = Plan(m, window="hann", precision=F64)
    plan = Plan(m, window="hann", precision=Precision("float32", "float32"))
    x = _signal(nb * M, seed=4)
    st64, st = init_state(plan64), init_state(plan)
    last_err = None
    for b in range(nb):
        blk = x[b * M:(b + 1) * M]
        st64, d64 = sdft_block(plan64, st64, blk.astype(np.float64))
        st, ddf = sdft_block_df(plan, st, blk)
        got = df_to_float64((ddf[..., 0], ddf[..., 1]))
        scale = np.abs(np.asarray(d64)).max()
        last_err = np.abs(got - np.asarray(d64)).max() / scale
    assert last_err < 1e-13      # block 40 as accurate as block 1


@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_extended_tier_isdft_matches_f64(latency):
    """The double-word synthesis leg (isdft_block_df) tracks the f64
    synthesis at ~1e-13: the reference's extended FD tier applies to
    isdft too (c/src/sdft/sdft.h:635-657)."""
    from sdft_tpu.ops.synthesis import isdft_block
    from sdft_tpu.ops.twofloat import isdft_block_df

    m, M = 64, 160
    plan64 = Plan(m, window="hann", precision=F64, latency=latency)
    plan = Plan(m, window="hann",
                precision=Precision("float32", "float32"), latency=latency)
    x = _signal(M, seed=6)
    _, d64 = sdft_block(plan64, init_state(plan64), x.astype(np.float64))
    _, ddf = sdft_block_df(plan, init_state(plan), x)
    y64 = np.asarray(isdft_block(plan64, d64))
    yh, yl = isdft_block_df(plan, ddf)
    got = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    scale = np.abs(y64).max()
    assert np.abs(got - y64).max() < 1e-13 * scale
    # round trip through the public api: correctly-rounded f32 out
    plan_x = Plan(m, window="hann", precision=XF, latency=latency)
    st, d = sdft(plan_x, init_state(plan_x), x)
    from sdft_tpu import isdft

    y_api = np.asarray(isdft(plan_x, d))
    assert y_api.dtype == np.float32
    np.testing.assert_allclose(y_api, y64.astype(np.float32),
                               atol=2e-7 * scale)


def test_extended_tier_api_routing():
    """Precision(fd="float32x2") routes api.sdft to the double-word path;
    dfts gain the trailing (hi, lo) axis."""
    plan = Plan(64, window="hann", precision=XF)
    assert plan.precision.extended
    assert plan.precision.fd_dtype == np.dtype("float32")
    st = init_state(plan)
    assert st.accumulator.dtype == np.dtype("float32")
    st, d = sdft(plan, st, _signal(128, seed=5))
    assert d.shape == (128, 64, 2, 2)
    plan64 = Plan(64, window="hann", precision=F64)
    _, d64 = sdft_block(plan64, init_state(plan64),
                        _signal(128, seed=5).astype(np.float64))
    got = df_to_float64((d[..., 0], d[..., 1]))
    scale = np.abs(np.asarray(d64)).max()
    assert np.abs(got - np.asarray(d64)).max() < 1e-13 * scale
    with pytest.raises(ValueError, match="packed"):
        sdft(plan, init_state(plan), _signal(128), layout="planar")
