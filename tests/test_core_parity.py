"""Differential tests: JAX blockwise path vs the naive per-sample oracle.

Mirrors the reference's cross-implementation strategy (test/main.py:67-79):
independent implementations of the same math must agree to tight tolerance.
"""

import numpy as np
import pytest

import sdft_tpu
from sdft_tpu import Plan, Precision, init_state, isdft, sdft, to_complex

from reference_impl import NaiveSDFT

WINDOWS = ["boxcar", "hann", "hamming", "blackman"]


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.25).clip(-1, 1)


@pytest.mark.parametrize("window", WINDOWS)
def test_forward_matches_oracle(window):
    m = 32
    n = 5 * m  # crosses the 2m phase-reset boundary twice
    x = _signal(n)

    oracle = NaiveSDFT(m, window)
    want = oracle.sdft(x)

    plan = Plan(m, window=window)
    state = init_state(plan)
    state, got = sdft(plan, state, x)

    np.testing.assert_allclose(to_complex(got), want, atol=1e-12, rtol=1e-9)


@pytest.mark.parametrize("latency", [1.0, 0.5, 0.25])
def test_inverse_matches_oracle(latency):
    m = 24
    rng = np.random.default_rng(1)
    dfts = (rng.standard_normal((10, m)) + 1j * rng.standard_normal((10, m))) / m

    oracle = NaiveSDFT(m, "hann", latency)
    want = oracle.isdft(dfts)

    plan = Plan(m, window="hann", latency=latency)
    got = isdft(plan, dfts)

    np.testing.assert_allclose(np.asarray(got), want, atol=1e-6, rtol=1e-5)


def test_chunking_invariance():
    """Processing n samples under any hop partition yields identical output
    (the reference's streaming contract, test/test.c:69-83)."""
    m = 16
    x = _signal(7 * m + 3)
    plan = Plan(m)

    state = init_state(plan)
    _, whole = sdft(plan, state, x)

    for hops in ([1] * len(x), [5, 31, 64, 3, len(x) - 103]):
        state = init_state(plan)
        parts = []
        i = 0
        for h in hops:
            state, d = sdft(plan, state, x[i:i + h])
            parts.append(np.asarray(d))
            i += h
        chunked = np.concatenate(parts)
        np.testing.assert_allclose(chunked, np.asarray(whole), atol=1e-12, rtol=1e-9)


def test_reset_semantics():
    """reset reproduces time zero exactly (c/src/sdft/sdft.h:517-529)."""
    m = 16
    x = _signal(3 * m)
    plan = Plan(m)

    state = init_state(plan)
    state, first = sdft(plan, state, x)
    state = sdft_tpu.reset_state(plan, state)
    _, second = sdft(plan, state, x)

    np.testing.assert_array_equal(np.asarray(first), np.asarray(second))


def test_endless_stream_phase_exactness():
    """After many 2m periods the phases must not drift: feeding the same
    periodic input must yield the same spectrum at the same phase position."""
    m = 8
    plan = Plan(m, window="boxcar")
    period = 2 * m
    x = _signal(period)

    state = init_state(plan)
    outs = []
    for _ in range(50):  # 50 periods = 800 samples
        state, d = sdft(plan, state, x)
        outs.append(np.asarray(d))
    # Steady state is reached once the delayline is full (after 1 period);
    # from then on every period must be bit-identical (exact phases, and the
    # accumulator returns to the same value since deltas cancel periodically).
    for k in range(2, 50):
        np.testing.assert_allclose(outs[k], outs[1], atol=1e-12)


def test_multichannel_vmap_matches_loop():
    m = 16
    C = 3
    rng = np.random.default_rng(2)
    x = rng.standard_normal((C, 4 * m)).clip(-1, 1)
    plan = Plan(m)

    state = init_state(plan, channels=C)
    state, got = sdft(plan, state, x)

    for c in range(C):
        st = init_state(plan)
        _, want = sdft(plan, st, x[c])
        np.testing.assert_allclose(np.asarray(got[c]), np.asarray(want), atol=1e-12)


def _snr_db(x, y, delay):
    """Reference quality metric (python/examples/latency.py:50-57)."""
    from sdft_tpu.metrics import roundtrip_snr_db
    return roundtrip_snr_db(x, y, delay=delay)


@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_roundtrip_snr_matches_oracle(latency):
    """Round-trip SNR must equal the oracle's SNR on the same signal.

    The SDFT round trip is windowed, not perfect reconstruction — on white
    noise at m=64 the reference itself yields ~19.5 dB (latency 1) — so the
    gate is parity with the oracle, not an absolute SNR.
    """
    m = 64
    n = 40 * m
    x = _signal(n, seed=3)
    plan = Plan(m, window="hann", latency=latency)

    state = init_state(plan)
    _, dfts = sdft(plan, state, x)
    y = np.asarray(isdft(plan, dfts), dtype=np.float64)

    oracle = NaiveSDFT(m, "hann", latency)
    y_ref = oracle.isdft(oracle.sdft(x)).astype(np.float64)

    np.testing.assert_allclose(y, y_ref, atol=1e-6)
    snr = _snr_db(x, y, plan.synthesis_delay)
    snr_ref = _snr_db(x, y_ref, plan.synthesis_delay)
    assert abs(snr - snr_ref) < 0.01, (snr, snr_ref)
    # sanity floor: the round trip is meaningful, not garbage
    assert snr > 15.0


def test_float32_fd_precision_close_to_float64():
    m = 32
    x = _signal(6 * m)
    p64 = Plan(m)
    p32 = Plan(m, precision=Precision(td="float32", fd="float32"))

    _, d64 = sdft(p64, init_state(p64), x)
    _, d32 = sdft(p32, init_state(p32), x)

    np.testing.assert_allclose(np.asarray(d32), np.asarray(d64), atol=5e-5)


def test_roundtrip_transform_identity_matches_lti():
    """roundtrip(transform=identity) == sdft -> isdft == LTI roundtrip."""
    from sdft_tpu import roundtrip

    m = 32
    x = _signal(6 * m, seed=7)
    plan = Plan(m, window="hann")

    st_a, y_a = roundtrip(plan, init_state(plan), x)
    st_b, y_b = roundtrip(plan, init_state(plan), x, transform=lambda z: z)

    np.testing.assert_allclose(np.asarray(y_b), np.asarray(y_a), atol=1e-9)
    np.testing.assert_allclose(np.asarray(st_b.accumulator),
                               np.asarray(st_a.accumulator), atol=1e-12)


def test_roundtrip_transform_matches_manual_chain():
    """A lowpass spectral transform equals the hand-written
    sdft -> modify -> isdft chain, single and multi channel."""
    from sdft_tpu import roundtrip

    m = 32
    plan = Plan(m, window="hann")
    mask = (np.arange(m) < m // 2).astype(np.float64)

    def lowpass(z):
        return z * mask

    for C in (None, 3):
        n = 6 * m
        x = _signal((n if C is None else C * n), seed=11)
        if C is not None:
            x = x.reshape(C, n)
        state = init_state(plan, channels=C) if C else init_state(plan)

        st_t, y_t = roundtrip(plan, state, x, transform=lowpass)

        st_m, d = sdft(plan, state, x)
        z = to_complex(np.asarray(d)) * mask
        y_m = np.asarray(isdft(plan, z.astype(np.complex128)))

        np.testing.assert_allclose(np.asarray(y_t), y_m, atol=1e-9)
        np.testing.assert_allclose(np.asarray(st_t.accumulator),
                                   np.asarray(st_m.accumulator), atol=1e-12)


def test_roundtrip_transform_shape_guard():
    from sdft_tpu import roundtrip

    plan = Plan(16)
    x = _signal(32)
    with pytest.raises(ValueError, match="preserve the spectra shape"):
        roundtrip(plan, init_state(plan), x, transform=lambda z: z[..., :4])


def test_large_dftsize_int64_phases():
    """m > 32768 (the int32 exact-phase limit) promotes exponent products to
    int64 under x64 — the reference allocates any size
    (c/src/sdft/sdft.h:413-450).  Gate m=65536 against the native oracle."""
    from sdft_tpu import Plan, Precision, init_state, roundtrip, sdft_hopped
    from sdft_tpu.oracle import NativeSDFT

    m, M, hop = 65536, 256, 64
    plan = Plan(m, window="hann",
                precision=Precision("float64", "float64"))
    rng = np.random.default_rng(17)
    x = np.clip(rng.standard_normal(M), -3, 3) / 2

    eng = NativeSDFT(m, "hann", td_bits=64)
    want = eng.sdft(x)
    y_want = eng.isdft(want)

    st = init_state(plan)
    _, hd = sdft_hopped(plan, st, x, hop)
    got = np.asarray(hd)[..., 0] + 1j * np.asarray(hd)[..., 1]
    np.testing.assert_allclose(got, want[::hop], atol=1e-12)

    st, y = roundtrip(plan, st, x)
    np.testing.assert_allclose(np.asarray(y), y_want, atol=1e-12)


def test_mulmod_int32_exact():
    """mulmod keeps (e * i) mod 2m exact in int32 for any m up to 2^19 —
    including the padded-bin-axis factors beyond m-1 and negative indices —
    where the direct product would overflow."""
    import jax.numpy as jnp
    from sdft_tpu.ops.twiddle import MAX_INT32_DFTSIZE, exponent_dtype, mulmod

    rng = np.random.default_rng(5)
    for m in (4096, 32768, 65536, MAX_INT32_DFTSIZE):
        n2 = 2 * m
        assert exponent_dtype(m) == jnp.int32
        e = rng.integers(0, n2, size=64)
        i = rng.integers(-n2, 2 * n2, size=64)
        got = np.asarray(mulmod(jnp.asarray(e, jnp.int32)[:, None],
                                jnp.asarray(i, jnp.int32)[None, :], n2))
        want = (e[:, None] * (i[None, :] % n2)) % n2
        np.testing.assert_array_equal(got, want)


def test_large_dftsize_f32_fast_path():
    """m = 65536 runs on the f32 fast path with int32 two-level phases —
    exponent_dtype never forces x64 below 2^19 bins (the reference
    allocates any dftsize, c/src/sdft/sdft.h:413-450).  Gated against the
    f64 native oracle at the f32 phase-resolution tolerance."""
    from sdft_tpu import Plan, Precision, init_state, roundtrip, sdft_hopped
    from sdft_tpu.oracle import NativeSDFT

    m, M, hop = 65536, 256, 64
    plan = Plan(m, window="hann", precision=Precision("float32", "float32"))
    rng = np.random.default_rng(18)
    x = np.clip(rng.standard_normal(M), -3, 3).astype(np.float32) / 2

    eng = NativeSDFT(m, "hann", td_bits=64)
    want = eng.sdft(x.astype(np.float64))
    y_want = eng.isdft(want)

    st = init_state(plan)
    _, hd = sdft_hopped(plan, st, x, hop)
    got = np.asarray(hd)[..., 0] + 1j * np.asarray(hd)[..., 1]
    # f32 phase-resolution class: the trig argument rounds at ~2^-23 * 2pi,
    # so a 256-sample stream accumulates ~5e-4 of the (tiny, barely-ramped)
    # spectrum scale (measured 5.3e-4; the f64 x64 path above is 1e-12)
    scale = np.abs(want).max()
    assert np.abs(got - want[::hop]).max() < 2e-3 * scale

    st, y = roundtrip(plan, st, x)
    # y is a near-total cancellation over 65536 bins this early in the
    # window; gate against the driving amplitude (measured 3.5e-9)
    assert np.abs(np.asarray(y) - y_want).max() < 1e-6 * np.abs(x).max()


def test_interleaved_frame_adapter():
    """(M, C) interleaved frames round-trip through the sdft_sdft_nd-layout
    adapters (c/src/sdft/sdft.h:615-633,676-694) identically to the
    channel-major batch."""
    from sdft_tpu import (Plan, init_state, isdft, isdft_interleaved, sdft,
                          sdft_interleaved)

    plan = Plan(32)
    C, M = 3, 96
    rng = np.random.default_rng(9)
    frames = rng.standard_normal((M, C))

    st = init_state(plan, channels=C)
    st_i, d_i = sdft_interleaved(plan, st, frames)
    st_c, d_c = sdft(plan, st, np.ascontiguousarray(frames.T))
    np.testing.assert_array_equal(np.asarray(d_i), np.asarray(d_c))
    np.testing.assert_array_equal(np.asarray(st_i.accumulator),
                                  np.asarray(st_c.accumulator))

    y_i = np.asarray(isdft_interleaved(plan, d_i))
    assert y_i.shape == (M, C)
    np.testing.assert_array_equal(y_i, np.asarray(isdft(plan, d_c)).T)

    import pytest as _pytest
    with _pytest.raises(ValueError, match="interleaved"):
        sdft_interleaved(plan, init_state(plan), frames[:, 0])


def test_oracle_extended_fd_tier():
    """The native engine's fd_bits=80 (x86 long double) tier — the
    counterpart of the reference's SDFT_FD_* long double
    (c/src/sdft/sdft.h:21-37,101-125) — agrees with the double tier to
    f64 rounding while being a genuinely distinct accumulation path."""
    from sdft_tpu.oracle import NativeSDFT

    rng = np.random.default_rng(11)
    x = rng.standard_normal(4096)
    e64 = NativeSDFT(128, "hann", td_bits=64)
    e80 = NativeSDFT(128, "hann", td_bits=64, fd_bits=80)
    d64 = e64.sdft(x)
    d80 = e80.sdft(x)
    diff = np.abs(d64 - d80).max()
    assert 0 < diff < 1e-12
    np.testing.assert_allclose(e64.isdft(d64), e80.isdft(d80), atol=1e-12)
