"""The spectra kernel (Pallas/Triton, interpret mode on the CPU) vs the XLA
reference path, and the rule that dispatches to it."""

import numpy as np
import pytest

from sdft_tpu import Plan, Precision, init_state, sdft
from sdft_tpu.kernels import (
    KernelConfig,
    forward_block_pallas,
    forward_block_power,
    plan_supported,
    use_kernel,
)
from sdft_tpu.kernels.spectra_triton import (
    MAX_KERNEL_DFTSIZE,
    MAX_OUTPUT_ELEMENTS,
    fits,
)

F32 = Precision(td="float32", fd="float32")


def _signal(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n).clip(-1, 1).astype(np.float32)


def _accumulator_f64(m, x):
    """f64 oracle for the carried accumulator after one block from rest:
    acc[i] = sum_k delta[k] * T_i^((k) mod 2m) with delta = x - x[k-2m]."""
    n2 = 2 * m
    x = np.asarray(x, np.float64)
    delta = x - np.pad(x, (n2, 0))[: x.size]
    k = np.arange(x.size)
    i = np.arange(m)
    ph = np.exp(-1j * (np.pi / m) * ((k[:, None] * i[None, :]) % n2))
    acc = (delta[:, None] * ph).sum(axis=0)
    return np.stack([acc.real, acc.imag], axis=-1)


@pytest.mark.parametrize("window", ["boxcar", "hann", "hamming", "blackman"])
def test_forward_kernel_matches_xla(window):
    m = 256
    M = 3 * 128
    x = _signal(M)
    plan = Plan(m, window=window, precision=F32)
    assert plan_supported(plan)

    state = init_state(plan)
    want_state, want = sdft(plan, state, x)

    got_state, got = forward_block_pallas(plan, state, x, interpret=True)

    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=2e-6, rtol=1e-4)
    # The carried accumulator is an f32 sum over the whole block; the
    # kernel's prologue and XLA's cumsum reduce in different orders, so gate
    # each against the f64 oracle with an eps-proportional bound
    # (k * eps32 * M covers any summation order of M unit-bounded terms)
    # instead of widening the pairwise tolerance.
    acc64 = _accumulator_f64(m, x)
    bound = 4 * np.finfo(np.float32).eps * M
    for acc in (got_state.accumulator, want_state.accumulator):
        err = np.abs(np.asarray(acc, np.float64) - acc64).max()
        assert err < bound, (err, bound)
    assert int(got_state.offset) == int(want_state.offset)
    np.testing.assert_array_equal(np.asarray(got_state.delayline),
                                  np.asarray(want_state.delayline))


def test_kernel_streaming_carry():
    """Two kernel blocks chain identically to one (offset + acc carry),
    including across the 2m phase boundary."""
    m = 256
    M = 4 * 128  # 512 = 2m: second block starts exactly at the phase reset
    x = _signal(2 * M, seed=2)
    plan = Plan(m, precision=F32)

    state = init_state(plan)
    _, want = sdft(plan, state, x)
    want = np.asarray(want)

    state = init_state(plan)
    state, d1 = forward_block_pallas(plan, state, x[:M], interpret=True)
    state, d2 = forward_block_pallas(plan, state, x[M:], interpret=True)
    got = np.concatenate([np.asarray(d1), np.asarray(d2)])

    np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-4)


def test_planar_layout_matches_packed():
    """layout="planar" is the same spectra without the interleaving — on
    both the kernel and the XLA path (api.sdft)."""
    m = 256
    M = 2 * 128
    x = _signal(M, seed=3)
    plan = Plan(m, precision=F32)

    state = init_state(plan)
    st_p, packed = forward_block_pallas(plan, state, x, interpret=True)
    st_q, (re, im) = forward_block_pallas(plan, state, x, interpret=True,
                                          layout="planar")
    packed = np.asarray(packed)
    np.testing.assert_array_equal(np.asarray(re), packed[..., 0])
    np.testing.assert_array_equal(np.asarray(im), packed[..., 1])
    np.testing.assert_array_equal(np.asarray(st_q.accumulator),
                                  np.asarray(st_p.accumulator))

    # XLA path through the public API (CPU backend -> no kernel)
    _, packed_api = sdft(plan, state, x)
    _, (re2, im2) = sdft(plan, state, x, layout="planar")
    np.testing.assert_array_equal(np.asarray(re2),
                                  np.asarray(packed_api)[..., 0])
    np.testing.assert_array_equal(np.asarray(im2),
                                  np.asarray(packed_api)[..., 1])

    # batched planar
    xs = np.stack([x, _signal(M, seed=4)])
    states = init_state(plan, channels=2)
    _, packed_b = sdft(plan, states, xs)
    _, (re3, im3) = sdft(plan, states, xs, layout="planar")
    np.testing.assert_array_equal(np.asarray(re3),
                                  np.asarray(packed_b)[..., 0])
    np.testing.assert_array_equal(np.asarray(im3),
                                  np.asarray(packed_b)[..., 1])


def test_plan_supported_gates():
    assert not plan_supported(Plan(100, precision=F32))     # m < 128
    assert not plan_supported(Plan(256))                    # f64 fd
    # ROI plans are in the kernel (masks fold into the tables and edges)
    assert plan_supported(Plan(256, precision=F32, roi=(0, 128)))
    # 128 <= m <= MAX_KERNEL_DFTSIZE (bins tiled, internal padding)
    assert plan_supported(Plan(256, precision=F32))
    assert plan_supported(Plan(1000, precision=F32))      # canonical m
    assert plan_supported(Plan(4096, precision=F32))
    assert plan_supported(Plan(MAX_KERNEL_DFTSIZE, precision=F32))
    # beyond the largest m checked on the card
    assert not plan_supported(Plan(MAX_KERNEL_DFTSIZE + 1, precision=F32))
    assert not plan_supported(Plan(1 << 17, precision=F32))


@pytest.mark.parametrize("m", [256, 1000, 4096, MAX_KERNEL_DFTSIZE])
def test_block_fits_int32_output(m):
    """One call's output, counted as packed (two values per bin, all
    channels), stays within the int32 offsets the kernel indexes with."""
    plan = Plan(m, precision=F32)
    n = MAX_OUTPUT_ELEMENTS // (2 * m)
    assert fits(plan, n) and not fits(plan, n + 1)
    assert use_kernel(plan, n, platform="gpu")
    assert not use_kernel(plan, n + 1, platform="gpu")
    # the kernel's own entry points refuse what does not fit, before any
    # work (the XLA composition takes such calls)
    with pytest.raises(ValueError, match="int32 output range"):
        forward_block_pallas(plan, init_state(plan),
                             np.zeros(n + 1, np.float32), interpret=True)
    with pytest.raises(ValueError, match="int32 output range"):
        forward_block_power(plan, init_state(plan),
                            np.zeros(n + 1, np.float32), interpret=True)


def test_bf16_spectra_output():
    """spectra_dtype="bfloat16" emits bf16 planes that round the f32 result
    (the half-write fast path), on the kernel and the XLA path."""
    import jax.numpy as jnp

    m = 256
    M = 2 * 128
    x = _signal(M, seed=5)
    plan = Plan(m, precision=F32)
    state = init_state(plan)

    st32, (re32, im32) = forward_block_pallas(plan, state, x, interpret=True,
                                              layout="planar")
    st16, (re16, im16) = forward_block_pallas(plan, state, x, interpret=True,
                                              layout="planar",
                                              out_dtype="bfloat16")
    assert re16.dtype == jnp.bfloat16 and im16.dtype == jnp.bfloat16
    # the sums stay f32: bf16 output equals the rounded f32 planes exactly
    np.testing.assert_array_equal(
        np.asarray(re16), np.asarray(np.asarray(re32).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(np.asarray(st16.accumulator),
                                  np.asarray(st32.accumulator))

    # packed layout would re-read the spectra; rejected
    with pytest.raises(ValueError, match="planar"):
        forward_block_pallas(plan, state, x, interpret=True,
                             out_dtype="bfloat16")

    # XLA path via the public API
    _, (re_a, im_a) = sdft(plan, state, x, layout="planar",
                           spectra_dtype="bfloat16")
    assert re_a.dtype == jnp.bfloat16
    with pytest.raises(ValueError, match="planar"):
        sdft(plan, state, x, spectra_dtype="bfloat16")


@pytest.mark.parametrize("m,M,window", [
    (1000, 2100, "hann"),       # the reference's canonical dftsize
    (136, 384, "blackman"),     # odd m, halo 2
    (256, 500, "hamming"),      # partial final tile
])
def test_unaligned_m_and_block(m, M, window):
    """The kernel pads the bin axis to whole bin blocks and the time axis to
    whole tiles internally; outputs and carry must still match the XLA scan
    path (reference canonical config: test/main.sh:3)."""
    from sdft_tpu.ops.analysis import sdft_block

    plan = Plan(m, window=window, precision=F32)
    x = _signal(M, seed=11)
    st0 = init_state(plan)

    st_k, d_k = forward_block_pallas(plan, st0, x, interpret=True)
    st_x, d_x = sdft_block(plan, st0, x)
    np.testing.assert_allclose(np.asarray(d_k), np.asarray(d_x), atol=5e-6)
    np.testing.assert_allclose(np.asarray(st_k.accumulator),
                               np.asarray(st_x.accumulator), atol=5e-4)
    np.testing.assert_array_equal(np.asarray(st_k.delayline),
                                  np.asarray(st_x.delayline))


@pytest.mark.parametrize("m,M,window", [
    (256, 500, "hann"),
    (1000, 2100, "blackman"),
    (136, 384, "hamming"),
    (256, 384, "boxcar"),
])
def test_toepconv_kernel_matches_xla(m, M, window):
    """The Toeplitz spectra kernel at a non-default tiling (more sub-tiles
    per program, narrower bin blocks) matches the XLA scan path on every
    window, including partial tiles and partial programs."""
    from sdft_tpu.ops.analysis import sdft_block

    plan = Plan(m, window=window, precision=F32)
    x = _signal(M, seed=21)
    st0 = init_state(plan)
    st_x, d_x = sdft_block(plan, st0, x)
    st_k, d_k = forward_block_pallas(
        plan, st0, x, interpret=True,
        config=KernelConfig(tile_k=64, block_n=64, super_r=4))
    np.testing.assert_allclose(np.asarray(d_k), np.asarray(d_x), atol=5e-6)
    np.testing.assert_allclose(np.asarray(st_k.accumulator),
                               np.asarray(st_x.accumulator), atol=5e-4)
    np.testing.assert_array_equal(np.asarray(st_k.delayline),
                                  np.asarray(st_x.delayline))


@pytest.mark.parametrize("roi", [(10, 100), (0, 200), (30, 256), (64, 128)])
def test_toepconv_roi_matches_xla(roi):
    """ROI on the kernel: the accumulate mask folds into the totals table,
    the output mask into the store, and the bins inside each ROI edge are
    recomputed exactly; parity vs the XLA ROI semantics."""
    from sdft_tpu.ops.analysis import sdft_block

    plan = Plan(256, window="hann", precision=F32, roi=roi)
    x = _signal(500, seed=22)
    st0 = init_state(plan)
    st_x, d_x = sdft_block(plan, st0, x)
    st_k, d_k = forward_block_pallas(
        plan, st0, x, interpret=True,
        config=KernelConfig(tile_k=64, block_n=128, super_r=2))
    np.testing.assert_allclose(np.asarray(d_k), np.asarray(d_x), atol=5e-6)
    np.testing.assert_allclose(np.asarray(st_k.accumulator),
                               np.asarray(st_x.accumulator), atol=5e-4)
    # bins outside the ROI are exactly zero
    got = np.asarray(d_k)
    first, last = roi
    assert np.all(got[:, :first] == 0)
    assert np.all(got[:, last:] == 0)


@pytest.mark.parametrize("window,roi,block_n", [
    ("hann", None, 32),
    ("blackman", None, 16),
    ("blackman", (32, 97), 32),     # ROI edges on and next to a tile edge
    ("hamming", (15, 64), 16),
])
def test_bin_tile_halo_edges(window, roi, block_n):
    """Narrow bin blocks put block edges inside the window stencil: the
    carry stencil reads c0 across the block boundary and must still match
    the XLA path at every bin, including ROI edges at block edges."""
    from sdft_tpu.ops.analysis import sdft_block

    plan = Plan(128, window=window, precision=F32, roi=roi)
    x = _signal(300, seed=23)
    st0 = init_state(plan)
    st_x, d_x = sdft_block(plan, st0, x)
    st_x, d_x2 = sdft_block(plan, st_x, x[::-1].copy())
    cfg = KernelConfig(tile_k=32, block_n=block_n, super_r=2)
    st_k, d_k = forward_block_pallas(plan, st0, x, interpret=True,
                                     config=cfg)
    st_k, d_k2 = forward_block_pallas(plan, st_k, x[::-1].copy(),
                                      interpret=True, config=cfg)
    scale = np.abs(np.asarray(d_x)).max()
    for got, want in ((d_k, d_x), (d_k2, d_x2)):
        err = np.abs(np.asarray(got) - np.asarray(want)).max(axis=(0, 2))
        assert err.max() < 3e-6 * scale, (np.argmax(err), err.max() / scale)


def test_fix_columns():
    """The exactly recomputed bins: the top `halo` bins, and the `halo`
    bins inside each ROI edge; none for boxcar."""
    from sdft_tpu.kernels.spectra_triton import fix_columns

    assert fix_columns(Plan(256, window="boxcar", precision=F32)) == ()
    assert fix_columns(Plan(256, window="hann", precision=F32)) == (255,)
    assert fix_columns(Plan(256, window="blackman", precision=F32)) == (
        254, 255)
    assert fix_columns(Plan(256, window="hann", precision=F32,
                            roi=(10, 100))) == (10, 99)
    assert fix_columns(Plan(256, window="blackman", precision=F32,
                            roi=(0, 256))) == (254, 255)
    assert fix_columns(Plan(256, window="blackman", precision=F32,
                            roi=(30, 256))) == (30, 31, 254, 255)


def test_dispatch_rule(monkeypatch):
    """GPU means the kernel where plan_supported; the CPU means XLA, and
    the public API never runs the kernel (interpreted or not) there."""
    import sdft_tpu.api as api
    from sdft_tpu.kernels import kernel_platform

    plan = Plan(256, precision=F32)
    assert use_kernel(plan, 256, platform="gpu")
    assert not use_kernel(plan, 256, platform="cpu")
    assert not use_kernel(Plan(256), 256, platform="gpu")       # f64
    assert not use_kernel(Plan(64, precision=F32), 256, platform="gpu")
    assert not kernel_platform()          # the test tier runs on the CPU

    def boom(*a, **k):
        raise AssertionError("kernel dispatched on the CPU")

    monkeypatch.setattr(api, "forward_block_pallas", boom)
    x = _signal(256, seed=24)
    api.sdft(plan, init_state(plan), x)
    api.sdft(plan, init_state(plan, channels=2), np.stack([x, x]))
    api.sdft_power(plan, init_state(plan), x)


def _hop1_reference(plan, xs):
    """Every sample's spectrum (sdft_block) and the collapsed round trip,
    block by block with the per-block refresh — the per-sample XLA paths
    the hop=1 driver chain must equal."""
    import jax

    from sdft_tpu.ops.analysis import sdft_block
    from sdft_tpu.ops.lti import refresh_state_any, roundtrip_block_lti

    batched = xs.ndim == 3
    st = init_state(plan, channels=xs.shape[1] if batched else None)
    hds, ys = [], []
    for x in xs:
        if batched:
            _, d = jax.vmap(lambda s, xx: sdft_block(plan, s, xx))(st, x)
        else:
            _, d = sdft_block(plan, st, x)
        st, y = roundtrip_block_lti(plan, st, x)
        st = refresh_state_any(plan, st)
        hds.append(np.asarray(d))
        ys.append(np.asarray(y))
    return st, np.stack(hds), np.stack(ys)


def test_hop1_pallas_chain_matches_stepped():
    """The hop=1 driver chain (api.roundtrip_hopped: the stepped fused XLA
    body, which beat the kernel route on the card — PERF.md) equals the
    per-sample spectra and the collapsed round trip at the f32 class,
    including the carried state and the channel-batched form."""
    from sdft_tpu import roundtrip_hopped

    plan = Plan(256, window="hann", precision=F32)
    nb, B = 3, 384
    xs = _signal(nb * B, seed=29).astype(np.float32).reshape(nb, B)

    st_r, hd_r, ys_r = _hop1_reference(plan, xs)
    st_p, hd_p, ys_p = roundtrip_hopped(plan, init_state(plan), xs, 1)
    assert hd_p.shape == hd_r.shape == (nb, B, 256, 2)
    scale = np.abs(hd_r).max()
    assert np.abs(np.asarray(hd_p) - hd_r).max() < 5e-6 * scale
    np.testing.assert_allclose(np.asarray(ys_p), ys_r, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_p.accumulator),
                               np.asarray(st_r.accumulator), atol=1e-4)

    # channel-batched form
    C = 2
    xs_c = _signal(nb * C * B, seed=30).astype(np.float32).reshape(nb, C, B)
    st_r, hd_r, ys_r = _hop1_reference(plan, xs_c)
    st_p, hd_p, ys_p = roundtrip_hopped(plan, init_state(plan, channels=C),
                                        xs_c, 1)
    scale = np.abs(hd_r).max()
    assert np.abs(np.asarray(hd_p) - hd_r).max() < 5e-6 * scale
    np.testing.assert_allclose(np.asarray(ys_p), ys_r, atol=1e-5)


@pytest.mark.parametrize("roi", [(10, 100), (30, 256), (64, 128)])
def test_hop1_pallas_chain_roi_matches_stepped(roi):
    """ROI through the hop=1 driver chain: bins outside the ROI are exactly
    zero and the rest match the per-sample XLA spectra."""
    from sdft_tpu import roundtrip_hopped

    plan = Plan(256, window="hann", precision=F32, roi=roi)
    nb, B = 2, 384
    xs = _signal(nb * B, seed=31).astype(np.float32).reshape(nb, B)

    st_r, hd_r, ys_r = _hop1_reference(plan, xs)
    st_p, hd_p, ys_p = roundtrip_hopped(plan, init_state(plan), xs, 1)
    scale = np.abs(hd_r).max()
    assert np.abs(np.asarray(hd_p) - hd_r).max() < 5e-6 * scale
    first, last = roi
    assert np.all(np.asarray(hd_p)[..., :first, :] == 0)
    assert np.all(np.asarray(hd_p)[..., last:, :] == 0)
    np.testing.assert_allclose(np.asarray(ys_p), ys_r, atol=1e-5)
    np.testing.assert_allclose(np.asarray(st_p.accumulator),
                               np.asarray(st_r.accumulator), atol=1e-4)


def test_pallas_large_m_phase_products_exact():
    """Regression: the launcher's phase products must stay exact in int32
    for large dftsizes once the stream offset grows (a direct int32
    product wraps above m ~ 32768).  m=33024 at offset 2m-1 maximizes the
    products; gate vs the XLA path (which uses mulmod throughout)."""
    from sdft_tpu import State
    from sdft_tpu.ops.analysis import sdft_block

    m = 33024
    plan = Plan(m, window="hann", precision=F32)
    assert plan_supported(plan)
    x = _signal(512, seed=31)
    st0 = init_state(plan)
    # offset at the period edge maximizes the products; a wrapped phase
    # would land in the carried accumulator, so chain TWO blocks and gate
    # the second block's spectra and the final carry.
    st0 = State(offset=np.asarray(2 * m - 1, st0.offset.dtype),
                delayline=st0.delayline, accumulator=st0.accumulator)
    cfg = KernelConfig(tile_k=32, block_n=1024, super_r=4)

    st_x, _ = sdft_block(plan, st0, x[:256])
    st_x, d_x = sdft_block(plan, st_x, x[256:])
    st_k, _ = forward_block_pallas(plan, st0, x[:256], interpret=True,
                                   config=cfg)
    st_k, d_k = forward_block_pallas(plan, st_k, x[256:], interpret=True,
                                     config=cfg)
    scale = np.abs(np.asarray(d_x)).max()
    err = np.abs(np.asarray(d_k) - np.asarray(d_x)).max()
    assert err < 2e-3 * scale, (err, scale)
    acc_scale = max(1e-9, np.abs(np.asarray(st_x.accumulator)).max())
    acc_err = np.abs(np.asarray(st_k.accumulator)
                     - np.asarray(st_x.accumulator)).max()
    assert acc_err < 2e-3 * acc_scale, (acc_err, acc_scale)


@pytest.mark.parametrize("window,roi", [("hann", None), ("blackman", None),
                                        ("hamming", (20, 150))])
def test_power_spectra_matches_complex(window, roi):
    """forward_block_power emits |dft|^2 of the complex path (the
    spectrogram fast path: one output plane instead of re+im), on the
    kernel (interpret) and the api XLA path, batched included."""
    from sdft_tpu import sdft_power
    from sdft_tpu.kernels import forward_block_power

    plan = Plan(256, window=window, precision=F32, roi=roi)
    x = _signal(500, seed=41).astype(np.float32)
    st0 = init_state(plan)
    _, d = sdft(plan, st0, x)
    want = np.asarray(d)[..., 0] ** 2 + np.asarray(d)[..., 1] ** 2

    st_k, p = forward_block_power(plan, st0, x, interpret=True)
    err = np.abs(np.asarray(p) - want).max()
    assert err < 1e-4 * want.max() + 1e-12

    _, pa = sdft_power(plan, st0, x)          # CPU -> XLA path
    np.testing.assert_allclose(np.asarray(pa), want, atol=1e-9)

    # batched + bf16 element type
    xs = np.stack([x, _signal(500, seed=42).astype(np.float32)])
    sts = init_state(plan, channels=2)
    _, pb = sdft_power(plan, sts, xs, spectra_dtype="bfloat16")
    assert pb.shape == (2, 500, 256)
    import jax.numpy as jnp
    assert pb.dtype == jnp.bfloat16
