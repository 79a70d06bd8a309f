"""Sharded == unsharded equivalence on a virtual 8-device CPU mesh
(SURVEY.md §4c: shard-count invariance is the race/correctness gate at
collective boundaries)."""

import numpy as np
import pytest

import jax

from sdft_tpu import Plan, Precision, from_complex, init_state, isdft, sdft
from sdft_tpu.parallel import make_mesh, sharded_isdft, sharded_roundtrip, sharded_sdft

F64 = Precision(td="float64", fd="float64")


def _signal(c, n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((c, n)).clip(-1, 1)


def _unsharded(plan, x):
    state = init_state(plan, channels=x.shape[0])
    state, dfts = sdft(plan, state, x)
    return state, np.asarray(dfts)


MESHES = [
    dict(channel=1, time=1, bins=8),
    dict(channel=1, time=8, bins=1),
    dict(channel=2, time=2, bins=2),
    dict(channel=1, time=2, bins=4),
]


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(map(str, a.values())))
@pytest.mark.parametrize("window", ["hann", "blackman"])
def test_sharded_forward_matches_unsharded(axes, window):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    m = 32
    C, M = 2, 8 * 2 * m  # local block 2m even at time=8
    x = _signal(C, M)
    plan = Plan(m, window=window, precision=F64)
    mesh = make_mesh(**axes)

    ref_state, ref_dfts = _unsharded(plan, x)

    state = init_state(plan, channels=C)
    new_state, dfts = sharded_sdft(plan, mesh, state, x)

    np.testing.assert_allclose(np.asarray(dfts), ref_dfts, atol=1e-12)
    np.testing.assert_allclose(np.asarray(new_state.accumulator),
                               np.asarray(ref_state.accumulator), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(new_state.offset),
                                  np.asarray(ref_state.offset))
    np.testing.assert_allclose(np.asarray(new_state.delayline),
                               np.asarray(ref_state.delayline), atol=0)


def test_sharded_streaming_carry():
    """Two consecutive sharded blocks == one unsharded pass."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    m = 16
    C, M = 1, 4 * 2 * m
    x = _signal(C, 2 * M, seed=1)
    plan = Plan(m, precision=F64)
    mesh = make_mesh(channel=1, time=2, bins=2)

    _, ref_dfts = _unsharded(plan, x)

    state = init_state(plan, channels=C)
    state, d1 = sharded_sdft(plan, mesh, state, x[:, :M])
    state, d2 = sharded_sdft(plan, mesh, state, x[:, M:])
    got = np.concatenate([np.asarray(d1), np.asarray(d2)], axis=1)

    np.testing.assert_allclose(got, ref_dfts, atol=1e-12)


@pytest.mark.parametrize("latency", [1.0, 0.5])
def test_sharded_isdft_matches_unsharded(latency):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    m = 32
    C, M = 2, 128
    rng = np.random.default_rng(2)
    dfts = (rng.standard_normal((C, M, m)) + 1j * rng.standard_normal((C, M, m))) / m
    plan = Plan(m, latency=latency, precision=F64)
    mesh = make_mesh(channel=2, time=2, bins=2)

    want = np.asarray(isdft(plan, dfts))
    got = np.asarray(sharded_isdft(plan, mesh, from_complex(dfts)))
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_sharded_roundtrip_fused():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    m = 32
    C, M = 2, 2 * 2 * m
    x = _signal(C, M, seed=3)
    plan = Plan(m, precision=F64)
    mesh = make_mesh(channel=2, time=2, bins=2)

    state = init_state(plan, channels=C)
    _, dfts = sdft(plan, state, x)
    want = np.asarray(isdft(plan, dfts))

    state = init_state(plan, channels=C)
    _, y = sharded_roundtrip(plan, mesh, state, x)
    np.testing.assert_allclose(np.asarray(y), want, atol=1e-12)


def test_layout_validation():
    plan = Plan(32, precision=F64)
    mesh = make_mesh(channel=1, time=2, bins=1)
    state = init_state(plan, channels=1)
    x = np.zeros((1, 101))  # 101 not divisible by time=2
    with pytest.raises(ValueError):
        sharded_sdft(plan, mesh, state, x)
    with pytest.raises(ValueError):
        sharded_sdft(plan, make_mesh(bins=3), init_state(plan, channels=1),
                     np.zeros((1, 128)))


def test_sharded_short_local_blocks_multi_predecessor_comb():
    """Local time blocks < 2m: the comb history spans several predecessor
    shards (multi-hop _comb_history) and must still match single-device
    output exactly, chained across calls."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu.ops.lti import roundtrip_block_lti

    m = 32                      # 2m = 64
    nt = 8
    M = 16 * nt                 # local block 16 < 2m = 64: spans 4 shards
    mesh = make_mesh(channel=1, time=nt, bins=1)
    x = _signal(1, 3 * M, seed=23)

    st_sh = init_state(plan := Plan(m, window="hann", precision=F64), channels=1)
    st_ref = init_state(plan, channels=1)
    for b in range(3):
        blk = x[:, b * M:(b + 1) * M]
        st_sh, y_sh = sharded_roundtrip(plan, mesh, st_sh, blk)
        st_ref, y_ref = roundtrip_block_lti(plan, st_ref, blk)
        np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_ref),
                                   atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_sh.accumulator),
                               np.asarray(st_ref.accumulator), atol=1e-12)
    np.testing.assert_array_equal(np.asarray(st_sh.delayline),
                                  np.asarray(st_ref.delayline))


def test_sharded_scanform_short_local_blocks():
    """Scan-form program with local blocks < 2m (multi-predecessor comb)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu.api import sdft as api_sdft

    m = 32
    nt = 4
    M = 32 * nt                 # local block 32 < 2m = 64: spans 2 shards
    mesh = make_mesh(channel=2, time=nt, bins=1)
    plan = Plan(m, window="hamming", precision=F64)
    x = _signal(2, 2 * M, seed=29)

    st_sh = init_state(plan, channels=2)
    st_ref = init_state(plan, channels=2)
    for b in range(2):
        blk = x[:, b * M:(b + 1) * M]
        st_sh, d_sh = sharded_sdft(plan, mesh, st_sh, blk)
        st_ref, d_ref = api_sdft(plan, st_ref, blk)
        np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref),
                                   atol=1e-12)


@pytest.mark.parametrize("axes", [(1, 1, 8), (1, 8, 1), (2, 2, 2), (1, 2, 4)])
@pytest.mark.parametrize("window", ["hann", "blackman"])
def test_sharded_roundtrip_lti_matches_unsharded(axes, window):
    """The collapsed sharded round trip equals the single-device LTI result
    for every mesh factorization (shard-count invariance, SURVEY.md §4c)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu.ops.lti import roundtrip_block_lti

    m = 32
    nc, nt, nb = axes
    C = 2 * nc
    M = max(2 * m * nt, 256)
    x = _signal(C, M, seed=7)
    plan = Plan(m, window=window, precision=F64)
    mesh = make_mesh(channel=nc, time=nt, bins=nb)

    want = np.stack([
        np.asarray(roundtrip_block_lti(plan, init_state(plan), x[c])[1])
        for c in range(C)])

    state = init_state(plan, channels=C)
    new_state, y = sharded_roundtrip(plan, mesh, state, x)
    np.testing.assert_allclose(np.asarray(y), want, atol=1e-12)

    # carry parity: accumulators must match the unsharded chain's
    ref_states = [roundtrip_block_lti(plan, init_state(plan), x[c])[0]
                  for c in range(C)]
    acc_ref = np.stack([np.asarray(s.accumulator) for s in ref_states])
    np.testing.assert_allclose(np.asarray(new_state.accumulator), acc_ref,
                               atol=1e-12)


def test_sharded_roundtrip_lti_streaming_carry():
    """Chained sharded LTI blocks equal one long unsharded block."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu.ops.lti import roundtrip_block_lti

    m = 32
    C, M = 2, 2 * 2 * m
    x = _signal(C, 3 * M, seed=8)
    plan = Plan(m, precision=F64)
    mesh = make_mesh(channel=2, time=2, bins=2)

    want = np.stack([
        np.asarray(roundtrip_block_lti(plan, init_state(plan), x[c])[1])
        for c in range(C)])

    state = init_state(plan, channels=C)
    got = []
    for b in range(3):
        state, y = sharded_roundtrip(plan, mesh, state, x[:, b * M:(b + 1) * M])
        got.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(got, axis=1), want, atol=1e-12)


def test_sharded_hopped_matches_unsharded():
    """Sharded hopped analysis equals the single-device hopped path for
    several mesh factorizations, chained across blocks."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu.ops.lti import sdft_hopped
    from sdft_tpu.parallel import sharded_sdft_hopped

    m, hop = 32, 16
    plan = Plan(m, window="hann", precision=F64)
    C, M = 2, 512
    x = _signal(C, 2 * M, seed=31)

    for axes in [(1, 2, 4), (2, 2, 2), (1, 8, 1), (1, 1, 8)]:
        mesh = make_mesh(*axes)
        st_sh = init_state(plan, channels=C)
        st_ref = init_state(plan, channels=C)
        for b in range(2):
            blk = x[:, b * M:(b + 1) * M]
            st_sh, d_sh = sharded_sdft_hopped(plan, mesh, st_sh, blk, hop)
            st_ref, d_ref = sdft_hopped(plan, st_ref, blk, hop)
            assert np.asarray(d_sh).shape == (C, M // hop, m, 2)
            np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref),
                                       atol=1e-12)
        np.testing.assert_allclose(np.asarray(st_sh.accumulator),
                                   np.asarray(st_ref.accumulator), atol=1e-12)


def test_sharded_roundtrip_hopped_matches_unsharded():
    """The fused sharded driver chain (ONE program per segment: hop spectra
    + synthesis from a shared comb/totals pass) equals the single-device
    roundtrip_hopped, for every 8-device factorization and refresh mode."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu import roundtrip_hopped
    from sdft_tpu.parallel import sharded_roundtrip_hopped

    m, hop, nb = 32, 16, 3
    plan = Plan(m, window="hann", precision=F64)
    C, B = 2, 256
    x = _signal(C, nb * B, seed=33).reshape(C, nb, B).transpose(1, 0, 2)

    for refresh_every in (1, None):
        st_ref = init_state(plan, channels=C)
        st_ref, hd_ref, ys_ref = roundtrip_hopped(
            plan, st_ref, x, hop, refresh_every=refresh_every)
        for axes in [(1, 2, 4), (2, 2, 2), (1, 8, 1), (1, 1, 8)]:
            mesh = make_mesh(*axes)
            st = init_state(plan, channels=C)
            st, hd, ys = sharded_roundtrip_hopped(
                plan, mesh, st, x, hop, refresh_every=refresh_every)
            assert np.asarray(hd).shape == (nb, C, B // hop, m, 2)
            assert np.asarray(ys).shape == (nb, C, B)
            np.testing.assert_allclose(np.asarray(hd), np.asarray(hd_ref),
                                       atol=1e-12)
            np.testing.assert_allclose(np.asarray(ys), np.asarray(ys_ref),
                                       atol=1e-12)
            np.testing.assert_allclose(np.asarray(st.accumulator),
                                       np.asarray(st_ref.accumulator),
                                       atol=1e-12)
            np.testing.assert_allclose(np.asarray(st.delayline),
                                       np.asarray(st_ref.delayline), atol=0)


def test_sharded_roundtrip_hopped_degenerate_hop():
    """hop < 8 rides the stepped multi-hop tiles inside the sharded body."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu import roundtrip_hopped
    from sdft_tpu.parallel import sharded_roundtrip_hopped

    m, hop, nb = 32, 4, 2
    plan = Plan(m, window="hamming", precision=F64)
    C, B = 1, 128
    x = _signal(C, nb * B, seed=34).reshape(C, nb, B).transpose(1, 0, 2)

    st_ref = init_state(plan, channels=C)
    st_ref, hd_ref, ys_ref = roundtrip_hopped(plan, st_ref, x, hop)
    mesh = make_mesh(1, 4, 2)
    st = init_state(plan, channels=C)
    st, hd, ys = sharded_roundtrip_hopped(plan, mesh, st, x, hop)
    np.testing.assert_allclose(np.asarray(hd), np.asarray(hd_ref), atol=1e-12)
    np.testing.assert_allclose(np.asarray(ys), np.asarray(ys_ref), atol=1e-12)
    np.testing.assert_allclose(np.asarray(st.accumulator),
                               np.asarray(st_ref.accumulator), atol=1e-12)


def test_sharded_hopped_degenerate_hops():
    """hop < 8 rides the stepped multi-hop tiles (ops.lti
    _stepped_consts_device) under sharding too — sharded == unsharded at
    1e-12 for every mesh factorization, plus the hop-depth fallback when
    the local block is a hop multiple but not a tile multiple."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu.ops.lti import sdft_hopped
    from sdft_tpu.parallel import sharded_sdft_hopped

    m = 32
    plan = Plan(m, window="hann", precision=F64)
    C, M = 2, 256
    x = _signal(C, 2 * M, seed=41)

    for hop in (1, 2, 4):
        for axes in [(1, 2, 4), (2, 2, 2), (1, 8, 1)]:
            mesh = make_mesh(*axes)
            st_sh = init_state(plan, channels=C)
            st_ref = init_state(plan, channels=C)
            for b in range(2):
                blk = x[:, b * M:(b + 1) * M]
                st_sh, d_sh = sharded_sdft_hopped(plan, mesh, st_sh, blk,
                                                  hop)
                st_ref, d_ref = sdft_hopped(plan, st_ref, blk, hop)
                assert np.asarray(d_sh).shape == (C, M // hop, m, 2)
                np.testing.assert_allclose(np.asarray(d_sh),
                                           np.asarray(d_ref), atol=1e-12)
            np.testing.assert_allclose(np.asarray(st_sh.accumulator),
                                       np.asarray(st_ref.accumulator),
                                       atol=1e-12)

    # fallback: local block 12 is a multiple of hop=4 but not of the
    # hop*sub=8 tile — sharded_sdft_hopped silently drops to hop-depth
    plan16 = Plan(16, window="hann", precision=F64)
    mesh = make_mesh(1, 4, 1)
    xs = _signal(1, 48, seed=43)
    st_sh, d_sh = sharded_sdft_hopped(plan16, mesh,
                                      init_state(plan16, channels=1), xs, 4)
    st_ref, d_ref = sdft_hopped(plan16, init_state(plan16, channels=1),
                                xs, 4)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref),
                               atol=1e-12)


def test_sharded_hopped_blackman_short_blocks():
    """Blackman (halo 2) + local blocks < 2m: bin-halo exchange and
    multi-predecessor comb compose."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from sdft_tpu.ops.lti import sdft_hopped
    from sdft_tpu.parallel import sharded_sdft_hopped

    m, hop = 32, 8
    plan = Plan(m, window="blackman", precision=F64)
    M = 32 * 4                   # local block 32 < 2m = 64
    mesh = make_mesh(1, 4, 2)
    x = _signal(1, M, seed=37)

    st_sh, d_sh = sharded_sdft_hopped(plan, mesh, init_state(plan, channels=1),
                                      x, hop)
    st_ref, d_ref = sdft_hopped(plan, init_state(plan, channels=1), x, hop)
    np.testing.assert_allclose(np.asarray(d_sh), np.asarray(d_ref), atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_sh.accumulator),
                               np.asarray(st_ref.accumulator), atol=1e-12)


# module-level so the identity-hashed jit cache hits across parametrizations
def _mesh_lowpass(z, bins):
    return z * (bins < 48)


def _single_lowpass(z):
    import numpy as _np
    return z * (_np.arange(z.shape[-1]) < 48)


@pytest.mark.parametrize("axes", [
    dict(channel=1, time=1, bins=4),
    dict(channel=1, time=2, bins=2),
    dict(channel=2, time=2, bins=1),
])
def test_sharded_transform_matches_single_device(axes):
    """Mesh spectral transform (analyze -> modify -> resynthesize, the
    reference's core usage: python/src/sdft/sdft.py) == the single-device
    api.roundtrip(transform=...), for bin-sharded, time-sharded and
    channel-sharded meshes."""
    from sdft_tpu.api import roundtrip

    plan = Plan(96, window="hann", precision=Precision("float64", "float64"))
    mesh = make_mesh(**axes)
    C, M = 2, 384
    rng = np.random.default_rng(21)
    x = np.clip(rng.standard_normal((C, M)), -3, 3) / 2

    st_sh = init_state(plan, channels=C)
    st_sh, y_sh = sharded_roundtrip(plan, mesh, st_sh, x,
                                    transform=_mesh_lowpass)

    st_1 = init_state(plan, channels=C)
    st_1, y_1 = roundtrip(plan, st_1, x, transform=_single_lowpass)

    np.testing.assert_allclose(np.asarray(y_sh), np.asarray(y_1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(st_sh.accumulator),
                               np.asarray(st_1.accumulator), atol=1e-12)

    # chained second block: the carry crosses the transform program too
    st_sh, y_sh2 = sharded_roundtrip(plan, mesh, st_sh, x,
                                     transform=_mesh_lowpass)
    st_1, y_12 = roundtrip(plan, st_1, x, transform=_single_lowpass)
    np.testing.assert_allclose(np.asarray(y_sh2), np.asarray(y_12),
                               atol=1e-12)


@pytest.mark.parametrize("axes", [
    dict(channel=1, time=8, bins=1),
    dict(channel=2, time=4, bins=1),
    dict(channel=1, time=2, bins=1),
], ids=lambda a: "x".join(map(str, a.values())))
def test_sharded_pallas_spectra_matches_unsharded(axes):
    """Time-sharded Pallas spectra (each shard derives its carry from the
    comb history via the refresh identity — one ppermute, no prefix
    collective) vs the unsharded forward, incl. a local-block < 2m case
    and streaming carry across two segments."""
    import jax.numpy as jnp

    from sdft_tpu import Precision, sdft
    from sdft_tpu.parallel import make_mesh, sharded_sdft_pallas

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    F32 = Precision("float32", "float32")
    plan = Plan(256, window="hann", precision=F32)
    C, M = 2, 8 * 256          # time=8 -> local block 256 < 2m = 512
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((C, 2 * M)) * 0.25).clip(-1, 1).astype(np.float32)
    mesh = make_mesh(**axes)

    st = init_state(plan, channels=C)
    st_r = init_state(plan, channels=C)
    for seg in (x[:, :M], x[:, M:]):
        st, d = sharded_sdft_pallas(plan, mesh, st, seg, interpret=True)
        st_r, d_r = sdft(plan, st_r, seg)
        np.testing.assert_allclose(np.asarray(d), np.asarray(d_r), atol=5e-6)
        np.testing.assert_allclose(np.asarray(st.accumulator),
                                   np.asarray(st_r.accumulator), atol=5e-4)
        np.testing.assert_allclose(np.asarray(st.delayline),
                                   np.asarray(st_r.delayline), atol=0)

    # planar + bf16 output element type
    st, (re16, im16) = sharded_sdft_pallas(
        plan, mesh, init_state(plan, channels=C), x[:, :M],
        layout="planar", spectra_dtype="bfloat16", interpret=True)
    assert re16.dtype == jnp.bfloat16
    _, d_r = sdft(plan, init_state(plan, channels=C), x[:, :M])
    np.testing.assert_allclose(np.asarray(re16, np.float32),
                               np.asarray(d_r)[..., 0], atol=3e-3)

    # bin-sharded meshes are the XLA path's job
    with pytest.raises(ValueError, match="bin-sharded"):
        sharded_sdft_pallas(plan, make_mesh(channel=1, time=1, bins=8),
                            init_state(plan, channels=C), x[:, :M])
