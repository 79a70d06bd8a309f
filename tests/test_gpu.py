"""On-card f32 parity gates (the ``gpu`` tier).

Run on a machine with an NVIDIA GPU::

    SDFT_TEST_GPU=1 python -m pytest tests/test_gpu.py

These are the on-card analogue of the reference comparator running against
the *real* implementation (test/main.py:67-79): the f32 spectra kernel and
the collapsed-LTI paths execute on the GPU and are gated against the f64
native oracle.  The CPU tier never compiles for the card (conftest pins
JAX_PLATFORMS=cpu), so without this tier no automated check would touch it.
Each test decides in a fixture whether a GPU is present and skips
otherwise.

Tolerances are the f32 rounding propagation bound with headroom, not
arbitrary: the running accumulator reaches |acc| ~ |delta|_rms * sqrt(2m)
(here ~0.5 * 32), each add rounds at eps32 * |acc|, and the error
random-walks over a block, so after the 1/(2m) analysis weight the spectra
error bound is eps32 * |acc| * sqrt(BLOCK) / (2m) ~ 1.6e-7 in any
summation order (the GPU's differs from the CPU's).  Gates sit at ~3x the
bound; any real defect (wrong window tap, phase, or Hermitian guard) shows
up at 1e-3+ relative.
"""

import numpy as np
import pytest

import jax

from sdft_tpu import FAST_PRECISION, Plan, init_state
from sdft_tpu.cplx import to_complex
from sdft_tpu.ops.lti import roundtrip_block_lti, sdft_hopped

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _on_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU backend: SDFT_TEST_GPU=1 python -m pytest "
                    "tests/test_gpu.py")


M_BINS = 512     # small enough to keep oracle time and compile time in check
BLOCK = 2048


@pytest.fixture(scope="module")
def oracle():
    from sdft_tpu.oracle import NativeSDFT

    return NativeSDFT


@pytest.fixture(scope="module")
def signal():
    rng = np.random.default_rng(42)
    return np.clip(rng.standard_normal(3 * BLOCK), -3, 3).astype(np.float32) / 2


def test_lti_roundtrip_matches_oracle_on_gpu(oracle, signal):
    """f32 collapsed round trip on the card vs the f64 per-sample engine,
    chained across blocks (carry parity included)."""
    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    eng = oracle(M_BINS, "hann", td_bits=64)

    state = init_state(plan)
    for b in range(3):
        # later blocks depend on the carried accumulator/delayline, so this
        # also gates carry parity between card and oracle
        blk = signal[b * BLOCK:(b + 1) * BLOCK]
        state, y = roundtrip_block_lti(plan, state, blk)
        d = eng.sdft(blk.astype(np.float64))
        y_ref = eng.isdft(d)
        np.testing.assert_allclose(np.asarray(y), y_ref, atol=1e-5)


def test_pallas_forward_matches_oracle_on_gpu(oracle, signal):
    """The spectra kernel on the card vs the f64 oracle spectra."""
    from sdft_tpu.kernels import forward_block_pallas, plan_supported

    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    assert plan_supported(plan)
    eng = oracle(M_BINS, "hann", td_bits=64)

    state = init_state(plan)
    for b in range(2):
        blk = signal[b * BLOCK:(b + 1) * BLOCK]
        state, dfts = forward_block_pallas(plan, state, blk)
        got = to_complex(np.asarray(dfts))
        want = eng.sdft(blk.astype(np.float64))
        # the eps32 propagation bound (module docstring) with headroom
        np.testing.assert_allclose(got, want, atol=5e-7, rtol=1e-4)


def test_pallas_and_lti_carry_interchangeable_on_gpu(signal):
    """One stream may alternate between the kernel forward and the LTI round
    trip: both must maintain the identical carry on the card."""
    from sdft_tpu.kernels import forward_block_pallas

    plan = Plan(M_BINS, window="blackman", precision=FAST_PRECISION)

    s_mixed = init_state(plan)
    s_lti = init_state(plan)
    s_mixed, _ = forward_block_pallas(plan, s_mixed, signal[:BLOCK])
    s_lti, _ = roundtrip_block_lti(plan, s_lti, signal[:BLOCK])
    # unweighted accumulators reach O(40); the f32 random-walk bound is
    # eps32 * |acc| * sqrt(BLOCK) ~ 2.2e-4
    np.testing.assert_allclose(np.asarray(s_mixed.accumulator),
                               np.asarray(s_lti.accumulator), atol=1e-3)

    s_mixed, y_mixed = roundtrip_block_lti(plan, s_mixed, signal[BLOCK:2 * BLOCK])
    s_lti, y_lti = roundtrip_block_lti(plan, s_lti, signal[BLOCK:2 * BLOCK])
    np.testing.assert_allclose(np.asarray(y_mixed), np.asarray(y_lti),
                               atol=1e-4)


def test_batched_lti_matches_per_channel_on_gpu(signal):
    """The channel-folded GEMM form equals independent 1-channel streams on
    the card (k_tile default and a large tile)."""
    plan = Plan(M_BINS, window="hamming", precision=FAST_PRECISION)
    C = 3  # the signal fixture holds exactly 3 blocks
    x = signal[:C * BLOCK].reshape(C, BLOCK)

    for k_tile in (None, 512):
        state = init_state(plan, channels=C)
        state, yb = roundtrip_block_lti(plan, state, x, k_tile)
        for c in range(C):
            s1 = init_state(plan)
            s1, y1 = roundtrip_block_lti(plan, s1, x[c], k_tile)
            np.testing.assert_allclose(np.asarray(yb)[c], np.asarray(y1),
                                       atol=1e-6)


def test_hopped_matches_forward_slices_on_gpu(oracle, signal):
    """Hopped analysis on the card vs the oracle's per-hop first spectra
    (the reference driver protocol, test/test.c:82)."""
    hop = 128
    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    eng = oracle(M_BINS, "hann", td_bits=64)

    state = init_state(plan)
    state, dfts = sdft_hopped(plan, state, signal[:BLOCK], hop)
    got = to_complex(np.asarray(dfts))
    want = eng.sdft(signal[:BLOCK].astype(np.float64))[::hop]
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_pallas_compile_latency_bounded(signal):
    """A cold compile of the spectra kernel must stay interactive.  A
    distinct (window, M) pair guarantees a jit-cache miss."""
    import time

    from sdft_tpu.kernels import forward_block_pallas

    plan = Plan(M_BINS, window="blackman", precision=FAST_PRECISION)
    state = init_state(plan)
    blk = signal[:BLOCK + 256]  # M=2304: no other test compiles this shape

    t0 = time.perf_counter()
    _, dfts = forward_block_pallas(plan, state, blk)
    jax.block_until_ready(dfts)
    elapsed = time.perf_counter() - t0
    assert elapsed < 60.0, f"cold kernel compile took {elapsed:.0f}s"


def test_pallas_canonical_m1000_on_gpu(oracle, signal):
    """The reference's canonical dftsize (m=1000, test/main.sh:3) through
    the spectra kernel on the card — the bin axis is not a whole number of
    bin blocks, so this gates the masked-store path as compiled by Triton,
    not just interpret mode."""
    from sdft_tpu.kernels import forward_block_pallas, plan_supported

    m, M = 1000, 2100
    plan = Plan(m, window="hann", precision=FAST_PRECISION)
    assert plan_supported(plan)
    eng = oracle(m, "hann", td_bits=64)

    state = init_state(plan)
    for b in range(2):
        blk = signal[b * M:(b + 1) * M]
        state, dfts = forward_block_pallas(plan, state, blk)
        got = to_complex(np.asarray(dfts))
        want = eng.sdft(blk.astype(np.float64))
        np.testing.assert_allclose(got, want, atol=5e-7, rtol=1e-4)


def test_vmapped_pallas_forward_on_gpu(oracle, signal):
    """api.sdft with a (C, M) batch on the GPU goes through
    vmap-of-pallas_call (_sdft_2d_pallas); gate it against per-channel
    oracle spectra."""
    from sdft_tpu.api import sdft

    C = 2
    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    x = signal[:C * BLOCK].reshape(C, BLOCK)

    states = init_state(plan, channels=C)
    states, dfts = sdft(plan, states, x)
    got = to_complex(np.asarray(dfts))
    for c in range(C):
        eng = oracle(M_BINS, "hann", td_bits=64)
        want = eng.sdft(x[c].astype(np.float64))
        np.testing.assert_allclose(got[c], want, atol=5e-7, rtol=1e-4)


def test_sharded_programs_execute_on_gpu(signal):
    """shard_map programs must compile + execute on the card — a 1x1x1 mesh
    makes every collective degenerate but still exercises the sharded
    program path on hardware (chip_smoke.py --multi runs real meshes)."""
    from sdft_tpu.parallel import make_mesh, sharded_roundtrip, sharded_sdft_hopped
    from sdft_tpu.ops.lti import roundtrip_block_lti, sdft_hopped

    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    mesh = make_mesh(1, 1, 1)
    x = signal[:BLOCK][None]  # (C=1, M)

    st_m = init_state(plan, channels=1)
    st_m, y_m = sharded_roundtrip(plan, mesh, st_m, x)
    st_1 = init_state(plan, channels=1)
    st_1, y_1 = roundtrip_block_lti(plan, st_1, x)
    np.testing.assert_allclose(np.asarray(y_m), np.asarray(y_1), atol=1e-5)

    _, hd_m = sharded_sdft_hopped(plan, mesh, init_state(plan, channels=1),
                                  x, 128)
    _, hd_1 = sdft_hopped(plan, init_state(plan, channels=1), x, 128)
    np.testing.assert_allclose(np.asarray(hd_m), np.asarray(hd_1), atol=1e-6)


def test_split4_roundtrip_accuracy_on_gpu(oracle, signal):
    """The split4 throughput mode on the card vs the f64 oracle: must hold
    its documented ~1e-4 synthesized-sample class."""
    from sdft_tpu import Precision

    plan = Plan(M_BINS, window="hann",
                precision=Precision("float32", "float32", mxu="split4"))
    eng = oracle(M_BINS, "hann", td_bits=64)

    from sdft_tpu.ops.lti import roundtrip_block_lti as rt
    state = init_state(plan)
    blk = signal[:BLOCK]
    state, y = rt(plan, state, blk)
    d = eng.sdft(blk.astype(np.float64))
    y_ref = eng.isdft(d)
    np.testing.assert_allclose(np.asarray(y), y_ref, atol=5e-4)


def test_roundtrip_hopped_chain_on_gpu(oracle, signal):
    """The chained driver-protocol program (api.roundtrip_hopped — what the
    CLI dispatches) on the card vs the f64 oracle: per-hop first
    spectra and synthesized samples, with the in-chain accumulator
    refresh."""
    from sdft_tpu import roundtrip_hopped

    hop, B, nb = 128, 1024, 4
    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    eng = oracle(M_BINS, "hann", td_bits=64)

    x = signal[:nb * B]
    state = init_state(plan)
    state, hd, ys = roundtrip_hopped(plan, state, x.reshape(nb, B), hop)
    got_d = to_complex(np.asarray(hd).reshape(-1, M_BINS, 2))
    got_y = np.asarray(ys).reshape(-1)

    d_ref = eng.sdft(x.astype(np.float64))
    y_ref = eng.isdft(d_ref)
    np.testing.assert_allclose(got_d, d_ref[::hop], atol=2e-7)
    np.testing.assert_allclose(got_y, y_ref, atol=1e-4)


def test_flagship_m4096_forward_kernels_on_gpu(oracle, signal):
    """The flagship-size (m=4096, BASELINE.json) spectra kernel on the card
    vs the f64 oracle — the bench claims its throughput at this size, so
    the accuracy gate runs here too: the default and a second tiling, f32
    and bf16 output element types."""
    from sdft_tpu.kernels import KernelConfig, forward_block_pallas

    m, M = 4096, 4096
    plan = Plan(m, window="hann", precision=FAST_PRECISION)
    eng = oracle(m, "hann", td_bits=64)
    x = signal[:M]
    want = eng.sdft(x.astype(np.float64))
    scale = np.abs(want).max()

    for cfg in [None, KernelConfig(tile_k=32, block_n=64, super_r=4)]:
        state = init_state(plan)
        _, (re, im) = forward_block_pallas(plan, state, x, layout="planar",
                                           config=cfg)
        got = np.asarray(re) + 1j * np.asarray(im)
        err = np.abs(got - want).max()
        # the kernel's bf16-split contraction class
        assert err < 3e-6 * scale, (cfg, err / scale)

    state = init_state(plan)
    _, (re16, im16) = forward_block_pallas(plan, state, x, layout="planar",
                                           out_dtype="bfloat16")
    got16 = (np.asarray(re16, np.float32) + 1j * np.asarray(im16, np.float32))
    err16 = np.abs(got16 - want).max()
    # bf16 output rounding class (~2^-9)
    assert err16 < 8e-3 * scale, err16 / scale


def test_flagship_m4096_roundtrip_on_gpu(oracle, signal):
    """m=4096 collapsed round trip (exact f32 + split4) on the card vs
    the f64 oracle."""
    from sdft_tpu import Precision

    m, M = 4096, 4096
    eng = oracle(m, "hann", td_bits=64)
    x = signal[:M]
    y_ref = eng.isdft(eng.sdft(x.astype(np.float64)))

    plan = Plan(m, window="hann", precision=FAST_PRECISION)
    _, y = roundtrip_block_lti(plan, init_state(plan), x)
    assert np.abs(np.asarray(y) - y_ref).max() < 2e-5  # exact f32

    plan4 = Plan(m, window="hann",
                 precision=Precision("float32", "float32", mxu="split4"))
    _, y4 = roundtrip_block_lti(plan4, init_state(plan4), x)
    assert np.abs(np.asarray(y4) - y_ref).max() < 5e-4  # split4


def test_fused_driver_block_on_gpu(oracle, signal):
    """roundtrip_hopped_block (the fused single-pass driver protocol) on the
    card: hop spectra + synthesized samples + fused refresh vs the f64
    oracle."""
    from sdft_tpu.ops.lti import roundtrip_hopped_block

    hop, B, nb = 128, 1024, 3
    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    eng = oracle(M_BINS, "hann", td_bits=64)

    x = signal[:nb * B]
    d_ref = eng.sdft(x.astype(np.float64))
    y_ref = eng.isdft(d_ref)

    state = init_state(plan)
    hds, ys = [], []
    for b in range(nb):
        state, hd, y = roundtrip_hopped_block(plan, state,
                                              x[b * B:(b + 1) * B], hop,
                                              refresh=True)
        hds.append(to_complex(np.asarray(hd)))
        ys.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(hds), d_ref[::hop], atol=2e-7)
    np.testing.assert_allclose(np.concatenate(ys), y_ref, atol=1e-4)


def test_sharded_pallas_spectra_on_gpu(oracle, signal):
    """The time-sharded kernel spectra program on the card (1x1x1 mesh:
    collectives degenerate, but the shard_map + in-shard pallas_call
    composition and the refresh-derived carry run on hardware) vs the f64
    oracle."""
    from sdft_tpu.parallel import make_mesh, sharded_sdft_pallas

    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    mesh = make_mesh(1, 1, 1)
    x = signal[:BLOCK][None]

    st, dfts = sharded_sdft_pallas(plan, mesh,
                                   init_state(plan, channels=1), x)
    got = to_complex(np.asarray(dfts[0]))
    eng = oracle(M_BINS, "hann", td_bits=64)
    want = eng.sdft(x[0].astype(np.float64))
    np.testing.assert_allclose(got, want, atol=5e-7, rtol=1e-4)


def test_hop1_driver_chain_on_gpu(oracle, signal):
    """The hop=1 driver chain on the card (the stepped fused XLA body):
    every sample's spectrum + the synthesized block vs the f64 oracle."""
    from sdft_tpu import roundtrip_hopped

    B, nb = 1024, 2
    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    eng = oracle(M_BINS, "hann", td_bits=64)
    x = signal[:nb * B]
    d_ref = eng.sdft(x.astype(np.float64))
    y_ref = eng.isdft(d_ref)
    scale = np.abs(d_ref).max()

    st = init_state(plan)
    st, hd, ys = roundtrip_hopped(plan, st, x.reshape(nb, B), 1)
    assert np.asarray(hd).shape == (nb, B, M_BINS, 2)
    got = to_complex(np.asarray(hd).reshape(-1, M_BINS, 2))
    # f32 matrix-product class, with headroom
    assert np.abs(got - d_ref).max() < 1.5e-5 * scale
    np.testing.assert_allclose(np.asarray(ys).reshape(-1), y_ref, atol=1e-4)


def test_extended_twofloat_tier_on_gpu(oracle, signal):
    """The double-word (float32x2) FD tier on the card vs the f64 oracle:
    f64-class spectra from f32 arithmetic (the reference's extended-tier
    analogue, c/src/sdft/sdft.h:21-37).  The class is the two-float
    pipeline's eps^2 floor, with 1e-9 as the hard gate (any broken
    error-free transform, e.g. an XLA fold of a TwoSum, shows up at
    1e-7+)."""
    from sdft_tpu import Precision, df_to_float64, sdft

    plan = Plan(M_BINS, window="hann",
                precision=Precision("float32", "float32x2"))
    eng = oracle(M_BINS, "hann", td_bits=64)
    B, nb = 1024, 2
    x = signal[:nb * B]
    want = eng.sdft(x.astype(np.float64))
    scale = np.abs(want).max()

    st = init_state(plan)
    outs = []
    last_d = None
    for b in range(nb):
        st, d = sdft(plan, st, x[b * B:(b + 1) * B])
        last_d = d
        outs.append(to_complex(df_to_float64((np.asarray(d[..., 0]),
                                              np.asarray(d[..., 1])))))
    err = np.abs(np.concatenate(outs) - want).max()
    assert err < 1e-9 * scale, err / scale

    # synthesis leg: the double-word isdft vs the f64 oracle's samples
    from sdft_tpu import isdft

    want_y = eng.isdft(want[-B:])
    got_y = np.asarray(isdft(plan, last_d), np.float64)
    yerr = np.abs(got_y - want_y).max()
    assert yerr < 1e-7 * np.abs(want_y).max(), yerr  # f32-out quantization


def test_power_spectra_kernel_on_gpu(oracle, signal):
    """forward_block_power on the card vs the f64 oracle |dft|^2 —
    the spectrogram fast path (one output plane)."""
    from sdft_tpu.kernels import forward_block_power

    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION)
    eng = oracle(M_BINS, "hann", td_bits=64)
    x = signal[:BLOCK]
    want = np.abs(eng.sdft(x.astype(np.float64))) ** 2
    scale = want.max()

    _, p = forward_block_power(plan, init_state(plan), x)
    assert np.abs(np.asarray(p) - want).max() < 1e-5 * scale

    _, p16 = forward_block_power(plan, init_state(plan), x,
                                 out_dtype="bfloat16")
    assert np.abs(np.asarray(p16, np.float32) - want).max() < 1e-2 * scale


def test_roi_fast_paths_on_gpu(oracle, signal):
    """ROI on the card: the spectra kernel (table-folded masks, exact ROI
    edge bins) and the hop=1 driver chain vs the f64 oracle restricted to
    the ROI band.  Interpret mode hides what only the compiled kernel
    does, so ROI needs an on-card gate too."""
    from sdft_tpu import roundtrip_hopped, sdft
    from sdft_tpu.cplx import to_complex as _toc

    first, last = 64, 400
    plan = Plan(M_BINS, window="hann", precision=FAST_PRECISION,
                roi=(first, last))
    eng = oracle(M_BINS, "hann", td_bits=64)
    x = signal[:BLOCK]
    want_full = eng.sdft(x.astype(np.float64))
    scale = np.abs(want_full).max()

    # forward spectra (the kernel)
    _, d = sdft(plan, init_state(plan), x)
    got = _toc(np.asarray(d))
    assert np.all(got[..., :first] == 0)
    assert np.all(got[..., last:] == 0)
    # same class as the full-band forward gate (atol 5e-7 + rtol 1e-4)
    np.testing.assert_allclose(got[..., first + 2:last - 2],
                               want_full[..., first + 2:last - 2],
                               atol=5e-7, rtol=1e-4)

    # hop=1 driver chain
    _, hd, _ys = roundtrip_hopped(plan, init_state(plan),
                                  x.reshape(2, BLOCK // 2), 1)
    got1 = _toc(np.asarray(hd).reshape(-1, M_BINS, 2))
    assert np.all(got1[..., :first] == 0)
    assert np.all(got1[..., last:] == 0)
    assert np.abs(got1[..., first + 2:last - 2]
                  - want_full[..., first + 2:last - 2]).max() < 1.5e-5 * scale
