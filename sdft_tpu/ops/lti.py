"""Collapsed (LTI) formulation of the sdft -> isdft round trip.

When no spectral transform is applied between analysis and synthesis, the
round trip is a linear time-invariant map of the comb deltas: demodulation,
Hermitian edge guards, the window's bin convolution and the synthesis
reduction (c/src/sdft/sdft.h:562-657) are all *linear* in the accumulator,
so the order of the time prefix-sum and the bin contraction can be swapped.
Writing a block of M samples as nt tiles of K (u = per-tile scan state in
the tile-demodulated frame, as in kernels/spectra_triton.py):

    y[k] = sum_j  P[k,j] * u_re[k,j] + Q[k,j] * u_im[k,j]
    u    = cumsum_k(delta[k] * fine[k,j]) + acc_tile * conj(row0)

with P, Q the adjoint of (demod * guards * window-conv * synthesis) and
fine[k,j] = T_j^k.  Substituting and exchanging sums:

    y_tile = delta_tile @ (G o L)^T  +  c0_re @ P^T + c0_im @ Q^T
    G[k,k'] = sum_j P[k,j]*fine_re[k',j] + Q[k,j]*fine_im[k',j]
    L[k,k'] = 1{k' <= k}                      (causality of the prefix sum)

where G, P, Q, fine are *plan constants*.  The accumulator evolution across
tiles batches too: per-tile totals are one (nt,K)@(K,m) matmul, the carry
recurrence is a length-nt cumsum of rotated totals.  The entire round trip
becomes three matrix products + O(nt*m) elementwise work — the O(M*m)
elementwise scan pipeline disappears, and the reference's hot loop becomes
matrix-unit work.

Exactness: phases still come from integer exponents mod 2m
(sdft_tpu.ops.twiddle), the carried State is bit-identical in meaning to the
scan path's, and the output equals the sdft_block+isdft_block composition up
to floating-point reassociation (gated by tests against the XLA path and the
native oracle).  Works for every window, any latency, ROI plans, f32 and
f64, on the GPU and the CPU.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..cplx import pack
from ..plan import Plan
from ..state import State
from ..windows import WINDOW_HALO, WINDOW_TAPS

K_TILE = 128


def default_k_tile(M: int) -> int:
    """Pick the tile length for a block of M samples.

    Tuned on the previous accelerator at m=4096, where XLA slowed sharply
    whenever the tile count nt = ceil(M/K) equaled 128: nt=256 for blocks
    >= 32k samples and nt <= 64 below.  Whether that holds on the GPU is
    not measured (re-tuning is open work).
    """
    if M >= 32768:
        return max(128, M // 256)    # nt = 256
    return max(32, M // 64)          # nt <= 64, never 128


@functools.lru_cache(maxsize=None)
def _fine_host(plan: Plan, K: int):
    """fine[k,j] = T_j^k for k in [0,K), exact integer phases (numpy f64)."""
    m = plan.dftsize
    ang = (-np.pi / m) * ((np.arange(K)[:, None] * np.arange(m)[None, :])
                          % (2 * m))
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=None)
def _lti_constants(plan: Plan, K: int):
    """Host-side (numpy, float64) plan constants for the collapsed round trip.

    Returns (fine_re, fine_im, P, Q, GLT) with shapes (K,m),(K,m),(K,m),(K,m),
    (K,K); GLT = (G o L)^T ready for ``delta_tile @ GLT``.
    """
    m = plan.dftsize
    n2 = 2 * m
    halo = WINDOW_HALO[plan.window]
    c = WINDOW_TAPS[plan.window]
    i = np.arange(m)
    k = np.arange(K)

    # fine[k,j] = T_j^k and dmf[k,j] = conj(T_j^(k+1)), exact integer phases
    ang = (-np.pi / m) * ((k[:, None] * i[None, :]) % n2)
    fine = np.cos(ang) + 1j * np.sin(ang)
    angd = (np.pi / m) * (((k[:, None] + 1) * i[None, :]) % n2)
    dmf = np.cos(angd) + 1j * np.sin(angd)

    # synthesis row (twiddle.synthesis_twiddles semantics, float64)
    if plan.latency == 1.0:
        s_re = np.where(i % 2 == 0, 1.0, -1.0)
        s_im = np.zeros(m)
    else:
        w = 2.0 / (1.0 - np.cos(np.pi * plan.latency))
        angs = -np.pi * plan.latency * i
        s_re = w * np.cos(angs)
        s_im = w * np.sin(angs)
    if plan.roi is not None:
        first, last = plan.roi
        roi_mask = ((i >= first) & (i < last)).astype(np.float64)
        s_re = s_re * roi_mask
        s_im = s_im * roi_mask

    # adjoint of the synthesis+conv chain: y = sw*(dft_re@s_re - dft_im@s_im),
    # dft = wgt * conv(aux).  alpha/beta are the coefficients of aux_re/aux_im
    # on the guard-extended bin axis [-halo, m+halo).
    scale = plan.analysis_weight * plan.synthesis_weight
    aR = np.zeros(m + 2 * halo)
    aI = np.zeros(m + 2 * halo)
    for g in range(-halo, halo + 1):
        aR[halo + g: halo + g + m] += scale * c[abs(g)] * s_re
        aI[halo + g: halo + g + m] += -scale * c[abs(g)] * s_im
    # fold the Hermitian guards (c/src/sdft/sdft.h:589-595): aux[-g] =
    # conj(aux[g]) and aux[m-1+g] = conj(aux[m-1-g]) move each guard
    # coefficient onto its mirror bin with the imaginary part negated.
    for g in range(1, halo + 1):
        aR[halo + g] += aR[halo - g]
        aI[halo + g] -= aI[halo - g]
        aR[halo + m - 1 - g] += aR[halo + m - 1 + g]
        aI[halo + m - 1 - g] -= aI[halo + m - 1 + g]
    alpha = aR[halo: halo + m]
    beta = aI[halo: halo + m]

    # adjoint of the demodulation aux = u * dmf
    P = alpha * dmf.real + beta * dmf.imag
    Q = beta * dmf.real - alpha * dmf.imag

    # ROI: bins outside the ROI are never accumulated
    # (c/src/sdft/sdft.h:570); zeroing the fine columns makes u vanish there
    # in both the totals and the G contraction, matching ops.analysis.
    if plan.roi is not None:
        fine = fine * roi_mask
    G = P @ fine.real.T + Q @ fine.imag.T
    GLT = (G * (k[None, :] <= k[:, None])).T
    return fine.real, fine.imag, P, Q, GLT


@functools.lru_cache(maxsize=None)
def _lti_consts_device(plan: Plan, K: int, fd: str):
    """The _lti_constants tables as cached DEVICE arrays in the plan's FD
    dtype — passed into the jitted programs as arguments rather than
    embedded literals (multi-MB constant blobs per (plan, k_tile, block)
    variant made flagship programs slow to compile).

    ensure_compile_time_eval: the first fetch may happen under an active
    trace (callers are used inside larger jitted programs); without it the
    conversions would produce tracers and poison the cache."""
    with jax.ensure_compile_time_eval():
        return tuple(jnp.asarray(a, fd) for a in _lti_constants(plan, K))


@functools.lru_cache(maxsize=None)
def _hop_consts_device(plan: Plan, hop: int, fd: str):
    """_fine_host's hop-tile phase table as cached device arrays."""
    with jax.ensure_compile_time_eval():
        return tuple(jnp.asarray(a, fd) for a in _fine_host(plan, hop))


@functools.lru_cache(maxsize=None)
def _stepped_consts_device(plan: Plan, hop: int, sub: int, fd: str):
    """Tables for the degenerate-hop (hop < 8) fused driver: tiles of
    K = hop*sub samples emit ``sub`` hop spectra each, so the GEMMs keep a
    usable contraction depth at 1-sample hops (the reference's founding
    efficiency claim, /root/reference/README.md:18).

    Returns (sf_re, sf_im, dr_re, dr_im):

      * sf (K, sub*m): column-stacked INCLUSIVE partial fine tables
        sf[k, j*m + i] = fine[k, i] * [k <= j*hop] for j = 0..sub-1 —
        one GEMM dt @ sf yields every inner hop's partial totals
        ptotals_j = sum_{k <= j*hop} delta[k] * T_i^k (the inclusive mask
        absorbs the hop-start delta d0_j WITH its fine[j*hop] phase, so
        ptotals_j * dr_j lands d0_j on conj(T_i) exactly as the sub == 1
        identity requires);
      * dr (sub, m): the inner demod rows T_i^-(j*hop + 1) — the spectrum
        at inner hop j is (c0 + ptotals_j) * dr_j (exact integer phases,
        same construction as _exact_phase_row).
    """
    m = plan.dftsize
    n2 = 2 * m
    K = hop * sub
    fre, fim = _fine_host(plan, K)
    if plan.roi is not None:
        # the accumulate mask folds into the partial-totals columns,
        # matching _lti_constants' masked fine tables
        first, last = plan.roi
        rm = ((np.arange(m) >= first) & (np.arange(m) < last)).astype(float)
        fre = fre * rm
        fim = fim * rm
    k = np.arange(K)[:, None]
    cols = [np.concatenate([fre * (k <= j * hop), fim * (k <= j * hop)],
                           axis=0) for j in range(sub)]
    sf = np.concatenate(cols, axis=1)
    sf_re, sf_im = sf[:K], sf[K:]
    i = np.arange(m)
    e = (-(np.arange(sub) * hop + 1)) % n2
    r = (e[:, None] * i[None, :]) % n2
    ang = (-np.pi / m) * r
    with jax.ensure_compile_time_eval():
        return tuple(jnp.asarray(a, fd) for a in
                     (sf_re, sf_im, np.cos(ang), np.sin(ang)))


def _bf16_split_host(a):
    """Masked bf16 hi+lo split of a host array (hi+lo == f32(a) to ~2^-17).

    Adds 0x8000 to the bit pattern before masking — round-to-nearest on the
    dropped half-word (the carry propagates correctly through the exponent),
    halving the hi error vs plain truncation."""
    import ml_dtypes

    a32 = np.ascontiguousarray(np.asarray(a, np.float32))
    hi32 = ((a32.view(np.uint32) + np.uint32(0x8000))
            & np.uint32(0xFFFF0000)).view(np.float32)
    return (hi32.astype(ml_dtypes.bfloat16),
            (a32 - hi32).astype(ml_dtypes.bfloat16))


@functools.lru_cache(maxsize=None)
def _lti_consts_split_device(plan: Plan, K: int):
    """Plan constants pre-split into bf16 hi/lo device pairs for the
    "split4" mode (fine_re, fine_im, GLT, P^T, Q^T — the y-dots use the
    transposed adjoints directly)."""
    fine_re, fine_im, P, Q, GLT = _lti_constants(plan, K)
    out = []
    with jax.ensure_compile_time_eval():
        for a in (fine_re, fine_im, GLT, P.T, Q.T):
            hi, lo = _bf16_split_host(a)
            out += [jnp.asarray(hi), jnp.asarray(lo)]
    return tuple(out)


def _split_mask(a):
    """In-trace masked bf16 hi+lo split.  Masking, NOT an astype round trip:
    XLA folds f32->bf16->f32 convert chains to identity under excess
    precision, which would zero the lo half.
    The +0x8000 rounds the dropped half-word to nearest (carry propagates
    through the exponent), matching astype's round-to-nearest accuracy."""
    a = a.astype(jnp.float32)
    iv = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        (iv + np.uint32(0x8000)) & np.uint32(0xFFFF0000), jnp.float32)
    return hi.astype(jnp.bfloat16), (a - hi).astype(jnp.bfloat16)


def _dot4(a, b_hi, b_lo):
    """Exact product of split operands: all four bf16 cross products,
    accumulated in f32 — 4 single-pass bf16 dots."""
    a_hi, a_lo = _split_mask(a)

    def d(x, y):
        return jnp.dot(x, y, preferred_element_type=jnp.float32)

    return (d(a_hi, b_hi) + d(a_hi, b_lo)) + (d(a_lo, b_hi) + d(a_lo, b_lo))


def roundtrip_block_lti(plan: Plan, state: State, samples: jnp.ndarray,
                        k_tile: int | None = None):
    """Fused forward+inverse round trip of one block.

    Args:
      plan: static plan.
      state: carry (offset (), delayline (2m,), accumulator (m, 2)), or the
        channel-batched form with a leading (C,) axis on every leaf.
      samples: (M,) or (C, M) real samples, any M (internally zero-padded to
        tiles; zero deltas do not perturb the carry).
      k_tile: samples per tile (static; default: ``default_k_tile(M)``,
        which avoids the measured nt=128 XLA performance cliff).  Larger
        tiles put more of the work in matrix products — the per-element
        work (phase rotations, cumsum, row0 trig) scales with nt = M/k_tile
        while the matrix-product FLOPs are k_tile-invariant — at the cost of larger
        (K, m) constant tables.

    Returns:
      (new_state, y) with y (M,) / (C, M) in TD precision — equal to
      ``isdft_block(plan, sdft_block(plan, state, samples)[1])`` up to
      rounding, with the identical new state.

    Channels fold into the contraction *row* dimension — a (C, nt, K) @
    (K, m) dot is one GEMM over C*nt rows, not C batched small matmuls
    (which is what a vmap over the 1-channel form would compile to; the
    reference analogue is sdft_sdft_nd's flat loop, c/src/sdft/sdft.h:622).
    """
    samples = jnp.asarray(samples)
    K = k_tile or default_k_tile(samples.shape[-1])
    if (plan.precision.resolve().mxu == "split4"
            and plan.precision.resolve().fd == "float32"):
        consts = _lti_consts_split_device(plan, K)
    else:
        consts = _lti_consts_device(plan, K, str(plan.precision.fd_dtype))
    if samples.ndim == 1:
        st = jax.tree.map(lambda a: a[None], state)
        new_st, y = _roundtrip_jit(plan, st, samples[None], consts, K)
        return jax.tree.map(lambda a: a[0], new_st), y[0]
    return _roundtrip_jit(plan, state, samples, consts, K)


@functools.partial(jax.jit, static_argnums=(0, 4))
def _roundtrip_jit(plan: Plan, state: State, samples, consts, k_tile: int):
    return _roundtrip_nd(plan, state, samples, consts, k_tile)


def _phase_rows(offset, nt: int, K: int, m: int, fd):
    """row0[c, t, j] = T_j^((offset_c + t*K) mod 2m) for t in [0, nt).

    The exponent sequence e0_t = offset + t*K (mod 2m) is periodic in t with
    period p = 2m / gcd(K, 2m), so only min(nt, p) rows of transcendentals
    are evaluated; the rest tile bitwise-identically (same integer exponent
    -> same cos/sin input -> same float).
    """
    n2 = 2 * m
    p = n2 // math.gcd(K, n2)
    q = min(nt, p)
    from .twiddle import exponent_dtype, mulmod
    dt = exponent_dtype(m)
    e0 = jnp.mod(offset.astype(dt)[:, None]
                 + jnp.arange(q, dtype=dt)[None, :] * K, n2)
    r = mulmod(e0[..., None], jnp.arange(m, dtype=dt), n2)
    ang = (-np.pi / m) * r.astype(fd)
    row_re = jnp.cos(ang)
    row_im = jnp.sin(ang)
    if nt > q:
        reps = -(-nt // q)
        row_re = jnp.tile(row_re, (1, reps, 1))[:, :nt]
        row_im = jnp.tile(row_im, (1, reps, 1))[:, :nt]
    return row_re, row_im


def _roundtrip_nd(plan: Plan, state: State, samples: jnp.ndarray,
                  consts, k_tile: int):
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    C, M = samples.shape
    K = k_tile
    nt = -(-M // K)
    Mp = nt * K

    split4 = (plan.precision.resolve().mxu == "split4"
              and plan.precision.resolve().fd == "float32")
    if split4:
        (fre_h, fre_l, fim_h, fim_l, glt_h, glt_l,
         pt_h, pt_l, qt_h, qt_l) = consts
    else:
        fine_re, fine_im, P, Q, GLT = consts

    samples = samples.astype(td)
    line = jnp.concatenate([state.delayline, samples], axis=-1)
    delta = (samples - line[:, :M]).astype(fd)
    new_delayline = line[:, M:]
    if Mp != M:
        delta = jnp.pad(delta, ((0, 0), (0, Mp - M)))
    dt = delta.reshape(C, nt, K)

    if split4:
        totals_re = _dot4(dt, fre_h, fre_l)
        totals_im = _dot4(dt, fim_h, fim_l)
    else:
        hi = plan.precision.mxu_precision
        totals_re = jnp.dot(dt, fine_re, precision=hi,
                            preferred_element_type=fd)
        totals_im = jnp.dot(dt, fine_im, precision=hi,
                            preferred_element_type=fd)

    # row0[c,t,j] = T_j^(e0), e0 = offset_c + t*K (mod 2m), exact int phases
    row0_re, row0_im = _phase_rows(state.offset, nt, K, m, fd)

    # rotate tile totals into the global frame; scan the carry across tiles
    rt_re = row0_re * totals_re - row0_im * totals_im
    rt_im = row0_re * totals_im + row0_im * totals_re
    inc_re = jnp.cumsum(rt_re, axis=1)
    inc_im = jnp.cumsum(rt_im, axis=1)
    acc_re = state.accumulator[..., 0].astype(fd)[:, None, :]
    acc_im = state.accumulator[..., 1].astype(fd)[:, None, :]
    prefix_re = acc_re + jnp.concatenate(
        [jnp.zeros_like(inc_re[:, :1]), inc_re[:, :-1]], axis=1)
    prefix_im = acc_im + jnp.concatenate(
        [jnp.zeros_like(inc_im[:, :1]), inc_im[:, :-1]], axis=1)
    acc_out = jnp.stack([acc_re[:, 0] + inc_re[:, -1],
                         acc_im[:, 0] + inc_im[:, -1]], axis=-1)

    # per-tile carry in the demodulated frame: c0 = acc_tile * conj(row0)
    c0_re = prefix_re * row0_re + prefix_im * row0_im
    c0_im = prefix_im * row0_re - prefix_re * row0_im

    if split4:
        y = (_dot4(dt, glt_h, glt_l) + _dot4(c0_re, pt_h, pt_l)
             + _dot4(c0_im, qt_h, qt_l))
    else:
        y = (jnp.dot(dt, GLT, precision=hi, preferred_element_type=fd)
             + jnp.dot(c0_re, P.T, precision=hi, preferred_element_type=fd)
             + jnp.dot(c0_im, Q.T, precision=hi, preferred_element_type=fd))
    y = y.reshape(C, Mp)[:, :M].astype(td)

    new_state = State(
        offset=jnp.mod(state.offset + M, n2).astype(state.offset.dtype),
        delayline=new_delayline,
        accumulator=acc_out.astype(state.accumulator.dtype),
    )
    return new_state, y


@functools.lru_cache(maxsize=None)
def _refresh_tables_device(plan: Plan, fd: str, S: int = 128):
    """Cached split phase tables for the fused accumulator refresh.

    The refresh identity (ops.analysis.refresh_state) is
    acc[i] = T_i^offset * sum_j delayline[j] * T_i^(j mod 2m).  Splitting
    j = a*S + b factors the (2m, m) phasor matrix into fineS[b, i] = T_i^b
    and coarse2[a, i] = T_i^(a*S) — two small cached tables (exact integer
    phases) — so the refresh is two (A*S -> m) dots plus A complex
    rotations, with no per-step (2m, m) table assembly and O((S + 2m/S) * m)
    table memory at any dftsize.
    """
    m = plan.dftsize
    n2 = 2 * m
    A = -(-n2 // S)
    i = np.arange(m)
    angf = (-np.pi / m) * ((np.arange(S)[:, None] * i[None, :]) % n2)
    angc = (-np.pi / m) * (((np.arange(A)[:, None] * S) * i[None, :]) % n2)
    with jax.ensure_compile_time_eval():
        return (jnp.asarray(np.cos(angf), fd), jnp.asarray(np.sin(angf), fd),
                jnp.asarray(np.cos(angc), fd), jnp.asarray(np.sin(angc), fd))


def _exact_phase_row(plan: Plan, exponents, fd):
    """row[c, i] = T_i^exponents[c] via exact integer phases; (C, m) planar."""
    from .twiddle import exponent_dtype, mulmod

    m = plan.dftsize
    n2 = 2 * m
    dt = exponent_dtype(m)
    e = jnp.mod(exponents.astype(dt), n2)
    r = mulmod(e[:, None], jnp.arange(m, dtype=dt)[None, :], n2)
    ang = (-np.pi / m) * r.astype(fd)
    return jnp.cos(ang), jnp.sin(ang)


def _refresh_fused(plan: Plan, state: State, fd) -> State:
    """refresh_state in planar table-split form (same math, cached tables)."""
    m = plan.dftsize
    S = 128
    fS_re, fS_im, c2_re, c2_im = _refresh_tables_device(plan, str(fd), S)
    A = c2_re.shape[0]
    hi = lax.Precision.HIGHEST
    C = state.delayline.shape[0]
    dl = state.delayline.astype(fd)
    if A * S != dl.shape[-1]:       # 2m not a multiple of S: zero-pad rows
        dl = jnp.pad(dl, ((0, 0), (0, A * S - dl.shape[-1])))
    dl = dl.reshape(C, A, S)
    p_re = jnp.dot(dl, fS_re, precision=hi, preferred_element_type=fd)
    p_im = jnp.dot(dl, fS_im, precision=hi, preferred_element_type=fd)
    s_re = jnp.sum(p_re * c2_re[None] - p_im * c2_im[None], axis=1)
    s_im = jnp.sum(p_re * c2_im[None] + p_im * c2_re[None], axis=1)
    o_re, o_im = _exact_phase_row(plan, state.offset, fd)
    acc_re = s_re * o_re - s_im * o_im
    acc_im = s_re * o_im + s_im * o_re
    acc = jnp.stack([acc_re, acc_im], axis=-1)
    if plan.roi is not None:
        first, last = plan.roi
        mask = (np.arange(m) >= first) & (np.arange(m) < last)
        acc = acc * jnp.asarray(mask, acc.dtype)[None, :, None]
    return State(offset=state.offset, delayline=state.delayline,
                 accumulator=acc.astype(state.accumulator.dtype))


def _driver_segment_nd(plan: Plan, state: State, xs: jnp.ndarray,
                       lti_consts, hop: int):
    """A WHOLE chained driver-protocol segment as one batched program — no
    ``lax.scan``, no sequential dependency between blocks at all.

    The key observation: the per-block accumulator refresh
    (ops.analysis.refresh_state) rebuilds the carry as a pure function of
    the last 2m input samples, so every block's starting accumulator is

        acc_start[b][i] = T_i^(offset + b*B) * sum_j x[b*B - 2m + j] * T_i^j

    — computable for ALL blocks at once from strided windows of the input
    stream (two batched dots against the cached split phase tables).
    With the sequential spine gone, the totals GEMMs, prefix cumsums,
    synthesis GEMMs and hop-spectra demodulation are single batched ops
    over all nb*nt tiles: ~15 large XLA ops per SEGMENT instead of ~40
    small ops per BLOCK inside a scan.  Accuracy is strictly better than the scanned
    chain: every block starts from an exactly-refreshed accumulator.

    Args / returns match one _fused_driver_nd call per block of xs
    (nb, C, B): (state', hop_dfts (C, nb, B//hop, m, 2), ys (C, nb, B)).
    """
    import math as _math

    from .twiddle import exponent_dtype, mulmod

    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    nb, C, B = xs.shape
    K = hop
    nt = B // K                      # B % hop == 0 enforced by the caller
    G = nb * nt

    split4 = (plan.precision.resolve().mxu == "split4"
              and plan.precision.resolve().fd == "float32")
    hi = plan.precision.mxu_precision
    if split4:
        split_consts, exact_consts = lti_consts
        (_, _, _, _, glt_h, glt_l, pt_h, pt_l, qt_h, qt_l) = split_consts
        fine_re, fine_im, P, Q, GLT = exact_consts
    else:
        fine_re, fine_im, P, Q, GLT = lti_consts

    x = xs.astype(td).transpose(1, 0, 2).reshape(C, nb * B)
    stream = jnp.concatenate([state.delayline, x], axis=-1)  # (C, 2m + nb*B)
    delta = (x - stream[:, :nb * B]).astype(fd)
    dt = delta.reshape(C, G, K)

    totals_re = jnp.dot(dt, fine_re, precision=hi, preferred_element_type=fd)
    totals_im = jnp.dot(dt, fine_im, precision=hi, preferred_element_type=fd)

    # tile-start phase rows: the exponent sequence offset + g*K (mod 2m) is
    # periodic with period q, so only q rows of exact trig are evaluated
    q = n2 // _math.gcd(K, n2)
    dtI = exponent_dtype(m)
    # indices needed: tile rows g in [0, G) plus the block/end rows b*nt
    # for b in [0, nb] (max G) — a full period q, or G+1 direct rows
    eq = jnp.mod(state.offset.astype(dtI)[:, None]
                 + jnp.arange(min(q, G + 1), dtype=dtI)[None, :] * K, n2)
    rq = mulmod(eq[..., None], jnp.arange(m, dtype=dtI)[None, None, :], n2)
    ang = (-np.pi / m) * rq.astype(fd)
    rq_re = jnp.cos(ang)                                  # (C, q', m)
    rq_im = jnp.sin(ang)
    gidx = jnp.mod(jnp.arange(G), rq_re.shape[1])
    row_re = jnp.take(rq_re, gidx, axis=1)                # (C, G, m)
    row_im = jnp.take(rq_im, gidx, axis=1)

    rt_re = (row_re * totals_re - row_im * totals_im).reshape(C, nb, nt, m)
    rt_im = (row_re * totals_im + row_im * totals_re).reshape(C, nb, nt, m)
    inc_re = jnp.cumsum(rt_re, axis=2)
    inc_im = jnp.cumsum(rt_im, axis=2)

    # batched refresh: acc at every block start (and the stream end, as one
    # extra window row) from strided 2m-windows of the stream
    S = 128
    fS_re, fS_im, c2_re, c2_im = _refresh_tables_device(plan, str(fd), S)
    A = c2_re.shape[0]
    widx = (jnp.arange(nb + 1)[:, None] * B
            + jnp.arange(n2)[None, :])                    # (nb+1, 2m)
    win = jnp.take(stream, widx, axis=1).astype(fd)       # (C, nb+1, 2m)
    if A * S != n2:
        win = jnp.pad(win, ((0, 0), (0, 0), (0, A * S - n2)))
    wp = win.reshape(C, nb + 1, A, S)
    hiP = lax.Precision.HIGHEST
    p_re = jnp.dot(wp, fS_re, precision=hiP, preferred_element_type=fd)
    p_im = jnp.dot(wp, fS_im, precision=hiP, preferred_element_type=fd)
    s_re = jnp.sum(p_re * c2_re[None, None] - p_im * c2_im[None, None],
                   axis=2)                                # (C, nb+1, m)
    s_im = jnp.sum(p_re * c2_im[None, None] + p_im * c2_re[None, None],
                   axis=2)
    # rotate by T^(offset + b*B): exponent of tile g = b*nt — the SAME
    # periodic row table (b*B = (b*nt)*K)
    bidx = jnp.mod(jnp.arange(nb + 1) * nt, rq_re.shape[1])
    o_re = jnp.take(rq_re, bidx, axis=1)
    o_im = jnp.take(rq_im, bidx, axis=1)
    a0_re = s_re * o_re - s_im * o_im                     # (C, nb+1, m)
    a0_im = s_re * o_im + s_im * o_re
    if plan.roi is not None:
        first, last = plan.roi
        roi_mask = jnp.asarray(
            (np.arange(m) >= first) & (np.arange(m) < last), fd)
        a0_re = a0_re * roi_mask
        a0_im = a0_im * roi_mask

    prefix_re = a0_re[:, :nb, None, :] + jnp.concatenate(
        [jnp.zeros_like(inc_re[:, :, :1]), inc_re[:, :, :-1]], axis=2)
    prefix_im = a0_im[:, :nb, None, :] + jnp.concatenate(
        [jnp.zeros_like(inc_im[:, :, :1]), inc_im[:, :, :-1]], axis=2)
    r4_re = row_re.reshape(C, nb, nt, m)
    r4_im = row_im.reshape(C, nb, nt, m)
    c0_re = prefix_re * r4_re + prefix_im * r4_im
    c0_im = prefix_im * r4_re - prefix_re * r4_im

    # synthesis leg (GEMMs over all tiles at once)
    c0f_re = c0_re.reshape(C, G, m)
    c0f_im = c0_im.reshape(C, G, m)
    if split4:
        y = (_dot4(dt, glt_h, glt_l) + _dot4(c0f_re, pt_h, pt_l)
             + _dot4(c0f_im, qt_h, qt_l))
    else:
        y = (jnp.dot(dt, GLT, precision=hi, preferred_element_type=fd)
             + jnp.dot(c0f_re, P.T, precision=hi, preferred_element_type=fd)
             + jnp.dot(c0f_im, Q.T, precision=hi, preferred_element_type=fd))
    ys = y.reshape(C, nb, B).astype(td)

    # hopped analysis leg: aux = (c0 + d0) * conj(T_i), window conv
    d0 = dt[:, :, 0].astype(fd).reshape(C, nb, nt, 1)
    if plan.roi is not None:
        d0 = d0 * roi_mask
    cb_re, cb_im = _exact_phase_row(plan, -jnp.ones((1,), jnp.int32), fd)
    u_re = c0_re + d0
    u_im = c0_im
    aux_re = u_re * cb_re - u_im * cb_im
    aux_im = u_re * cb_im + u_im * cb_re
    from .convolve import window_convolve
    out = window_convolve(plan, (aux_re + 1j * aux_im).astype(
        plan.precision.fdx_dtype))
    if plan.roi is not None:
        out = out * roi_mask.astype(out.dtype)
    hop_dfts = pack(out)                                  # (C, nb, nt, m, 2)

    new_state = State(
        offset=jnp.mod(state.offset + nb * B, n2).astype(state.offset.dtype),
        delayline=stream[:, -n2:].astype(td),
        accumulator=jnp.stack([a0_re[:, nb], a0_im[:, nb]],
                              axis=-1).astype(state.accumulator.dtype),
    )
    return new_state, hop_dfts, ys


@functools.partial(jax.jit, static_argnums=(0, 4))
def _driver_segment_jit(plan: Plan, state: State, xs, consts, hop: int):
    return _driver_segment_nd(plan, state, xs, consts, hop)


def _fused_driver_nd(plan: Plan, state: State, samples: jnp.ndarray,
                     lti_consts, hop: int, refresh: bool, sub: int = 1):
    """One block of the reference driver protocol (test/test.c:69-83) as a
    SINGLE fused pass: hop-rate spectra + synthesized samples + optional
    accumulator refresh, sharing one comb/delta stage, one pair of totals
    GEMMs and one phase-row/prefix computation.

    The key identity: with tiles of length ``hop``, the per-tile demodulated
    carry c0 = prefix * conj(row0) required by the synthesis adjoint ALSO
    yields each hop's spectrum —

        aux_t[i] = (c0_t[i] + d0_t) * conj(T_i)

    (the accumulator right after the tile's first sample, demodulated;
    |row0| = 1 cancels the rotation) — so the hopped analysis costs one
    elementwise pass over the (nt, m) c0 rows instead of a second
    delta/GEMM/prefix pipeline.

    ``sub > 1`` generalizes to DEGENERATE hops (hop < 8): tiles of
    K = hop*sub samples emit ``sub`` spectra each.  The inner hop j's
    carry extends the identity by the tile-local partial totals
    (one extra GEMM against the stepped table, _stepped_consts_device):

        aux_{t,j}[i] = (c0_t[i] + ptotals_j[i] + d0_{t,j}) * T_i^-(j*hop+1)

    so 1-sample hops (the reference's founding efficiency claim,
    /root/reference/README.md:18) keep full-depth GEMMs instead of
    (nt, 1) @ (1, m) matvecs that the compiler pads to whole matrix tiles.
    """
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    C, M = samples.shape
    if sub > 1:
        lti_consts, stepped = lti_consts
    K = hop * sub
    nt = -(-M // K)
    Mp = nt * K

    split4 = (plan.precision.resolve().mxu == "split4"
              and plan.precision.resolve().fd == "float32")
    hi = plan.precision.mxu_precision
    if split4:
        # split4 speeds up the SYNTHESIS GEMMs only; the totals (and with
        # them the prefix, carry and hop spectra) stay on the exact path,
        # bit-identical to a non-split4 plan (test_split4_chained_driver_
        # protocol documents this contract)
        split_consts, exact_consts = lti_consts
        (_, _, _, _, glt_h, glt_l, pt_h, pt_l, qt_h, qt_l) = split_consts
        fine_re, fine_im, P, Q, GLT = exact_consts
    else:
        fine_re, fine_im, P, Q, GLT = lti_consts

    samples = samples.astype(td)
    line = jnp.concatenate([state.delayline, samples], axis=-1)
    delta = (samples - line[:, :M]).astype(fd)
    new_delayline = line[:, M:]
    if Mp != M:
        delta = jnp.pad(delta, ((0, 0), (0, Mp - M)))
    dt = delta.reshape(C, nt, K)

    totals_re = jnp.dot(dt, fine_re, precision=hi,
                        preferred_element_type=fd)
    totals_im = jnp.dot(dt, fine_im, precision=hi,
                        preferred_element_type=fd)

    row0_re, row0_im = _phase_rows(state.offset, nt, K, m, fd)
    rt_re = row0_re * totals_re - row0_im * totals_im
    rt_im = row0_re * totals_im + row0_im * totals_re
    inc_re = jnp.cumsum(rt_re, axis=1)
    inc_im = jnp.cumsum(rt_im, axis=1)
    acc_re = state.accumulator[..., 0].astype(fd)[:, None, :]
    acc_im = state.accumulator[..., 1].astype(fd)[:, None, :]
    prefix_re = acc_re + jnp.concatenate(
        [jnp.zeros_like(inc_re[:, :1]), inc_re[:, :-1]], axis=1)
    prefix_im = acc_im + jnp.concatenate(
        [jnp.zeros_like(inc_im[:, :1]), inc_im[:, :-1]], axis=1)
    acc_out = jnp.stack([acc_re[:, 0] + inc_re[:, -1],
                         acc_im[:, 0] + inc_im[:, -1]], axis=-1)

    c0_re = prefix_re * row0_re + prefix_im * row0_im
    c0_im = prefix_im * row0_re - prefix_re * row0_im

    # synthesis leg: y = delta @ (G o L)^T + c0 @ [P; Q]^T
    if split4:
        y = (_dot4(dt, glt_h, glt_l) + _dot4(c0_re, pt_h, pt_l)
             + _dot4(c0_im, qt_h, qt_l))
    else:
        y = (jnp.dot(dt, GLT, precision=hi, preferred_element_type=fd)
             + jnp.dot(c0_re, P.T, precision=hi, preferred_element_type=fd)
             + jnp.dot(c0_im, Q.T, precision=hi, preferred_element_type=fd))
    y = y.reshape(C, Mp)[:, :M].astype(td)

    # hopped analysis leg: aux = (c0 + ptotals + d0) * demod, window conv
    roi_mask = None
    if plan.roi is not None:
        first, last = plan.roi
        roi_mask = jnp.asarray(
            (np.arange(m) >= first) & (np.arange(m) < last), fd)
    if sub == 1:
        d0 = dt[:, :, 0].astype(fd)[..., None]
        if roi_mask is not None:
            d0 = d0 * roi_mask
        cb_re, cb_im = _exact_phase_row(
            plan, -jnp.ones((1,), jnp.int32), fd)        # conj(T_i) row
        u_re = c0_re + d0
        u_im = c0_im
        aux_re = u_re * cb_re - u_im * cb_im
        aux_im = u_re * cb_im + u_im * cb_re
    else:
        sf_re, sf_im, dr_re, dr_im = stepped
        pt_re = jnp.dot(dt, sf_re, precision=hi,
                        preferred_element_type=fd).reshape(C, nt, sub, m)
        pt_im = jnp.dot(dt, sf_im, precision=hi,
                        preferred_element_type=fd).reshape(C, nt, sub, m)
        u_re = c0_re[:, :, None, :] + pt_re
        u_im = c0_im[:, :, None, :] + pt_im
        aux_re = (u_re * dr_re - u_im * dr_im).reshape(C, nt * sub, m)
        aux_im = (u_re * dr_im + u_im * dr_re).reshape(C, nt * sub, m)
        nh = -(-M // hop)
        aux_re = aux_re[:, :nh]
        aux_im = aux_im[:, :nh]
    from .convolve import window_convolve
    out = window_convolve(plan, (aux_re + 1j * aux_im).astype(
        plan.precision.fdx_dtype))
    if roi_mask is not None:
        out = out * roi_mask.astype(out.dtype)
    hop_dfts = pack(out)

    new_state = State(
        offset=jnp.mod(state.offset + M, n2).astype(state.offset.dtype),
        delayline=new_delayline,
        accumulator=acc_out.astype(state.accumulator.dtype),
    )
    if refresh:
        new_state = _refresh_fused(plan, new_state, fd)
    return new_state, hop_dfts, y


@functools.partial(jax.jit, static_argnums=(0, 4, 5, 6))
def _fused_driver_jit(plan: Plan, state: State, samples, consts, hop: int,
                      refresh: bool, sub: int = 1):
    return _fused_driver_nd(plan, state, samples, consts, hop, refresh, sub)


def _fused_driver_consts(plan: Plan, hop: int, sub: int):
    """Device consts for the fused driver at tile K = hop*sub (the
    (split4?, stepped?) packing _fused_driver_nd expects)."""
    fd = str(plan.precision.fd_dtype)
    K = hop * sub
    if (plan.precision.resolve().mxu == "split4"
            and plan.precision.resolve().fd == "float32"):
        base = (_lti_consts_split_device(plan, K),
                _lti_consts_device(plan, K, fd))
    else:
        base = _lti_consts_device(plan, K, fd)
    if sub == 1:
        return base
    return (base, _stepped_consts_device(plan, hop, sub, fd))


def driver_sub_factor(hop: int, tile_target: int = 8) -> int:
    """Inner-hop multiplicity for degenerate hops: the smallest ``sub``
    with hop*sub >= tile_target (1 for hop >= tile_target)."""
    return max(1, -(-tile_target // hop))


def roundtrip_hopped_block(plan: Plan, state: State, samples: jnp.ndarray,
                           hop: int, refresh: bool = False):
    """Fused single-block driver protocol: (state, hop_dfts, y) — the
    hop-rate spectra AND the synthesized round trip of one block in one
    pass (see _fused_driver_nd).  ``refresh`` exactly rebuilds the carried
    accumulator from the delayline before returning (drift-free streams).
    Degenerate hops (< 8) take multi-hop tiles automatically."""
    samples = jnp.asarray(samples)
    sub = driver_sub_factor(hop)
    consts = _fused_driver_consts(plan, hop, sub)
    if samples.ndim == 1:
        st = jax.tree.map(lambda a: a[None], state)
        new_st, hd, y = _fused_driver_jit(plan, st, samples[None], consts,
                                          hop, refresh, sub)
        return jax.tree.map(lambda a: a[0], new_st), hd[0], y[0]
    return _fused_driver_jit(plan, state, samples, consts, hop, refresh, sub)


def roundtrip_hopped_chain(plan: Plan, state: State, xs: jnp.ndarray,
                           hop: int, k_tile: int | None = None,
                           refresh_every: int | None = 1,
                           segment: bool = False):
    """Chain many hop-blocks inside ONE compiled program — the fast form of
    the reference driver protocol (test/test.c:69-83: stream hop-chunked
    samples through carried plan state, keep each hop's first DFT vector and
    the synthesized samples).

    Dispatching one program per block pays a dispatch per sub-ms block;
    this runs a
    ``lax.scan`` over the stacked blocks so the whole stream segment is one
    dispatch + one fetch, exactly the shape of the chained benchmark
    (bench.py).  Each scan step shares one comb/delta pass between the
    hopped analysis and the collapsed-LTI round trip (XLA CSEs the common
    subexpressions) and optionally refreshes the accumulator.

    Args:
      plan: static plan.
      state: carry — unbatched for xs (nb, B), channel-batched for
        xs (nb, C, B).
      xs: stacked sample blocks, each a multiple of ``hop`` long.
      hop: hop size in samples (static).
      k_tile: degenerate hops (< 8) only — the multi-hop TILE TARGET
        (static, default 8): tiles span sub = ceil(k_tile/hop) hops.
        Ignored for hop >= 8, where tiles are the hop itself.
      refresh_every: exactly rebuild the accumulator from the delayline
        every N scan steps (ops.analysis.refresh_state) — two matvecs
        that zero the f32 carry drift of long streams, keeping the
        f32 path inside the reference 1e-7 gate regardless of stream
        length.  None disables.

    Returns:
      (new_state, hop_dfts, ys) with hop_dfts packed
      (nb, B//hop, m, 2) [or (nb, C, B//hop, m, 2)] and ys (nb, B)
      [or (nb, C, B)].
    """
    xs = jnp.asarray(xs)
    fd = str(plan.precision.fd_dtype)
    split4 = (plan.precision.resolve().mxu == "split4"
              and plan.precision.resolve().fd == "float32")
    if hop >= 8:
        # scan of fused single-pass blocks — measured faster than the
        # scan-free batched segment (_driver_segment_nd) at the canonical
        # sizes on the previous accelerator (the segment's O(nb*nt*m)
        # batched temps cost more memory traffic than the scan's op
        # overhead; not measured on the GPU).  segment=True on
        # roundtrip_hopped_chain selects the batched form.  k_tile is
        # unused here (tiles are the hop itself).
        consts = ((_lti_consts_split_device(plan, hop),
                   _lti_consts_device(plan, hop, fd)) if split4
                  else _lti_consts_device(plan, hop, fd))
        if segment:
            if xs.shape[-1] % hop:
                # _driver_segment_nd's batched tile reshape requires whole
                # hops per block (the scan body zero-pads instead)
                raise ValueError(
                    f"segment=True requires block length ({xs.shape[-1]}) "
                    f"to be a multiple of hop ({hop})")
            if refresh_every not in (None, 1):
                # the batched segment rebuilds every block's accumulator
                # from the stream by construction — a coarser cadence is
                # not expressible there
                raise ValueError(
                    "segment=True refreshes every block by construction; "
                    "refresh_every must be None or 1")
            if xs.ndim == 2:
                st = jax.tree.map(lambda a: a[None], state)
                st, hd, ys = _driver_segment_jit(plan, st, xs[:, None],
                                                 consts, hop)
                return (jax.tree.map(lambda a: a[0], st), hd[0], ys[0])
            st, hd, ys = _driver_segment_jit(plan, state, xs, consts, hop)
            return (st, jnp.moveaxis(hd, 0, 1), jnp.moveaxis(ys, 0, 1))
        return _chain_fused_jit(plan, state, xs, consts, hop, refresh_every)
    # degenerate hops (hop < 8): the same fused body over multi-hop tiles
    # of K = hop*sub samples, each emitting ``sub`` spectra (the stepped
    # partial-totals GEMM, _stepped_consts_device) — tiles of < 8 samples
    # would starve the GEMMs (the compiler pads skinny contractions to
    # whole matrix tiles).  ``k_tile`` here sets the TILE TARGET (default 8): sub =
    # ceil(k_tile/hop).
    if xs.shape[-1] % hop:
        raise ValueError(
            f"block length ({xs.shape[-1]}) must be a multiple of the "
            f"hop ({hop})")
    sub = driver_sub_factor(hop, k_tile or 8)
    consts = _fused_driver_consts(plan, hop, sub)
    return _chain_fused_jit(plan, state, xs, consts, hop, refresh_every,
                            sub)


def refresh_state_any(plan: Plan, st: State) -> State:
    """_refresh_fused over a batched OR unbatched state (the batch
    axis is added/stripped as needed) — the one shared implementation for
    every chain body and bench harness."""
    fd = plan.precision.fd_dtype
    if st.offset.ndim == 0:
        stb = jax.tree.map(lambda a: a[None], st)
        return jax.tree.map(lambda a: a[0], _refresh_fused(plan, stb, fd))
    return _refresh_fused(plan, st, fd)


def _chain_refresh(plan: Plan, refresh_every, body_out_state, since):
    """Shared refresh-cadence logic for the chain bodies; returns
    (state, since).  refresh_every in (None, 1) is handled statically by
    the callers."""
    since = since + 1
    st = jax.lax.cond(since >= refresh_every,
                      lambda s: refresh_state_any(plan, s), lambda s: s,
                      body_out_state)
    since = jnp.where(since >= refresh_every, 0, since)
    return st, since


@functools.partial(jax.jit, static_argnums=(0, 4, 5, 6))
def _chain_fused_jit(plan: Plan, state: State, xs, consts, hop: int,
                     refresh_every: int | None, sub: int = 1):
    def body(carry, x):
        st, since = carry
        refresh = refresh_every == 1
        if x.ndim == 1:
            stb = jax.tree.map(lambda a: a[None], st)
            stb, hd, y = _fused_driver_nd(plan, stb, x[None], consts, hop,
                                          refresh, sub)
            st, hd, y = jax.tree.map(lambda a: a[0], stb), hd[0], y[0]
        else:
            st, hd, y = _fused_driver_nd(plan, st, x, consts, hop, refresh,
                                         sub)
        if refresh_every in (None, 1):
            return (st, since), (hd, y)
        st, since = _chain_refresh(plan, refresh_every, st, since)
        return (st, since), (hd, y)

    (state, _), (hdfts, ys) = jax.lax.scan(
        body, (state, jnp.zeros((), jnp.int32)), xs)
    return state, hdfts, ys


def sdft_hopped(plan: Plan, state: State, samples: jnp.ndarray, hop: int):
    """Forward analysis emitting one spectrum per hop (at samples 0, hop,
    2*hop, ... of the block) — the reference driver protocol, which keeps
    each hop's first DFT vector only (test/test.c:69-83,82; test/test.py:48).

    Uses the same prefix machinery as the collapsed round trip: with tiles of
    length ``hop``, the selected spectrum is just the demodulated+windowed
    tile-start accumulator, so the per-sample scan disappears — one
    (nt,hop)@(hop,m) matmul + O(nt*m) elementwise work, a ~hop-fold
    saving over materializing every spectrum.

    Args:
      plan: static plan.
      state: carry (offset (), delayline (2m,), accumulator (m, 2)), or the
        channel-batched form with a leading (C,) axis on every leaf.
      samples: (M,) or (C, M) real samples (the last partial hop, if any,
        still advances the carry; its spectrum is emitted if it has a first
        sample).
      hop: hop size in samples (static).

    Returns:
      (new_state, dfts) with dfts packed (ceil(M/hop), m, 2) or
      (C, ceil(M/hop), m, 2) — identical (up to rounding) to
      ``sdft_block(...)[1][..., ::hop, :, :]``.

    Channels fold into the contraction row dims (see roundtrip_block_lti).
    """
    samples = jnp.asarray(samples)
    fd_s = str(plan.precision.fd_dtype)
    # degenerate hops (< 8) ride multi-hop tiles: K = hop*sub with the
    # stepped INCLUSIVE partial-totals table, so a 1-sample hop keeps a
    # full-depth contraction instead of (nt, 1) @ (1, m) matvecs (same
    # identity as the fused driver, _stepped_consts_device)
    sub = driver_sub_factor(hop)
    consts = _hop_consts_device(plan, hop * sub, fd_s)
    if sub > 1:
        consts = consts + _stepped_consts_device(plan, hop, sub, fd_s)
    if samples.ndim == 1:
        st = jax.tree.map(lambda a: a[None], state)
        new_st, d = _hopped_jit(plan, st, samples[None], consts, hop, sub)
        return jax.tree.map(lambda a: a[0], new_st), d[0]
    return _hopped_jit(plan, state, samples, consts, hop, sub)


@functools.partial(jax.jit, static_argnums=(0, 4, 5))
def _hopped_jit(plan: Plan, state: State, samples, consts, hop: int,
                sub: int = 1):
    return _hopped_nd(plan, state, samples, consts, hop, sub)


def _hopped_nd(plan: Plan, state: State, samples: jnp.ndarray, consts,
               hop: int, sub: int = 1):
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    cd = plan.precision.fdx_dtype
    C, M = samples.shape
    K = hop * sub
    nt = -(-M // K)
    Mp = nt * K

    fine_re, fine_im, *stepped = consts
    if plan.roi is not None:
        first, last = plan.roi
        roi_mask = ((np.arange(m) >= first) & (np.arange(m) < last))
        fine_re = fine_re * jnp.asarray(roi_mask, fd)
        fine_im = fine_im * jnp.asarray(roi_mask, fd)

    samples = samples.astype(td)
    line = jnp.concatenate([state.delayline, samples], axis=-1)
    delta = (samples - line[:, :M]).astype(fd)
    new_delayline = line[:, M:]
    if Mp != M:
        delta = jnp.pad(delta, ((0, 0), (0, Mp - M)))
    dt = delta.reshape(C, nt, K)

    hi = plan.precision.mxu_precision
    totals_re = jnp.dot(dt, fine_re, precision=hi, preferred_element_type=fd)
    totals_im = jnp.dot(dt, fine_im, precision=hi, preferred_element_type=fd)

    row_re, row_im = _phase_rows(state.offset, nt, K, m, fd)
    row0 = row_re + 1j * row_im
    totals = (totals_re + 1j * totals_im).astype(cd)

    rt = row0 * totals
    inc = jnp.cumsum(rt, axis=1)
    acc_in = (state.accumulator[..., 0] + 1j * state.accumulator[..., 1]
              ).astype(cd)[:, None, :]
    prefix = acc_in + jnp.concatenate(
        [jnp.zeros_like(inc[:, :1]), inc[:, :-1]], axis=1)
    acc_out = pack((acc_in[:, 0] + inc[:, -1]).astype(cd))

    if sub == 1:
        # accumulator right after each tile's first sample, demodulated by
        # conj(T^(e0+1)) = conj(row0) * conj(T_j)  (c/src/sdft/sdft.h:585)
        d0 = dt[:, :, 0].astype(cd)[..., None]
        acc_sel = prefix + d0 * (row0 if plan.roi is None
                                 else row0 * jnp.asarray(roi_mask, fd))
        conj_base = jnp.exp(1j * (np.pi / m)
                            * jnp.arange(m, dtype=jnp.int32).astype(fd)
                            ).astype(cd)
        aux = acc_sel * jnp.conj(row0) * conj_base
    else:
        # inner hops via the inclusive stepped partial totals: the spectrum
        # at hop j of a tile is (c0 + ptotals_j) * T^-(j*hop+1)
        sf_re, sf_im, dr_re, dr_im = stepped
        c0 = prefix * jnp.conj(row0)
        pt_re = jnp.dot(dt, sf_re, precision=hi,
                        preferred_element_type=fd).reshape(C, nt, sub, m)
        pt_im = jnp.dot(dt, sf_im, precision=hi,
                        preferred_element_type=fd).reshape(C, nt, sub, m)
        u = c0[:, :, None, :] + (pt_re + 1j * pt_im).astype(cd)
        dr = (dr_re + 1j * dr_im).astype(cd)              # (sub, m)
        nh = -(-M // hop)
        aux = (u * dr).reshape(C, nt * sub, m)[:, :nh]

    from .convolve import window_convolve
    out = window_convolve(plan, aux)
    if plan.roi is not None:
        out = out * jnp.asarray(roi_mask, out.dtype)

    new_state = State(
        offset=jnp.mod(state.offset + M, n2).astype(state.offset.dtype),
        delayline=new_delayline,
        accumulator=acc_out.astype(state.accumulator.dtype),
    )
    return new_state, pack(out)
