"""Per-sample spectra kernel for NVIDIA Hopper GPUs (Pallas, ``backend="triton"``).

The XLA composition of ``ops.analysis.sdft_block`` materializes several
complex (M, m) intermediates (rotated deltas, the prefix sum, the
demodulated accumulator, the convolved spectra and the packed copy).  This
kernel writes the spectra once and reads nothing of size O(M*m).

Algebra (block of M samples in tiles of K, per tile t and in-tile row k):

    aux[k, i] = dmf[k, i] * (c0_t[i] + sum_{k' <= k} delta[k'] * T_i^k')
    dft[k, i] = sum_g c_|g| * aux[k, i + g]          (window, g = -h..h)

with T_i = exp(-j*pi*i/m), dmf[k, i] = T_i^-(k+1) and c0_t the tile-start
accumulator in the demodulated frame.  Because T_{i+g} = T_i * T_g on the
natural (periodic) bin axis, the window folds into the two terms without a
bin halo on the GEMM side:

  * the in-tile part is ONE Toeplitz product, Toep_w @ dmf, with
    Toep_w[k, j] = delta[k - j] * w[j] and the real weights
    w[j] = c_0 + 2 * sum_g c_g * cos(pi * g * (j + 1) / m);
  * the carry part is dmf[k, i] * X[k, i] with
    X[k, i] = c_0*c0[i] + sum_g cos(th)*E_g[i] + sin(th)*F_g[i],
    th = pi*g*(k+1)/m, E_g = c_g*(c0[i+g] + c0[i-g]),
    F_g = j*c_g*(c0[i+g] - c0[i-g]) — a 2h+1-column stencil of c0 only.

The natural axis equals the Hermitian-guarded one everywhere except the top
``h`` bins (guards mirror around m-1) and, for ROI plans, the ``h`` bins
inside each ROI edge.  Those few columns are recomputed exactly in XLA
(O(M * h) work) and written over the kernel's output.

Each program owns super_r * tile_k rows by block_n bins (KernelConfig): no
state crosses programs, so the grid (time blocks, bin blocks) is fully
parallel.  The
Toeplitz contraction keeps the repository's exact-product class: both
operands are split into bf16 hi/lo halves and the three significant cross
products are accumulated in f32 on the tensor cores (~2^-17 relative per
product, ~3e-6 of the spectrum scale end to end).

Everything sequential (comb deltas, per-tile totals, the carry prefix, the
next state and the exact edge columns) is a short XLA prologue on (M/K, m)
arrays.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..plan import Plan
from ..state import State
from ..windows import WINDOW_HALO, WINDOW_TAPS
from ..ops.lti import _bf16_split_host, _phase_rows, _split_mask

#: Columns of c0 padding each side: the widest window stencil reaches 2 bins.
C0_PAD = 2


class KernelConfig(NamedTuple):
    """Tiling of the spectra kernel (static; hashable for jit).

    tile_k: Toeplitz depth, samples per sub-tile (a power of two >= 16).
    block_n: bins per program (a power of two).
    super_r: sub-tiles per program; the tables are loaded once for all.
    """

    tile_k: int = 64
    block_n: int = 64
    super_r: int = 4


#: The fastest tiling of a sweep on an H100 at m=4096 and m=1000, 32768
#: samples, over packed f32, planar bf16 and power bf16 outputs
#: (scripts/sweep_spectra.py, PERF.md).
DEFAULT_CONFIG = KernelConfig()

#: Triton launch parameters (fixed: 2 warps spill at tile_k 64, 8 lose).
NUM_WARPS = 4
NUM_STAGES = 2

#: Largest m the kernel takes: the largest checked on the card.
MAX_KERNEL_DFTSIZE = 65536

#: The kernel's loads and stores index with int32 offsets, so one call's
#: output (all channels, two values per bin as in the packed layout) stays
#: below 2^31 elements; larger calls take the XLA composition.
MAX_OUTPUT_ELEMENTS = 2**31


def kernel_platform(platform: str | None = None) -> bool:
    """The dispatch rule: the kernel runs where JAX's backend is a GPU.

    Elsewhere (the CPU) every entry point takes the XLA composition; a
    kernel runs in interpret mode only where a caller passes
    ``interpret=True`` (the CPU tests)."""
    return (platform or jax.default_backend()) == "gpu"


def plan_supported(plan: Plan) -> bool:
    """Whether the kernel computes this plan: float32 TD/FD, 128 <= m <=
    MAX_KERNEL_DFTSIZE (smaller plans gain nothing).  Any output element
    type; the block length is bounded by :func:`fits`."""
    p = plan.precision.resolve()
    return (p.td == "float32" and p.fd == "float32"
            and 128 <= plan.dftsize <= MAX_KERNEL_DFTSIZE)


def fits(plan: Plan, n_samples: int) -> bool:
    """Whether one kernel call over ``n_samples`` samples (all channels of
    a batch together) stays within the int32 output range."""
    return n_samples * plan.dftsize * 2 <= MAX_OUTPUT_ELEMENTS


def use_kernel(plan: Plan, n_samples: int, platform: str | None = None
               ) -> bool:
    """True where api.sdft / sdft_power / sharded_sdft take the kernel for
    a call over ``n_samples`` samples (per device, all channels)."""
    return (kernel_platform(platform) and plan_supported(plan)
            and fits(plan, n_samples))


def _check(plan: Plan, n_samples: int, entry: str):
    if not plan_supported(plan):
        raise ValueError(f"plan {plan} is outside the spectra kernel (float32 "
                         f"TD/FD and 128 <= m <= {MAX_KERNEL_DFTSIZE} only); "
                         f"use {entry}")
    if not fits(plan, n_samples):
        raise ValueError(f"{n_samples} samples at m={plan.dftsize} exceed "
                         f"the kernel's int32 output range; use {entry}")


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _taps(plan: Plan):
    wgt = plan.analysis_weight
    return tuple(float(c * wgt) for c in WINDOW_TAPS[plan.window])


@functools.lru_cache(maxsize=None)
def _tables(plan: Plan, K: int, block_n: int):
    """Device tables (built once per plan and tiling, exact integer phases):

      * fine (K, m) f32 pair, T_i^k with the ROI accumulate mask — the
        per-tile totals GEMM and the exact edge columns;
      * dmf (K, Wt) f32 pair, T_i^-(k+1) on the natural axis, Wt = m
        rounded up to whole bin blocks — the carry term in the kernel;
      * the bf16 hi/lo splits of dmf — the Toeplitz GEMM's B operand;
      * w (K,) f32 — the window folded into the Toeplitz rows.
    """
    m = plan.dftsize
    n2 = 2 * m
    Wt = _round_up(m, block_n)
    k = np.arange(K)
    i = np.arange(m)
    af = (-np.pi / m) * ((k[:, None] * i[None, :]) % n2)
    mask = np.ones(m)
    if plan.roi is not None:
        first, last = plan.roi
        mask = ((i >= first) & (i < last)).astype(np.float64)
    fine_re = np.cos(af) * mask
    fine_im = np.sin(af) * mask

    iw = np.arange(Wt)
    ad = (np.pi / m) * (((k[:, None] + 1) * iw[None, :]) % n2)
    dre = np.cos(ad).astype(np.float32)
    dim = np.sin(ad).astype(np.float32)
    splits = _bf16_split_host(dre) + _bf16_split_host(dim)

    taps = _taps(plan)
    w = np.full(K, taps[0])
    for g in range(1, WINDOW_HALO[plan.window] + 1):
        w = w + 2 * taps[g] * np.cos(np.pi * g * (k + 1) / m)

    with jax.ensure_compile_time_eval():
        return (jnp.asarray(fine_re, jnp.float32),
                jnp.asarray(fine_im, jnp.float32),
                jnp.asarray(dre), jnp.asarray(dim),
                *(jnp.asarray(s) for s in splits),
                jnp.asarray(w, jnp.float32))


def fix_columns(plan: Plan) -> tuple[int, ...]:
    """Output bins where the natural-axis stencil differs from the guarded,
    ROI-masked one: the top ``halo`` bins, and the ``halo`` bins inside each
    ROI edge.  Bins outside the ROI are zero and need no fix."""
    m = plan.dftsize
    h = WINDOW_HALO[plan.window]
    if h == 0:
        return ()
    first, last = plan.roi if plan.roi is not None else (0, m)
    cols = set(range(m - h, m)) | set(range(last - h, last))
    if first > 0:
        cols |= set(range(first, first + h))
    return tuple(sorted(c for c in cols if first <= c < last))


def _runs(cols):
    """Contiguous runs (start, length) of a sorted column tuple."""
    runs = []
    for c in cols:
        if runs and runs[-1][0] + runs[-1][1] == c:
            runs[-1][1] += 1
        else:
            runs.append([c, 1])
    return [tuple(r) for r in runs]


def _exact_columns(plan: Plan, dt, c0_re, c0_im, fine_re, fine_im, dmf_re,
                   dmf_im, cols):
    """Guarded, ROI-masked spectra at the static bins ``cols``:
    (nt*K, len(cols)) re and im, by the per-column form of the algebra in the
    module docstring (cumsum over K per needed column — O(M * len) work)."""
    m = plan.dftsize
    h = WINDOW_HALO[plan.window]
    taps = _taps(plan)

    def src(j):  # Hermitian guards: (source bin, conjugate?)
        if j < 0:
            return -j, True
        if j >= m:
            return 2 * (m - 1) - j, True
        return j, False

    need = sorted({src(c + g)[0] for c in cols for g in range(-h, h + 1)})
    pos = {s: n for n, s in enumerate(need)}
    sel = np.asarray(need)
    f_re, f_im = fine_re[:, sel], fine_im[:, sel]            # (K, S)
    d_re, d_im = dmf_re[:, sel], dmf_im[:, sel]
    u_re = c0_re[:, None, sel] + jnp.cumsum(dt[:, :, None] * f_re, axis=1)
    u_im = c0_im[:, None, sel] + jnp.cumsum(dt[:, :, None] * f_im, axis=1)
    a_re = u_re * d_re - u_im * d_im                         # (nt, K, S)
    a_im = u_re * d_im + u_im * d_re

    outs_re, outs_im = [], []
    for c in cols:
        o_re = o_im = 0.0
        for g in range(-h, h + 1):
            s, conj = src(c + g)
            tap = np.float32(taps[abs(g)])
            o_re = o_re + tap * a_re[..., pos[s]]
            o_im = o_im + (-tap if conj else tap) * a_im[..., pos[s]]
        outs_re.append(o_re)
        outs_im.append(o_im)
    nt, K = dt.shape
    return (jnp.stack(outs_re, -1).reshape(nt * K, len(cols)),
            jnp.stack(outs_im, -1).reshape(nt * K, len(cols)))


def _toeplitz(dt, w):
    """Per-tile lower-triangular Toep_w[t*K + k, j] = delta[t*K + k - j] * w[j]
    (j <= k), by broadcast and reshape alone (no gathers): with
    v = [d0, 0...0, d_{K-1}..d_1] (length 2K) per tile, the row-major reshape
    of K copies of v to width 2K-1 shifts row k by k.  Returned as the masked
    bf16 hi/lo split (a convert round trip would be folded away by XLA)."""
    nt, K = dt.shape
    v = jnp.concatenate([dt[:, :1], jnp.zeros((nt, K), dt.dtype),
                         dt[:, :0:-1]], axis=1)
    rolled = jnp.broadcast_to(v[:, None, :], (nt, K, 2 * K))
    rolled = rolled.reshape(nt, K * 2 * K)[:, :K * (2 * K - 1)]
    toep = rolled.reshape(nt, K, 2 * K - 1)[:, :, :K].reshape(nt * K, K)
    return _split_mask(toep * w[None, :])


def _spectra_kernel(c0_ref, thi_ref, tlo_ref, bhr_ref, blr_ref, bhi_ref,
                    bli_ref, dr_ref, di_ref, *out_refs, m: int, M: int,
                    K: int, R: int, BN: int, taps, halo: int, roi,
                    mode: str):
    """One program: R sub-tiles of K rows by BN bins of the spectra."""
    t = pl.program_id(0)
    b = pl.program_id(1)
    col0 = b * BN
    bs = pl.ds(pl.multiple_of(col0, BN), BN)
    cols = col0 + jnp.arange(BN, dtype=jnp.int32)
    colmask = cols < m
    if roi is not None:
        colmask = colmask & (cols >= roi[0]) & (cols < roi[1])

    b_hr, b_lr = bhr_ref[:, bs], blr_ref[:, bs]
    b_hi, b_li = bhi_ref[:, bs], bli_ref[:, bs]
    d_re, d_im = dr_ref[:, bs], di_ref[:, bs]
    k1 = (jnp.arange(K, dtype=jnp.int32) + 1).astype(jnp.float32)

    for r in range(R):
        tile = t * R + r
        rows = pl.ds(pl.multiple_of(tile * K, K), K)
        a_hi, a_lo = thi_ref[rows, :], tlo_ref[rows, :]
        p_re = (pl.dot(a_hi, b_hr) + pl.dot(a_hi, b_lr)) + pl.dot(a_lo, b_hr)
        p_im = (pl.dot(a_hi, b_hi) + pl.dot(a_hi, b_li)) + pl.dot(a_lo, b_hi)

        def c0(part, g):
            return c0_ref[2 * tile + part, pl.ds(col0 + C0_PAD + g, BN)]

        x_re = taps[0] * c0(0, 0)[None, :]
        x_im = taps[0] * c0(1, 0)[None, :]
        for g in range(1, halo + 1):
            th = np.float32(np.pi * g / m) * k1
            cs, sn = jnp.cos(th)[:, None], jnp.sin(th)[:, None]
            pr, pi_, mr, mi = c0(0, g), c0(1, g), c0(0, -g), c0(1, -g)
            x_re = x_re + taps[g] * (cs * (pr + mr)[None, :]
                                     - sn * (pi_ - mi)[None, :])
            x_im = x_im + taps[g] * (cs * (pi_ + mi)[None, :]
                                     + sn * (pr - mr)[None, :])
        o_re = p_re + (d_re * x_re - d_im * x_im)
        o_im = p_im + (d_re * x_im + d_im * x_re)

        rowmask = tile * K + jnp.arange(K, dtype=jnp.int32) < M
        mask = rowmask[:, None] & colmask[None, :]
        if roi is not None:
            o_re = jnp.where(colmask[None, :], o_re, 0.0)
            o_im = jnp.where(colmask[None, :], o_im, 0.0)
            mask = rowmask[:, None] & (cols < m)[None, :]
        if mode == "power":
            (out,) = out_refs
            plgpu.store(out.at[rows, bs], (o_re * o_re + o_im * o_im
                                           ).astype(out.dtype), mask=mask)
        elif mode == "planar":
            o1, o2 = out_refs
            plgpu.store(o1.at[rows, bs], o_re.astype(o1.dtype), mask=mask)
            plgpu.store(o2.at[rows, bs], o_im.astype(o2.dtype), mask=mask)
        else:
            (out,) = out_refs      # int32 indices, also under x64
            plgpu.store(out.at[rows, bs, np.int32(0)],
                        o_re.astype(out.dtype), mask=mask)
            plgpu.store(out.at[rows, bs, np.int32(1)],
                        o_im.astype(out.dtype), mask=mask)


@functools.partial(jax.jit, static_argnums=(0, 3, 4, 5, 6))
def _launch(plan: Plan, state: State, samples, mode: str, out_dtype,
            interpret: bool, config: KernelConfig):
    m = plan.dftsize
    n2 = 2 * m
    K, BN, R = config.tile_k, config.block_n, config.super_r
    halo = WINDOW_HALO[plan.window]
    (M,) = samples.shape
    nt = -(-M // K)
    ntp = _round_up(nt, R)                    # whole programs of R tiles
    Wt = _round_up(m, BN)
    (fine_re, fine_im, dmf_re, dmf_im, bhr, blr, bhi, bli,
     w) = _tables(plan, K, BN)
    hiP = jax.lax.Precision.HIGHEST

    # comb stage and the next delayline
    samples = samples.astype(jnp.float32)
    line = jnp.concatenate([state.delayline.astype(jnp.float32), samples])
    delta = samples - line[:M]
    new_delayline = line[M:].astype(plan.precision.td_dtype)
    dt = jnp.pad(delta, (0, ntp * K - M)).reshape(ntp, K)

    # per-tile totals, rotated into the global frame, exclusive prefix
    s_re = jnp.dot(dt, fine_re, precision=hiP)
    s_im = jnp.dot(dt, fine_im, precision=hiP)
    row_re, row_im = _phase_rows(state.offset.reshape(1), ntp, K, m,
                                 jnp.float32)
    row_re, row_im = row_re[0], row_im[0]
    rt_re = row_re * s_re - row_im * s_im
    rt_im = row_re * s_im + row_im * s_re
    inc_re = jnp.cumsum(rt_re, axis=0)
    inc_im = jnp.cumsum(rt_im, axis=0)
    acc = state.accumulator.astype(jnp.float32)
    pre_re = acc[:, 0] + jnp.concatenate(
        [jnp.zeros_like(inc_re[:1]), inc_re[:-1]], axis=0)
    pre_im = acc[:, 1] + jnp.concatenate(
        [jnp.zeros_like(inc_im[:1]), inc_im[:-1]], axis=0)
    c0_re = pre_re * row_re + pre_im * row_im           # prefix * conj(row0)
    c0_im = pre_im * row_re - pre_re * row_im
    acc_out = jnp.stack([acc[:, 0] + inc_re[-1], acc[:, 1] + inc_im[-1]],
                        axis=-1)

    # c0 rows for the kernel's stencil: C0_PAD columns each side, the DC
    # side holding the Hermitian mirror conj(c0[g]) (real input makes the
    # natural axis conjugate-symmetric there), the top side zeros (the top
    # bins are rewritten by the exact columns)
    right = Wt + C0_PAD - m

    def padded(a, sign):
        mirror = sign * a[:, C0_PAD:0:-1]
        return jnp.concatenate(
            [mirror, a, jnp.zeros((ntp, right), a.dtype)], axis=1)

    c0_rows = jnp.stack([padded(c0_re, 1.0), padded(c0_im, -1.0)],
                        axis=1).reshape(2 * ntp, Wt + 2 * C0_PAD)
    thi, tlo = _toeplitz(dt, w)

    odt = jnp.dtype(out_dtype) if out_dtype else jnp.float32
    if mode == "packed":
        out_shape = (jax.ShapeDtypeStruct((M, m, 2), odt),)
    elif mode == "planar":
        out_shape = (jax.ShapeDtypeStruct((M, m), odt),) * 2
    else:
        out_shape = (jax.ShapeDtypeStruct((M, m), odt),)
    kernel = functools.partial(
        _spectra_kernel, m=m, M=M, K=K, R=R, BN=BN, taps=_taps(plan),
        halo=halo, roi=plan.roi, mode=mode)
    outs = pl.pallas_call(
        kernel,
        grid=(ntp // R, Wt // BN),
        out_shape=out_shape,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="sdft_spectra",
    )(c0_rows, thi, tlo, bhr, blr, bhi, bli, dmf_re, dmf_im)

    cols = fix_columns(plan)
    if cols:
        f_re, f_im = _exact_columns(plan, dt, c0_re, c0_im, fine_re, fine_im,
                                    dmf_re, dmf_im, cols)
        f_re, f_im = f_re[:M], f_im[:M]
        if mode == "power":
            fixes = (f_re * f_re + f_im * f_im,)
        elif mode == "planar":
            fixes = (f_re, f_im)
        else:
            fixes = (jnp.stack([f_re, f_im], axis=-1),)
        outs = list(outs)
        for n, fix in enumerate(fixes):
            c = 0                       # fix column of the run's first bin
            for start, length in _runs(cols):
                idx = (0, start) + (0,) * (fix.ndim - 2)
                outs[n] = jax.lax.dynamic_update_slice(
                    outs[n], fix[:, c:c + length].astype(odt), idx)
                c += length

    new_state = State(
        offset=jnp.mod(state.offset + M, n2).astype(state.offset.dtype),
        delayline=new_delayline,
        accumulator=acc_out.astype(state.accumulator.dtype),
    )
    if mode == "planar":
        return new_state, tuple(outs)
    return new_state, outs[0]


def forward_block_pallas(plan: Plan, state: State, samples, interpret=False,
                         layout="packed", out_dtype=None,
                         config: KernelConfig | None = None):
    """Per-sample spectra of one block through the kernel.

    Returns (state, dfts) with dfts packed (M, m, 2), or with
    ``layout="planar"`` a (re, im) pair of (M, m) arrays.
    ``out_dtype="bfloat16"`` (planar only) halves the spectra write; the
    sums stay f32 and only the emitted planes round."""
    if layout not in ("packed", "planar"):
        raise ValueError(f"layout must be 'packed' or 'planar', got {layout!r}")
    if out_dtype and jnp.dtype(out_dtype) != jnp.float32 \
            and layout != "planar":
        raise ValueError("non-f32 spectra require layout='planar' (packing "
                         "would re-read the spectra)")
    _check(plan, samples.shape[-1], "api.sdft")
    return _launch(plan, state, samples, layout, out_dtype, interpret,
                   config or DEFAULT_CONFIG)


def forward_block_power(plan: Plan, state: State, samples, interpret=False,
                        out_dtype=None, config: KernelConfig | None = None):
    """The power spectrum |dft|^2 per sample through the kernel: one (M, m)
    plane instead of the (re, im) pair, squared at the store."""
    _check(plan, samples.shape[-1], "api.sdft_power")
    return _launch(plan, state, samples, "power", out_dtype, interpret,
                   config or DEFAULT_CONFIG)
