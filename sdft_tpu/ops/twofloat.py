"""Double-word (two-float32) extended-precision analysis tier.

The reference keeps a third FD precision tier above double (`long double`,
c/src/sdft/sdft.h:21-37,101-125).  This module reaches the f64 accuracy
class from float32 arithmetic alone (first written for an accelerator with
no float64 unit) with double-word arithmetic: every value is an unevaluated sum hi + lo of two
float32s (Dekker/Knuth error-free transformations), giving ~2^-48 relative
precision through the whole rotate -> cumsum -> demodulate -> window-conv
pipeline.  Products are made exact by masked 12-bit mantissa splits;
sums by TwoSum.  Only adds/subs/muls are used — XLA does not reassociate
float arithmetic, and the splits are BITMASKS, not convert round trips
(which XLA folds to identity under excess precision — ops.lti._split_mask).

The carry is NOT taken from ``state.accumulator`` (a plain f32, which
would cap accuracy at ~6e-8): by the refresh identity
(ops.analysis.refresh_state)

    acc[i] = sum_j delayline[j] * T_i^((offset + j) mod 2m)

the accumulator is a pure function of the exactly-carried delayline, so
every block REBUILDS it in double-word — streams of any length are
drift-free by construction, with no change to the State pytree.

This is the matmul-free accuracy tier: the per-element cost is ~20x a
plain f32 op and nothing rides a matrix unit — any f32 contraction rounds
its accumulation at ~sqrt(K)*2^-24 per tile, which is why the fast LTI
paths cannot reach this class.  Select it with ``Precision(fd="float32x2")``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..plan import Plan
from ..state import State
from ..windows import WINDOW_HALO, WINDOW_TAPS, Window
from .twiddle import exponent_dtype, mulmod

# ---------------------------------------------------------------------------
# double-word primitives (each value is a (hi, lo) pair of same-shape f32)

_MASK12 = np.uint32(0xFFFFF000)   # keep sign+exp+11 explicit mantissa bits


def _split(a):
    """a = hi + lo with <= 12 significant mantissa bits each (exact).

    Bitmask split, not Veltkamp multiply: immune to XLA convert folding
    and to overflow of the 4097*a scaling."""
    hi = lax.bitcast_convert_type(
        lax.bitcast_convert_type(a, jnp.uint32) & _MASK12, jnp.float32)
    return hi, a - hi


def two_sum(a, b):
    """s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    """Renormalize: requires |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """p + e == a * b exactly (via 12-bit splits; no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(x, y):
    """(hi, lo) + (hi, lo), error O(eps^2)."""
    s, e = two_sum(x[0], y[0])
    return fast_two_sum(s, e + (x[1] + y[1]))


def df_neg(x):
    return -x[0], -x[1]


def df_mul(x, y):
    """(hi, lo) * (hi, lo), error O(eps^2)."""
    p, e = two_prod(x[0], y[0])
    return fast_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def df_const(v, shape=()):
    """Host float (f64) as a broadcastable df pair."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    return (jnp.full(shape, hi, jnp.float32) if shape else jnp.float32(hi),
            jnp.full(shape, lo, jnp.float32) if shape else jnp.float32(lo))


def df_to_float64(x):
    """Host-side: collapse a df pair to float64 (x64 required)."""
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


# complex df values are ((re_hi, re_lo), (im_hi, im_lo)) pairs

def cdf_mul(a, b):
    (ar, ai), (br, bi) = a, b
    re = df_add(df_mul(ar, br), df_neg(df_mul(ai, bi)))
    im = df_add(df_mul(ar, bi), df_mul(ai, br))
    return re, im


def cdf_add(a, b):
    return df_add(a[0], b[0]), df_add(a[1], b[1])


# ---------------------------------------------------------------------------
# phase tables: T_i^r = exp(-j*pi*r/m) at every integer r in [0, 2m),
# split hi/lo from the f64 evaluation (the f64 table value itself is
# within 1 ulp(f64) of the true phasor — the accuracy floor of this tier)

@functools.lru_cache(maxsize=None)
def _phase_tables(plan: Plan):
    m = plan.dftsize
    ang = (-np.pi / m) * np.arange(2 * m, dtype=np.float64)
    out = []
    for v in (np.cos(ang), np.sin(ang)):
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        out += [hi, lo]
    with jax.ensure_compile_time_eval():
        return tuple(jnp.asarray(a) for a in out)


def _gather_phasor(plan: Plan, tables, exps):
    """Complex df phasor at integer exponent array ``exps`` (mod 2m)."""
    ch, cl, sh, sl = tables
    return (ch[exps], cl[exps]), (sh[exps], sl[exps])


# ---------------------------------------------------------------------------
# core pipeline

def _rotate(plan: Plan, tables, values_df, e_rows, bins, roi_mask):
    """rot[k, i] = values[k] * T_i^e_rows[k]  as complex df (planes (K, B))."""
    n2 = 2 * plan.dftsize
    dt = exponent_dtype(plan.dftsize)
    r = mulmod(jnp.mod(e_rows.astype(dt), n2)[:, None],
               bins.astype(dt)[None, :], n2)
    (cr, ci) = _gather_phasor(plan, tables, r)
    vh, vl = values_df
    v = (vh[:, None], vl[:, None])
    re = df_mul(v, cr)
    im = df_mul(v, ci)
    if roi_mask is not None:
        re = (re[0] * roi_mask, re[1] * roi_mask)
        im = (im[0] * roi_mask, im[1] * roi_mask)
    return re, im


def _df_cumsum(re, im):
    """Inclusive cumsum along axis 0 of complex df planes (associative_scan
    with the df_add combiner: O(eps^2) per combine)."""
    def comb_t(a, b):
        r = df_add((a[0], a[1]), (b[0], b[1]))
        i = df_add((a[2], a[3]), (b[2], b[3]))
        return (r[0], r[1], i[0], i[1])

    out = lax.associative_scan(comb_t, (re[0], re[1], im[0], im[1]), axis=0)
    return (out[0], out[1]), (out[2], out[3])


def _carry_from_delayline(plan: Plan, tables, delayline, offset, bins,
                          roi_mask):
    """acc[i] = sum_j dl[j] * T_i^(offset + j) in double-word (the refresh
    identity, ops.analysis.refresh_state) — chunked sequential scan to
    bound memory at (chunk, B) planes."""
    n2 = 2 * plan.dftsize
    (N,) = delayline.shape
    B = bins.shape[0]
    chunk = min(N, 512)
    nch = -(-N // chunk)
    dl = jnp.pad(delayline.astype(jnp.float32), (0, nch * chunk - N))
    dl = dl.reshape(nch, chunk)
    zero = jnp.zeros((B,), jnp.float32)

    def body(carry, inp):
        c, x = inp
        e = offset + c * chunk + jnp.arange(chunk, dtype=jnp.int32)
        re, im = _rotate(plan, tables, (x, jnp.zeros_like(x)), e, bins,
                         roi_mask)
        # tree-reduce the (chunk, B) planes over chunk (the shared
        # pairwise reduction, _df_sum_last) then df_add into the carry
        cre, cim = carry
        cre = df_add(cre, _df_sum_last((re[0].T, re[1].T)))
        cim = df_add(cim, _df_sum_last((im[0].T, im[1].T)))
        return (cre, cim), None

    carry0 = (((zero, zero)), (zero, zero))
    (acc_re, acc_im), _ = lax.scan(
        body, carry0, (jnp.arange(nch, dtype=jnp.int32), dl))
    return acc_re, acc_im


def _window_convolve_df(plan: Plan, aux, roi_mask):
    """Window bin convolution + analysis weight on complex df planes, with
    Hermitian mirror guards (ops.convolve semantics)."""
    halo = WINDOW_HALO[plan.window]
    w = df_const(plan.analysis_weight)
    (ar, ai) = aux
    if plan.window is Window.BOXCAR:
        out = (df_mul(ar, w), df_mul(ai, w))
    else:
        c0, c1, c2 = WINDOW_TAPS[plan.window]

        def pad(p, conj_sign):
            h, l = p
            left = (conj_sign * h[..., 1:halo + 1][..., ::-1],
                    conj_sign * l[..., 1:halo + 1][..., ::-1])
            right = (conj_sign * h[..., -halo - 1:-1][..., ::-1],
                     conj_sign * l[..., -halo - 1:-1][..., ::-1])
            return (jnp.concatenate([left[0], h, right[0]], axis=-1),
                    jnp.concatenate([left[1], l, right[1]], axis=-1))

        pr = pad(ar, 1.0)
        pi = pad(ai, -1.0)                       # Hermitian: conj mirrors
        n = pr[0].shape[-1]

        def stencil(p):
            core = (p[0][..., halo:n - halo], p[1][..., halo:n - halo])
            out = df_mul(core, df_const(c0))
            s1 = df_add((p[0][..., halo - 1:n - halo - 1],
                         p[1][..., halo - 1:n - halo - 1]),
                        (p[0][..., halo + 1:n - halo + 1],
                         p[1][..., halo + 1:n - halo + 1]))
            out = df_add(out, df_mul(s1, df_const(c1)))
            if halo >= 2:
                s2 = df_add((p[0][..., halo - 2:n - halo - 2],
                             p[1][..., halo - 2:n - halo - 2]),
                            (p[0][..., halo + 2:n - halo + 2],
                             p[1][..., halo + 2:n - halo + 2]))
                out = df_add(out, df_mul(s2, df_const(c2)))
            return out

        out = (df_mul(stencil(pr), w), df_mul(stencil(pi), w))
    if roi_mask is not None:
        out = ((out[0][0] * roi_mask, out[0][1] * roi_mask),
               (out[1][0] * roi_mask, out[1][1] * roi_mask))
    return out


@functools.partial(jax.jit, static_argnums=0)
def _sdft_block_df_jit(plan: Plan, state: State, samples):
    m = plan.dftsize
    n2 = 2 * m
    (M,) = samples.shape
    bins = jnp.arange(m, dtype=jnp.int32)
    tables = _phase_tables(plan)
    roi_mask = None
    if plan.roi is not None:
        first, last = plan.roi
        roi_mask = jnp.asarray(
            (np.arange(m) >= first) & (np.arange(m) < last), jnp.float32)

    samples = samples.astype(jnp.float32)
    line = jnp.concatenate([state.delayline.astype(jnp.float32), samples])
    # comb delta as an EXACT df pair (the f32 subtraction alone rounds)
    d_hi, d_lo = two_sum(samples, -line[:M])
    new_delayline = line[M:]

    off = state.offset.astype(jnp.int32)
    # carry rebuilt in double-word from the delayline (refresh identity) —
    # state.accumulator (plain f32) is deliberately not read
    acc0_re, acc0_im = _carry_from_delayline(
        plan, tables, state.delayline, off, bins, roi_mask)

    e = off + jnp.arange(M, dtype=jnp.int32)
    rot_re, rot_im = _rotate(plan, tables, (d_hi, d_lo), e, bins, roi_mask)
    # df_add the carry into row 0 (a plain hi+hi add would round at the
    # f32 class and break the double-word invariant)
    r0 = df_add((rot_re[0][0], rot_re[1][0]), acc0_re)
    i0 = df_add((rot_im[0][0], rot_im[1][0]), acc0_im)
    rot_re = (rot_re[0].at[0].set(r0[0]), rot_re[1].at[0].set(r0[1]))
    rot_im = (rot_im[0].at[0].set(i0[0]), rot_im[1].at[0].set(i0[1]))
    acc_re, acc_im = _df_cumsum(rot_re, rot_im)

    # demodulate by T_i^-(offset+k+1)
    dt = exponent_dtype(m)
    r = mulmod(jnp.mod(-(e + 1).astype(dt), n2)[:, None],
               bins.astype(dt)[None, :], n2)
    dr, di = _gather_phasor(plan, tables, r)
    aux = cdf_mul((acc_re, acc_im), (dr, di))

    (or_, oi) = _window_convolve_df(plan, aux, roi_mask)

    new_state = State(
        offset=jnp.mod(state.offset + M, n2).astype(state.offset.dtype),
        delayline=new_delayline.astype(state.delayline.dtype),
        accumulator=jnp.stack(
            [acc_re[0][-1] + acc_re[1][-1],
             acc_im[0][-1] + acc_im[1][-1]], axis=-1
        ).astype(state.accumulator.dtype),
    )
    # packed (M, m, 2(re,im), 2(hi,lo))
    dfts = jnp.stack([jnp.stack([or_[0], or_[1]], axis=-1),
                      jnp.stack([oi[0], oi[1]], axis=-1)], axis=-2)
    return new_state, dfts


@functools.lru_cache(maxsize=None)
def _synthesis_tables_df(plan: Plan):
    """Synthesis twiddles as (re_hi, re_lo, im_hi, im_lo) split from the
    f64 host evaluation (c/src/sdft/sdft.h:440,445 constants; ROI folds
    into the table like ops.twiddle.synthesis_twiddles)."""
    m = plan.dftsize
    i = np.arange(m, dtype=np.float64)
    if plan.latency == 1.0:
        re = np.where(np.arange(m) % 2 == 0, 1.0, -1.0)
        im = np.zeros(m)
    else:
        ang = -np.pi * plan.latency * i
        w = 2.0 / (1.0 - np.cos(np.pi * plan.latency))
        re = w * np.cos(ang)
        im = w * np.sin(ang)
    if plan.roi is not None:
        first, last = plan.roi
        mask = (np.arange(m) >= first) & (np.arange(m) < last)
        re = re * mask
        im = im * mask
    out = []
    for v in (re, im):
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
        out += [hi, lo]
    with jax.ensure_compile_time_eval():
        return tuple(jnp.asarray(a) for a in out)


def _df_sum_last(p):
    """Pairwise tree-sum of a df pair along the LAST axis (error O(eps^2)
    per level — the compensated reduction of the m-term synthesis sum)."""
    h, l = p
    n = h.shape[-1]
    while n > 1:
        half = n // 2
        s = df_add((h[..., :half], l[..., :half]),
                   (h[..., half:2 * half], l[..., half:2 * half]))
        if n % 2:
            h = jnp.concatenate([s[0], h[..., 2 * half:]], axis=-1)
            l = jnp.concatenate([s[1], l[..., 2 * half:]], axis=-1)
            n = half + 1
        else:
            h, l = s
            n = half
    return h[..., 0], l[..., 0]


@functools.partial(jax.jit, static_argnums=0)
def _isdft_block_df_jit(plan: Plan, dfts):
    rh, rl, ih, il = _synthesis_tables_df(plan)
    dre = (dfts[..., 0, 0], dfts[..., 0, 1])
    dim = (dfts[..., 1, 0], dfts[..., 1, 1])
    # Re(dft * tw) = Re(dft)*Re(tw) - Im(dft)*Im(tw), all in double-word
    terms = df_add(df_mul(dre, (rh, rl)), df_neg(df_mul(dim, (ih, il))))
    s = _df_sum_last(terms)
    return df_mul(s, df_const(plan.synthesis_weight))


def isdft_block_df(plan: Plan, dfts):
    """Inverse synthesis in the double-word tier (the FD-precision leg of
    the reference's extended dtypes applies to isdft too,
    c/src/sdft/sdft.h:635-657): one sample per spectrum from the packed
    (hi, lo) dfts that sdft_block_df emits.

    Args:
      plan: static plan.
      dfts: (..., M, m, 2, 2) — trailing axes (re/im, hi/lo).

    Returns:
      (hi, lo) float32 pair of shape (..., M): an unevaluated sum
      reaching the f64 class (df_to_float64 recovers it; ``hi`` alone is
      the correctly-rounded float32 sample — a plain f32 reduction would
      carry ~sqrt(m)*2^-24 instead).
    """
    dfts = jnp.asarray(dfts)
    if dfts.ndim < 3 or dfts.shape[-2:] != (2, 2):
        raise ValueError(
            f"dfts must be (..., M, m, 2, 2) double-word packed, "
            f"got {dfts.shape}")
    return _isdft_block_df_jit(plan, dfts)


def sdft_block_df(plan: Plan, state: State, samples):
    """One block of forward analysis in the double-word tier.

    Returns (state, dfts) with dfts (M, m, 2, 2): packed complex where
    each component is an unevaluated (hi, lo) float32 pair summing to the
    ~2^-48-accurate value.  ``dfts[..., 0] + dfts[..., 1]`` in float64
    recovers the f64-class spectrum (df_to_float64).

    state is the ordinary State pytree; the carry is rebuilt from the
    delayline every block (see module docstring), so chained calls are
    drift-free for streams of any length.
    """
    samples = jnp.asarray(samples)
    if samples.ndim == 2:
        return jax.vmap(lambda st, x: _sdft_block_df_jit(plan, st, x)
                        )(state, samples)
    return _sdft_block_df_jit(plan, state, samples)
