"""Exact twiddle/phasor construction from integer exponents.

The analysis twiddle for bin i is T_i = exp(-2*pi*j * i / (2m))
(reference: c/src/sdft/sdft.h:439,444; python/src/sdft/sdft.py:54).  Every
phasor the algorithm ever needs is an integer power T_i^e, i.e. a (2m)-th
root of unity.  We therefore compute the exponent product ``(e * i) mod 2m``
in integer arithmetic — exact for any stream position — and take cos/sin of
the reduced angle.  This combines reference C's periodic phase reset
(c/src/sdft/sdft.h:566-576, exactness every 2m samples) with reference
Python's block vectorization (sdft.py:103-106) while beating both: there is
no drift *within* the period either.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..plan import Plan


#: Largest dftsize whose exact mod-2m phase products stay int32-safe via the
#: two-level split in ``mulmod`` ((2m-1) * S <= 2^31 - 1 with S ~ sqrt(2m)).
MAX_INT32_DFTSIZE = 1 << 19


def exponent_dtype(m: int):
    """Integer dtype for the exact phase products ``(e * i) mod 2m``.

    ``mulmod`` keeps the products exact in int32 for any m up to 2^19
    (524288 bins): one direct product while (2m-1)*(2m-1) < 2^31, else a
    two-level split (the reference allocates any dftsize,
    c/src/sdft/sdft.h:413-450 — the f32 fast path follows).  Beyond that,
    promote to int64, which requires the x64 (f64 parity) mode.
    """
    if m <= MAX_INT32_DFTSIZE:
        return jnp.int32
    if not jax.config.jax_enable_x64:
        raise ValueError(
            f"dftsize {m} needs int64 exact-phase arithmetic; enable "
            "jax_enable_x64 (the f64 parity mode) for plans above "
            f"{MAX_INT32_DFTSIZE} bins")
    return jnp.int64


def mulmod(e, i, n2: int):
    """Exact ``(e * i) mod n2`` without integer overflow.

    ``e`` must be reduced mod n2 already; ``i`` is any (possibly negative)
    integer array — it is reduced here.  While (n2-1)^2 < 2^31 a single
    int32 product is exact; above that the split i = a*S + b (S ~ sqrt(n2))
    gives

        (e*i) mod n2 = (((e*S mod n2) * a) mod n2 + (e*b) mod n2) mod n2

    with every product bounded by (n2-1)*S <= 2^31 - 1 — int32-exact for
    n2 up to 2^20 (m = MAX_INT32_DFTSIZE).  int64 inputs take the direct
    product unconditionally.
    """
    e = jnp.asarray(e)
    i = jnp.asarray(i).astype(e.dtype)
    i = jnp.mod(i, n2)
    if e.dtype == jnp.int64 or (n2 - 1) * (n2 - 1) < 2 ** 31:
        return jnp.mod(e * i, n2)
    S = 1 << ((int(n2).bit_length() + 1) // 2)
    if (n2 - 1) * S > 2 ** 31 - 1:
        raise ValueError(f"modulus {n2} too large for int32 two-level split")
    a = i // S
    b = i - a * S
    eS = jnp.mod(e * S, n2)
    return jnp.mod(jnp.mod(eS * a, n2) + jnp.mod(e * b, n2), n2)


def fiddle_rows(plan: Plan, exponents: jnp.ndarray, conj: bool = False,
                bins: jnp.ndarray | None = None) -> jnp.ndarray:
    """Phasor matrix P[k, i] = T_i ** exponents[k] (optionally conjugated).

    Args:
      plan: static SDFT plan.
      exponents: (M,) int32 exponents; any sign/magnitude (reduced mod 2m).
      conj: if True, return conj(P) == T_i ** -e.
      bins: optional (B,) int32 bin indices (for bin-sharded execution);
        defaults to arange(m).

    Returns:
      (M, B) complex array in plan FD precision.
    """
    m = plan.dftsize
    n2 = 2 * m
    dt = exponent_dtype(m)
    if bins is None:
        bins = jnp.arange(m, dtype=jnp.int32)
    e = jnp.mod(exponents.astype(dt), n2)
    # exact for any supported m: mulmod reduces and (if needed) splits the
    # product so it never overflows the exponent dtype
    r = mulmod(e[:, None], bins[None, :], n2)
    sign = 1.0 if conj else -1.0
    omega = sign * np.pi / m  # conj flips exp(-j..) -> exp(+j..)
    angle = (omega * r).astype(plan.precision.fd_dtype)
    return jnp.cos(angle) + 1j * jnp.sin(angle)


def fiddle_block(plan: Plan, offset: jnp.ndarray, M: int,
                 bins: jnp.ndarray | None = None, split: int = 128):
    """Phasor matrix P[k, i] = T_i ** (offset + k) for k in [0, M) — the
    per-block rotation table — plus the constant demodulation row conj(T_i).

    Equivalent to ``fiddle_rows(plan, offset + arange(M))`` but with ~M/split
    times fewer transcendentals: writing k = a*split + b,

        T_i^(offset+k) = T_i^offset * T_i^(a*split) * T_i^b

    so only three small tables (1, M/split and split rows) are evaluated with
    cos/sin — each exact via integer exponents mod 2m — and the full matrix
    is assembled with two complex multiplies per element (unit-modulus
    products: ~1 ulp each).  This moves the hot loop off the elementwise units
    transcendental unit.

    Returns:
      (P, conj_base) where P is (M, B) complex and conj_base is (B,) complex
      with conj_base[i] = conj(T_i); the demodulator for row k is
      conj(P[k]) * conj_base (since demod exponent is offset+k+1).
    """
    m = plan.dftsize
    if bins is None:
        bins = jnp.arange(m, dtype=jnp.int32)
    K = min(split, M)
    A = -(-M // K)  # ceil
    # Exact small tables (integer exponents mod 2m, then cos/sin).
    row0 = fiddle_rows(plan, offset[None], bins=bins)         # (1, B) traced offset
    coarse = fiddle_rows(plan, jnp.arange(A, dtype=jnp.int32) * K, bins=bins)  # (A, B)
    fine = fiddle_rows(plan, jnp.arange(K, dtype=jnp.int32), bins=bins)        # (K, B)
    P = (row0[None, :, :] * coarse[:, None, :]) * fine[None, :, :]
    P = P.reshape(A * K, -1)[:M]
    conj_base = fiddle_rows(plan, jnp.ones((1,), jnp.int32), conj=True,
                            bins=bins)[0]
    return P, conj_base


def synthesis_twiddles(plan: Plan) -> jnp.ndarray:
    """Per-bin inverse-synthesis phasors including amplitude demodulation.

    For latency == 1 this is the alternating-sign vector (-1)^i — a circular
    half-window time shift (c/src/sdft/sdft.h:639-645; sdft.py:57-60).  For
    latency < 1: polar(w, omega*i*m*latency) with w = 2/(1-cos(omega*m*latency))
    (c/src/sdft/sdft.h:440,445; sdft.py:55,62-65).

    Returns (m,) complex in FD precision (real-valued content when latency==1).
    """
    m = plan.dftsize
    fd = plan.precision.fd_dtype
    i = jnp.arange(m, dtype=jnp.int32)
    if plan.latency == 1.0:
        tw = jnp.where(i % 2 == 0, 1.0, -1.0).astype(fd)
        tw = tw.astype(plan.precision.fdx_dtype)
    else:
        angle = (-np.pi * plan.latency * i).astype(fd)
        w = jnp.asarray(2.0 / (1.0 - np.cos(np.pi * plan.latency)), fd)
        tw = w * (jnp.cos(angle) + 1j * jnp.sin(angle))
    if plan.roi is not None:
        # Synthesis reduces over ROI bins only (synthesis.roi,
        # c/src/sdft/sdft.h:639-653).
        first, last = plan.roi
        tw = tw * ((i >= first) & (i < last)).astype(fd)
    return tw
