"""Forward SDFT analysis as a blockwise scan.

The reference per-sample recursion (c/src/sdft/sdft.h:562-598) is

    delta   = x[t] - x[t-2m]                       (comb / delay stage)
    acc[i] += T_i^(t mod 2m) * delta               (modulated accumulation)
    aux[i]  = acc[i] * conj(T_i^((t+1) mod 2m))    (demodulation)
    dft     = window_convolve(hermitian_pad(aux))  (frequency-domain window)

with T_i = exp(-2*pi*j*i/(2m)).  Because the accumulator is a *plain running
sum* of exactly-rotated deltas (Duda's modulated SDFT — the stability
property, README.md:20), a block of M samples becomes:

    rot[k, i] = delta[k] * T_i^((offset+k) mod 2m)     outer product
    acc[k, i] = carry + inclusive-cumsum_k(rot)        associative scan
    aux[k, i] = acc[k, i] * conj(T_i^((offset+k+1) mod 2m))

which is the data-parallel form: one O(M*m) elementwise stage, one prefix sum
along time, one elementwise demodulation — all fusible, shardable along both
time (scan carry = m complex numbers) and bins (independent except the
window's 1-2 bin halo).  This mirrors reference Python's vectorization
(python/src/sdft/sdft.py:76-120) but with exact mod-2m integer phases, so
there is no drift for endless streams (see sdft_tpu.ops.twiddle).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax

from ..cplx import pack, unpack
from ..plan import Plan
from ..state import State
from .convolve import window_convolve
from .twiddle import fiddle_block


def sdft_block(plan: Plan, state: State, samples: jnp.ndarray):
    """Process one block of samples for a single channel.

    Args:
      plan: static SDFT plan.
      state: carry state (unbatched: offset (), delayline (2m,), packed
        accumulator (m, 2)).
      samples: (M,) real time-domain samples.

    Returns:
      (new_state, dfts) with dfts of shape (M, m, 2) packed complex — one
      spectrum per input sample, matching sdft_sdft_n
      (c/src/sdft/sdft.h:607-613).  Packed layout per sdft_tpu.cplx.
    """
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    (M,) = samples.shape

    samples = samples.astype(td)
    # Comb stage: delta[k] = x[k] - x[k-2m], served by the delayline.  The
    # subtraction happens in TD precision, then feeds FD math, exactly as the
    # reference (c/src/sdft/sdft.h:564).
    line = jnp.concatenate([state.delayline, samples], axis=-1)
    delta = (samples - line[:M]).astype(fd)
    new_delayline = line[M:]

    fid, conj_base = fiddle_block(plan, state.offset.astype(jnp.int32), M)

    rot = delta[:, None].astype(plan.precision.fdx_dtype) * fid
    if plan.roi is not None:
        # Bins outside the ROI are never accumulated (the reference's hot
        # loop runs roi.first..roi.second only, c/src/sdft/sdft.h:570).
        # Static mask: constant-folded by XLA.
        first, last = plan.roi
        mask = (np.arange(m) >= first) & (np.arange(m) < last)
        rot = rot * jnp.asarray(mask, rot.dtype)
    rot = rot.at[0, :].add(unpack(state.accumulator))
    acc = jnp.cumsum(rot, axis=0)
    new_accumulator = pack(acc[-1, :])

    # demod exponent is offset+k+1: conj(fid) * conj(T_i)
    aux = acc * (jnp.conj(fid) * conj_base[None, :])
    out = window_convolve(plan, aux)
    if plan.roi is not None:
        # The window conv also only writes ROI bins in the reference; spill
        # into the first bins past the ROI edge reads as zero.
        out = out * jnp.asarray(mask, out.dtype)
    dfts = pack(out)

    new_state = State(
        offset=jnp.mod(state.offset + M, n2).astype(state.offset.dtype),
        delayline=new_delayline,
        accumulator=new_accumulator,
    )
    return new_state, dfts


def refresh_state(plan: Plan, state: State) -> State:
    """Exactly rebuild the accumulator from the delayline, discarding every
    rounding error the running sum has ever absorbed.

    Telescoping the comb stage (delta[s] = x[s] - x[s-2m]) against the
    2m-periodic phasors gives, in exact arithmetic,

        acc(t)[i] = sum_{s=t-2m}^{t-1} x[s] * T_i^(s mod 2m)
                  = sum_j delayline[j] * T_i^((offset + j) mod 2m)

    i.e. the accumulator is a pure function of the carry's other two fields.
    In floating point the running sum instead random-walks: contributions
    older than the window cancel only to roundoff, so after B blocks the
    accumulator carries O(sqrt(B) * eps) of dead error.  Recomputing it with
    exact integer-exponent phasors (sdft_tpu.ops.twiddle) resets that error
    to a single windowed-sum rounding — the block-parallel generalization of the
    reference's periodic phase reset (c/src/sdft/sdft.h:566-576) from the
    phasor to the accumulator itself, making f32 endless streams drift-free
    (SURVEY.md §7 hard part (b)).

    Cost: one (2m,) x (2m, m) matvec — run every `refresh_every` blocks
    (see stream.Streamer); the refreshed state is a drop-in continuation.
    """
    m = plan.dftsize
    P, _ = fiddle_block(plan, state.offset.astype(jnp.int32), 2 * m)
    d = state.delayline.astype(plan.precision.fd_dtype)
    # real input x complex phasors = two real matvecs
    acc_re = jnp.matmul(d, jnp.real(P), precision=lax.Precision.HIGHEST)
    acc_im = jnp.matmul(d, jnp.imag(P), precision=lax.Precision.HIGHEST)
    acc = jnp.stack([acc_re, acc_im], axis=-1)
    if plan.roi is not None:
        first, last = plan.roi
        mask = (np.arange(m) >= first) & (np.arange(m) < last)
        acc = acc * jnp.asarray(mask, acc.dtype)[:, None]
    return State(
        offset=state.offset,
        delayline=state.delayline,
        accumulator=acc.astype(state.accumulator.dtype),
    )
