"""Jitted, channel-batched public entry points.

The functional API is

    state, dfts = sdft(plan, state, samples)   # dfts packed (..., M, m, 2)
    samples     = isdft(plan, dfts)

where ``samples`` may be (M,) for one channel or (C, M) for a multi-channel
batch (reference mean-mixes to mono and has no batching — test/wav.h:69-84;
here channels vmap and shard for free).  ``plan`` is static: the first call
per (plan, shape) pair compiles, later calls hit the jit cache.

Spectra cross jit boundaries in the packed real layout (trailing axis 2 =
re/im; see sdft_tpu.cplx), which every backend can materialize and
transfer.  Use ``cplx.to_complex`` on host to get numpy
complex matrices, or the compat.SDFT class which does it for you.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import from_complex, pack, unpack
from .kernels import forward_block_pallas, use_kernel
from .ops.analysis import refresh_state, sdft_block
from .ops.lti import (roundtrip_block_lti, roundtrip_hopped_chain,
                      sdft_hopped as _sdft_hopped_1d)
from .ops.synthesis import isdft_block
from .plan import Plan
from .state import State


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _sdft_1d(plan: Plan, state: State, samples: jax.Array, layout: str,
             spectra_dtype: str | None):
    st, d = sdft_block(plan, state, samples)
    if layout != "planar":
        return st, d
    re, im = d[..., 0], d[..., 1]
    if spectra_dtype:
        re, im = re.astype(spectra_dtype), im.astype(spectra_dtype)
    return st, (re, im)


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _sdft_2d(plan: Plan, state: State, samples: jax.Array, layout: str,
             spectra_dtype: str | None):
    return jax.vmap(
        lambda st, x: _sdft_1d(plan, st, x, layout, spectra_dtype)
    )(state, samples)


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def _sdft_2d_pallas(plan: Plan, state: State, samples: jax.Array, layout: str,
                    spectra_dtype: str | None):
    return jax.vmap(
        lambda st, x: forward_block_pallas(plan, st, x, layout=layout,
                                           out_dtype=spectra_dtype)
    )(state, samples)


@functools.partial(jax.jit, static_argnums=0)
def _isdft(plan: Plan, dfts: jax.Array):
    return isdft_block(plan, dfts)


def sdft(plan: Plan, state: State, samples, layout: str = "packed",
         spectra_dtype: str | None = None) -> tuple[State, jax.Array]:
    """Forward analysis: estimate one spectrum per input sample.

    Args:
      plan: static plan.
      state: carry from ``init_state`` (batched iff samples are batched).
      samples: (M,) or (C, M) real samples.
      layout: "packed" (default) returns dfts with a trailing re/im axis of
        size 2; "planar" returns a (re, im) pair of real arrays, which
        spectrogram consumers read without de-interleaving (at m=4096 the
        spectra are ~32 kB per input sample, so their write is the
        dominant cost).  Use planar for magnitude/spectrogram pipelines.
      spectra_dtype: optional narrower element type for the emitted planes
        (planar only), e.g. "bfloat16" — halves the O(M*m) spectra write,
        the forward path's HBM roofline.  The scan itself stays in the
        plan's FD precision; only the output rounds.  Not for paths that
        re-synthesize (isdft) with parity requirements.

    Returns:
      (new_state, dfts) with dfts packed (M, m, 2) / (C, M, m, 2), or the
      planar pair of (M, m) / (C, M, m) arrays.
    """
    if layout not in ("packed", "planar"):
        raise ValueError(f"layout must be 'packed' or 'planar', got {layout!r}")
    if spectra_dtype and layout != "planar":
        raise ValueError("spectra_dtype requires layout='planar'")
    samples = jnp.asarray(samples)
    if plan.precision.extended:
        # double-word tier (Precision(fd="float32x2"), ops.twofloat):
        # f64-class spectra from f32 pairs on backends with no float64.
        # dfts gain a trailing (hi, lo) axis: (..., M, m, 2, 2).
        from .ops.twofloat import sdft_block_df

        if layout != "packed" or spectra_dtype:
            raise ValueError("the float32x2 extended tier emits packed "
                             "(hi, lo) spectra only")
        if samples.ndim not in (1, 2):
            raise ValueError(f"samples must be (M,) or (C, M), "
                             f"got {samples.shape}")
        return sdft_block_df(plan, state, samples)
    if samples.ndim == 1:
        if use_kernel(plan, samples.size):
            return forward_block_pallas(plan, state, samples, layout=layout,
                                        out_dtype=spectra_dtype)
        return _sdft_1d(plan, state, samples, layout, spectra_dtype)
    if samples.ndim == 2:
        if use_kernel(plan, samples.size):
            return _sdft_2d_pallas(plan, state, samples, layout, spectra_dtype)
        return _sdft_2d(plan, state, samples, layout, spectra_dtype)
    raise ValueError(f"samples must be (M,) or (C, M), got {samples.shape}")


@functools.partial(jax.jit, static_argnums=(0, 3))
def _roundtrip_transform(plan: Plan, state: State, samples, transform):
    if samples.ndim == 1:
        st, d = sdft_block(plan, state, samples)
    else:
        st, d = jax.vmap(lambda s, x: sdft_block(plan, s, x))(state, samples)
    z = transform(unpack(d))
    if z.shape != d.shape[:-1]:
        raise ValueError(
            f"transform must preserve the spectra shape {d.shape[:-1]}, "
            f"returned {z.shape}")
    return st, isdft_block(plan, pack(z))


def roundtrip(plan: Plan, state: State, samples, transform=None
              ) -> tuple[State, jax.Array]:
    """sdft -> [transform ->] isdft round trip of one block.

    Without a transform the chain is linear time-invariant and collapses to
    its LTI form (see sdft_tpu.ops.lti): three matrix products + a tiny carry
    scan, spectra never materialized — far cheaper than running ``sdft``
    then ``isdft``.  The returned state is identical to ``sdft``'s,
    so the two forms interleave freely on one stream.  Multi-channel batches
    fold into the matmul row dims (one GEMM, not C batched small ones —
    ops.lti.roundtrip_block_lti).

    With a transform — the reference's core spectral-processing pattern
    (python/src/sdft/sdft.py docs: analyze, modify the spectrum, resynthesize)
    — the chain is no longer LTI; the spectra are materialized, passed to
    ``transform`` as a complex (M, m) (or (C, M, m)) array *inside* the jit
    program (so XLA fuses elementwise transforms into the synthesis matvec),
    and synthesized.  ``transform`` must be a traceable pure function
    preserving the spectra shape; it is hashed by identity for the jit
    cache, so define it once rather than inline per call.

    Args:
      plan: static plan.
      state: carry (batched iff samples are batched).
      samples: (M,) or (C, M) real samples.
      transform: optional spectral map, complex (..., M, m) -> same shape.

    Returns:
      (new_state, y) with y (M,) or (C, M) synthesized samples.
    """
    samples = jnp.asarray(samples)
    if samples.ndim not in (1, 2):
        raise ValueError(f"samples must be (M,) or (C, M), got {samples.shape}")
    if transform is None:
        return roundtrip_block_lti(plan, state, samples)
    return _roundtrip_transform(plan, state, samples, transform)


def roundtrip_hopped(plan: Plan, state: State, blocks, hop: int,
                     refresh_every: int | None = 1,
                     k_tile: int | None = None
                     ) -> tuple[State, jax.Array, jax.Array]:
    """Chained driver-protocol segment: hop-dfts + synthesized samples for a
    stack of blocks in ONE compiled program (one dispatch, one fetch).

    The fast path for the reference's hop-chunked streaming usage
    (test/test.c:69-83).  See ops.lti.roundtrip_hopped_chain.  hop == 1
    runs the stepped fused XLA body (ops.lti._chain_fused_jit) on every
    backend.

    Args:
      plan: static plan.
      state: carry (unbatched for (nb, B) blocks, batched for (nb, C, B)).
      blocks: (nb, B) or (nb, C, B) stacked sample blocks, B a multiple of
        ``hop``.
      hop: hop size in samples.
      refresh_every: accumulator refresh cadence in blocks (None = off).
      k_tile: tile-length tuning knob — for hop < 8 it sets the multi-hop
        tile TARGET (default 8; sub = ceil(k_tile/hop) inner hops per
        tile); unused for hop >= 8 (tiles are the hop itself).

    Returns:
      (new_state, hop_dfts, ys): hop_dfts packed (nb, B//hop, m, 2)
      [(nb, C, B//hop, m, 2)], ys (nb, B) [(nb, C, B)].
    """
    blocks = jnp.asarray(blocks)
    if blocks.ndim not in (2, 3):
        raise ValueError(f"blocks must be (nb, B) or (nb, C, B), "
                         f"got {blocks.shape}")
    if blocks.shape[-1] % hop:
        raise ValueError(f"block length {blocks.shape[-1]} must be a "
                         f"multiple of hop {hop}")
    return roundtrip_hopped_chain(plan, state, blocks, hop, k_tile,
                                  refresh_every)


def sdft_hopped(plan: Plan, state: State, samples, hop: int
                ) -> tuple[State, jax.Array]:
    """Forward analysis emitting one spectrum per ``hop`` samples.

    The STFT-comparable usage pattern and the reference driver protocol
    (test/test.c:69-83 keeps each hop's first DFT vector): ~hop-fold cheaper
    than ``sdft`` + slicing because skipped spectra are never computed (see
    sdft_tpu.ops.lti.sdft_hopped).  The carry advances over *all* samples, so
    ``sdft_hopped`` and ``sdft``/``roundtrip`` interleave freely on a stream.

    Returns:
      (new_state, dfts) with dfts packed (ceil(M/hop), m, 2) or
      (C, ceil(M/hop), m, 2).
    """
    samples = jnp.asarray(samples)
    if samples.ndim in (1, 2):
        return _sdft_hopped_1d(plan, state, samples, hop)
    raise ValueError(f"samples must be (M,) or (C, M), got {samples.shape}")


@functools.partial(jax.jit, static_argnums=0)
def _refresh_1d(plan: Plan, state: State):
    return refresh_state(plan, state)


@functools.partial(jax.jit, static_argnums=0)
def _refresh_2d(plan: Plan, state: State):
    return jax.vmap(lambda st: refresh_state(plan, st))(state)


def refresh(plan: Plan, state: State) -> State:
    """Exactly rebuild the accumulator from the delayline (drift reset).

    The comb stage telescopes, so the accumulator is — in exact arithmetic —
    a pure function of (offset, delayline); recomputing it discards the f32
    rounding error the running sum accumulates over endless streams.  Two
    real matvecs (re/im); see ops.analysis.refresh_state.  Run every `refresh_every`
    blocks via Streamer, or call directly at any block boundary.
    """
    if state.offset.ndim == 0:
        return _refresh_1d(plan, state)
    return _refresh_2d(plan, state)


def isdft(plan: Plan, dfts) -> jax.Array:
    """Inverse synthesis: one sample per spectrum (c/src/sdft/sdft.h:666-672).

    Accepts packed (..., M, m, 2) arrays (device or host) or complex numpy
    matrices (converted on host).
    """
    if isinstance(dfts, np.ndarray) and np.iscomplexobj(dfts):
        dfts = from_complex(dfts, dtype=np.dtype(plan.precision.fd_dtype))
    dfts = jnp.asarray(dfts)
    if plan.precision.extended:
        # double-word tier: (..., M, m, 2, 2) (hi, lo) spectra in,
        # correctly-rounded f32 samples out (ops.twofloat.isdft_block_df
        # returns the full (hi, lo) pair for f64-class consumers)
        from .ops.twofloat import isdft_block_df

        if dfts.ndim not in (4, 5) or dfts.shape[-2:] != (2, 2):
            raise ValueError(
                "the float32x2 extended tier synthesizes from the packed "
                f"(..., M, m, 2, 2) (hi, lo) spectra, got {dfts.shape}")
        hi, lo = isdft_block_df(plan, dfts)
        return hi.astype(plan.precision.td_dtype)
    if dfts.ndim not in (3, 4) or dfts.shape[-1] != 2:
        raise ValueError(
            f"dfts must be packed (M, m, 2) or (C, M, m, 2), got {dfts.shape}")
    return _isdft(plan, dfts)


def sdft_interleaved(plan: Plan, state: State, frames, layout: str = "packed",
                     spectra_dtype: str | None = None):
    """Forward analysis of interleaved multi-channel audio.

    ``frames`` is (M, C) — one C-channel frame per time step, the memory
    layout of ``sdft_sdft_nd``'s strided entry point
    (c/src/sdft/sdft.h:615-633).  Transposes to the channel-major (C, M)
    batch and dispatches to :func:`sdft`; spectra come back channel-major
    (C, M, m, 2), matching the ``dfts + i * dftstride`` view of the
    reference call.
    """
    frames = jnp.asarray(frames)
    if frames.ndim != 2:
        raise ValueError(f"frames must be (M, C) interleaved, got "
                         f"{frames.shape}")
    return sdft(plan, state, frames.T, layout=layout,
                spectra_dtype=spectra_dtype)


def isdft_interleaved(plan: Plan, dfts) -> jax.Array:
    """Inverse synthesis returning interleaved (M, C) frames — the
    ``sdft_isdft_nd`` layout (c/src/sdft/sdft.h:676-694)."""
    y = isdft(plan, dfts)
    if y.ndim != 2:
        raise ValueError("isdft_interleaved needs channel-batched spectra "
                         "(C, M, m, 2)")
    return y.T


@functools.partial(jax.jit, static_argnums=(0, 2))
def _sdft_power_2d_pallas(plan: Plan, state: State, spectra_dtype, samples):
    from .kernels import forward_block_power

    return jax.vmap(
        lambda s1, x1: forward_block_power(plan, s1, x1,
                                           out_dtype=spectra_dtype)
    )(state, samples)


@functools.partial(jax.jit, static_argnums=(0, 2))
def _sdft_power_xla(plan: Plan, state: State, spectra_dtype, samples):
    if samples.ndim == 1:
        st, d = sdft_block(plan, state, samples)
    else:
        st, d = jax.vmap(lambda s, x: sdft_block(plan, s, x))(state, samples)
    p = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    if spectra_dtype:
        p = p.astype(spectra_dtype)
    return st, p


def sdft_power(plan: Plan, state: State, samples,
               spectra_dtype: str | None = None):
    """Forward analysis emitting the POWER spectrum |dft|^2 per sample —
    the spectrogram fast path.

    The full-rate complex spectra write is the forward path's roofline
    (PERF.md); magnitude/spectrogram consumers discard the phase, so
    emitting one |.|^2 plane halves that write (``spectra_dtype="bfloat16"``
    halves it again — power is consumed logarithmically, where bf16's ~3
    decimal digits are transparent).  On the GPU the squaring happens inside
    the spectra kernel at the store; on the CPU it is the XLA composition.

    Returns (new_state, power) with power (M, m) / (C, M, m) real.
    """
    samples = jnp.asarray(samples)
    if samples.ndim not in (1, 2):
        raise ValueError(f"samples must be (M,) or (C, M), got {samples.shape}")
    if use_kernel(plan, samples.size):
        from .kernels import forward_block_power

        if samples.ndim == 1:
            return forward_block_power(plan, state, samples,
                                       out_dtype=spectra_dtype)
        return _sdft_power_2d_pallas(plan, state, spectra_dtype, samples)
    return _sdft_power_xla(plan, state, spectra_dtype, samples)
