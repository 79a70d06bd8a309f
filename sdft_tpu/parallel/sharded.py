"""SPMD sharded SDFT/iSDFT over a ('channel', 'time', 'bins') mesh.

One shard_map program computes the full forward (and optionally the inverse)
with all cross-device traffic expressed as XLA collectives riding ICI:

  * time axis  — each device scans its contiguous sample block locally
    (cumsum), then per-device block totals are combined into an exclusive
    prefix via all_gather + masked sum: the inter-block carry combine of the
    associative scan.  The predecessor's 2m-sample tail (comb-stage history)
    arrives via ppermute.
  * bins axis  — rotation/scan/demodulation are bin-local; the 3/5-tap
    window convolution exchanges a 1-2 column halo with neighbor shards via
    ppermute, while edge shards synthesize Hermitian guards locally
    (the sharded analogue of c/src/sdft/sdft.h:589-595).
  * channel axis — fully independent; no collectives.
  * inverse    — bin-partial synthesis matvecs reduced with psum over 'bins'
    (the sharded analogue of the reduction at c/src/sdft/sdft.h:639-653).

Layout contracts (asserted):
  samples (C, M): C % mesh.channel == 0, M % mesh.time == 0.
  dftsize m % mesh.bins == 0, and m/bins > window halo.
  Local time blocks M/time >= 2m keep the comb exchange to one neighbor
  ppermute; shorter blocks still work but all_gather the sample blocks
  (see _comb_history).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import numpy as np

from .. import cplx
from ..plan import Plan
from ..state import State
from ..windows import WINDOW_HALO, Window
from ..ops.convolve import window_convolve
from ..ops.lti import (K_TILE, _hop_consts_device,
                        _lti_consts_device, _stepped_consts_device,
                        driver_sub_factor)
from ..ops.twiddle import (exponent_dtype, fiddle_rows, mulmod,
                           synthesis_twiddles)

# Sharding specs for the batched State pytree: accumulator shards over bins,
# offset/delayline replicate over time and bins.  Spectral arrays are packed
# (trailing re/im axis of 2, replicated) — see sdft_tpu.cplx.
STATE_SPECS = State(
    offset=P("channel"),
    delayline=P("channel", None),
    accumulator=P("channel", "bins", None),
)
SAMPLE_SPEC = P("channel", "time")
DFT_SPEC = P("channel", "time", "bins", None)


def state_sharding(mesh: Mesh) -> State:
    """NamedShardings for placing a batched State onto the mesh."""
    return State(*[NamedSharding(mesh, s) for s in STATE_SPECS])


def _exclusive_prefix(local_total, axis: str):
    """Sum of block totals from devices strictly before this one, plus the
    grand total over all devices.  The inter-block carry combine."""
    gathered = lax.all_gather(local_total, axis)          # (D, ...) on every device
    d = lax.axis_index(axis)
    ndev = lax.axis_size(axis)
    mask = (jnp.arange(ndev) < d).astype(gathered.dtype)
    shape = (ndev,) + (1,) * (gathered.ndim - 1)
    prefix = (gathered * mask.reshape(shape)).sum(axis=0)
    grand = gathered.sum(axis=0)
    return prefix, grand


def _comb_history(delayline, samples, n2: int):
    """Comb-stage history for this time shard, plus the stream's next
    delayline.

    Returns (hist (C, n2), new_delayline (C, n2)) where ``hist`` holds the
    n2 = 2m samples immediately preceding this device's local block in the
    global stream (the reference ring-buffer content, c/src/sdft/sdft.h:433).

    When the local block L >= 2m the history lives entirely on the immediate
    predecessor: one tail ppermute + one 2m-tail all_gather.  When L < 2m it
    spans ceil(2m/L) predecessors; the local blocks are all_gathered (O(M)
    ICI traffic — the price of very fine time sharding) and each device
    slices its 2m-window out of the assembled stream.
    """
    C, L = samples.shape
    d = lax.axis_index("time")
    ndev = lax.axis_size("time")
    if L >= n2:
        tail = samples[:, -n2:]
        fwd = [(i, (i + 1) % ndev) for i in range(ndev)]
        prev_tail = lax.ppermute(tail, "time", fwd)
        hist = jnp.where(d == 0, delayline, prev_tail)
        tails = lax.all_gather(tail, "time")
        return hist, tails[-1]
    blocks = lax.all_gather(samples, "time")                  # (D, C, L)
    g = jnp.concatenate([delayline]
                        + [blocks[i] for i in range(blocks.shape[0])],
                        axis=-1)                              # (C, n2 + M)
    hist = lax.dynamic_slice_in_dim(g, d * L, n2, axis=-1)
    return hist, g[:, -n2:]


def _bin_halo_exchange(aux, halo: int, axis: str):
    """Pad local bin columns with neighbor halos; Hermitian guards at edges.

    aux: (C, L, mb) complex.  Returns (C, L, mb + 2*halo).
    """
    if halo == 0:
        return aux
    b = lax.axis_index(axis)
    nb = lax.axis_size(axis)

    # Receive the left neighbor's last columns / right neighbor's first ones.
    fwd = [(i, (i + 1) % nb) for i in range(nb)]   # data flows right
    bwd = [(i, (i - 1) % nb) for i in range(nb)]   # data flows left
    from_left = lax.ppermute(aux[..., -halo:], axis, fwd)
    from_right = lax.ppermute(aux[..., :halo], axis, bwd)

    # Edge shards: mirror conjugates around DC / Nyquist
    # (c/src/sdft/sdft.h:589-595).  Wrap-around ppermute data is discarded.
    herm_left = jnp.conj(aux[..., 1:halo + 1][..., ::-1])
    herm_right = jnp.conj(aux[..., -halo - 1:-1][..., ::-1])
    left = jnp.where(b == 0, herm_left, from_left)
    right = jnp.where(b == nb - 1, herm_right, from_right)
    return jnp.concatenate([left, aux, right], axis=-1)


def _forward_local(plan: Plan, state: State, samples, *, m_total: int):
    """Per-device forward body.  samples (C, L) local block; state batched
    with packed accumulator already bin-sharded to (C, mb, 2)."""
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    cd = plan.precision.fdx_dtype
    C, L = samples.shape
    mb = state.accumulator.shape[-2]
    acc_in = cplx.unpack(state.accumulator)  # (C, mb) complex

    d = lax.axis_index("time")
    b0 = lax.axis_index("bins") * mb
    bins = b0 + jnp.arange(mb, dtype=jnp.int32)

    samples = samples.astype(td)

    # --- comb stage: history from predecessor shard(s) ---------------------
    hist_src, new_delayline = _comb_history(state.delayline, samples, n2)
    line = jnp.concatenate([hist_src, samples], axis=-1)
    delta = (samples - line[:, :L]).astype(fd)

    # --- rotation with exact mod-2m phases --------------------------------
    start = state.offset.astype(jnp.int32)[:, None] + d * L  # (C, 1)
    e = start + jnp.arange(L, dtype=jnp.int32)[None, :]      # (C, L)
    # fiddle_rows is unbatched over channels; offsets differ per channel, so
    # vmap the phase construction (cheap integer work + cos/sin).
    fid = jax.vmap(lambda ek: fiddle_rows(plan, ek, bins=bins))(e)        # (C, L, mb)
    rot = delta[..., None].astype(cd) * fid
    if plan.roi is not None:
        # bins outside the ROI are never accumulated (c/src/sdft/sdft.h:570);
        # shards fully outside contribute zeros
        first, last = plan.roi
        roi = ((bins >= first) & (bins < last)).astype(fd)
        rot = rot * roi

    # Seed the scan with the carried accumulator on the first time shard.
    acc_seed = jnp.where(d == 0, acc_in, jnp.zeros_like(acc_in))
    rot = rot.at[:, 0, :].add(acc_seed)

    # --- local scan + inter-block carry combine ---------------------------
    cum = jnp.cumsum(rot, axis=1)
    local_total = cum[:, -1, :]                      # (C, mb)
    prefix, grand_total = _exclusive_prefix(local_total, "time")
    cum = cum + prefix[:, None, :]

    # --- demodulation + windowing -----------------------------------------
    demod = jax.vmap(lambda ek: fiddle_rows(plan, ek + 1, conj=True, bins=bins))(e)
    aux = cum * demod
    halo = WINDOW_HALO[plan.window]
    padded = _bin_halo_exchange(aux, halo, "bins")
    out = window_convolve(plan, padded, edges=False)
    if plan.roi is not None:
        # conv spill past the ROI edge reads as zero (ops.analysis semantics)
        out = out * roi.astype(out.dtype)
    dfts = cplx.pack(out)

    # --- next state -------------------------------------------------------
    new_state = State(
        offset=jnp.mod(state.offset + m_total, n2).astype(state.offset.dtype),
        delayline=new_delayline.astype(td),
        accumulator=cplx.pack(grand_total),
    )
    return new_state, dfts


def _inverse_local(plan: Plan, dfts, *, bins_sharded: bool):
    """Per-device synthesis: local bin partial + psum over 'bins'.
    dfts: (C, L, mb, 2) packed."""
    fd = plan.precision.fd_dtype
    mb = dfts.shape[-2]
    b0 = lax.axis_index("bins") * mb
    tw = synthesis_twiddles(plan)
    tw = lax.dynamic_slice_in_dim(tw, b0, mb) if bins_sharded else tw
    re = dfts[..., 0].astype(fd)
    hi = plan.precision.mxu_precision
    y = jnp.einsum("csm,m->cs", re, jnp.real(tw), precision=hi,
                   preferred_element_type=fd)
    if plan.latency != 1.0:
        im = dfts[..., 1].astype(fd)
        y = y - jnp.einsum("csm,m->cs", im, jnp.imag(tw), precision=hi,
                           preferred_element_type=fd)
    y = lax.psum(y, "bins")
    y = y * jnp.asarray(plan.synthesis_weight, fd)
    return y.astype(plan.precision.td_dtype)


def _roundtrip_local_lti(plan: Plan, state: State, samples, fine_re, fine_im,
                         P, Q, *, m_total: int):
    """Per-device collapsed-LTI round trip (see sdft_tpu.ops.lti).

    The Hermitian guards and window convolution are folded into the P/Q
    constants *before* bin slicing, so no bin-halo exchange is needed: the
    only collectives are the comb-tail ppermute + carry all_gather over
    'time' and one psum over 'bins' for the synthesis contraction.
    """
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    K = K_TILE
    C, L = samples.shape
    mb = state.accumulator.shape[-2]

    d = lax.axis_index("time")
    b0 = lax.axis_index("bins") * mb
    bins = b0 + jnp.arange(mb, dtype=jnp.int32)

    # local slices of the plan constants (bin columns)
    fre = lax.dynamic_slice_in_dim(fine_re, b0, mb, axis=1)
    fim = lax.dynamic_slice_in_dim(fine_im, b0, mb, axis=1)
    Pb = lax.dynamic_slice_in_dim(P, b0, mb, axis=1)
    Qb = lax.dynamic_slice_in_dim(Q, b0, mb, axis=1)
    hi = plan.precision.mxu_precision
    # local causal G matrix: G_b[k,k'] = sum_{j in shard} P[k,j]*fine_re[k',j]
    # + Q[k,j]*fine_im[k',j]; the psum over 'bins' below completes the sum.
    kk = jnp.arange(K)
    G = (jnp.dot(Pb, fre.T, precision=hi, preferred_element_type=fd)
         + jnp.dot(Qb, fim.T, precision=hi, preferred_element_type=fd))
    GLT = (G * (kk[None, :] <= kk[:, None])).T

    samples = samples.astype(td)

    # comb stage: history from predecessor time shard(s)
    hist_src, new_delayline = _comb_history(state.delayline, samples, n2)
    line = jnp.concatenate([hist_src, samples], axis=-1)
    delta = (samples - line[:, :L]).astype(fd)

    nt = -(-L // K)
    Lp = nt * K
    if Lp != L:
        delta = jnp.pad(delta, ((0, 0), (0, Lp - L)))
    dt = delta.reshape(C, nt, K)

    totals_re = jnp.einsum("ctk,km->ctm", dt, fre, precision=hi,
                           preferred_element_type=fd)
    totals_im = jnp.einsum("ctk,km->ctm", dt, fim, precision=hi,
                           preferred_element_type=fd)

    # absolute tile-start exponents: per channel (offsets are per-stream)
    edt = exponent_dtype(m)
    e0 = jnp.mod(state.offset.astype(edt)[:, None] + d * L
                 + jnp.arange(nt, dtype=edt)[None, :] * K, n2)
    r = mulmod(e0[..., None], bins[None, None, :], n2)
    ang = (-np.pi / m) * r.astype(fd)
    row0_re = jnp.cos(ang)
    row0_im = jnp.sin(ang)

    rt_re = row0_re * totals_re - row0_im * totals_im
    rt_im = row0_re * totals_im + row0_im * totals_re
    inc_re = jnp.cumsum(rt_re, axis=1)
    inc_im = jnp.cumsum(rt_im, axis=1)

    # two-level carry: exclusive prefix over devices, then over local tiles
    local_total = jnp.stack([inc_re[:, -1], inc_im[:, -1]], axis=-1)  # (C,mb,2)
    dev_prefix, grand = _exclusive_prefix(local_total, "time")
    acc_re = state.accumulator[..., 0].astype(fd) + dev_prefix[..., 0]
    acc_im = state.accumulator[..., 1].astype(fd) + dev_prefix[..., 1]
    prefix_re = acc_re[:, None, :] + jnp.concatenate(
        [jnp.zeros_like(inc_re[:, :1]), inc_re[:, :-1]], axis=1)
    prefix_im = acc_im[:, None, :] + jnp.concatenate(
        [jnp.zeros_like(inc_im[:, :1]), inc_im[:, :-1]], axis=1)

    c0_re = prefix_re * row0_re + prefix_im * row0_im
    c0_im = prefix_im * row0_re - prefix_re * row0_im

    y = (jnp.einsum("ctk,kj->ctj", dt, GLT, precision=hi,
                    preferred_element_type=fd)
         + jnp.einsum("ctm,km->ctk", c0_re, Pb, precision=hi,
                      preferred_element_type=fd)
         + jnp.einsum("ctm,km->ctk", c0_im, Qb, precision=hi,
                      preferred_element_type=fd))
    y = lax.psum(y, "bins").reshape(C, Lp)[:, :L].astype(td)

    new_state = State(
        offset=jnp.mod(state.offset + m_total, n2).astype(state.offset.dtype),
        delayline=new_delayline.astype(td),
        accumulator=(state.accumulator.astype(fd) + grand
                     ).astype(state.accumulator.dtype),
    )
    return new_state, y


def _hopped_local(plan: Plan, state: State, samples, fine_re, fine_im,
                  *stepped, hop: int, sub: int, m_total: int):
    """Per-device hopped analysis (one spectrum per hop of the global
    stream — the reference driver protocol, test/test.c:69-83).  Same prefix
    machinery as _roundtrip_local_lti with tile length ``hop``; the selected
    spectrum is the demodulated+windowed tile-start accumulator, so skipped
    spectra are never computed.  Window convolution runs after a bin-halo
    exchange (sharded Hermitian guards, c/src/sdft/sdft.h:589-595).

    ``sub > 1`` (degenerate hops, hop < 8) takes multi-hop tiles of
    K = hop*sub samples emitting ``sub`` spectra each via one extra GEMM
    against the stepped INCLUSIVE partial-totals table (``stepped`` =
    ops.lti._stepped_consts_device tables) — the same identity as the
    unsharded sdft_hopped and the fused sharded driver, so 1-sample hops
    keep full-depth contractions instead of (nt, 1) @ (1, m) matvecs.
    """
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    cd = plan.precision.fdx_dtype
    C, L = samples.shape
    mb = state.accumulator.shape[-2]

    d = lax.axis_index("time")
    b0 = lax.axis_index("bins") * mb
    bins = b0 + jnp.arange(mb, dtype=jnp.int32)

    # local bin columns of the tile phase table (K = hop*sub rows)
    fre = lax.dynamic_slice_in_dim(fine_re, b0, mb, axis=1)
    fim = lax.dynamic_slice_in_dim(fine_im, b0, mb, axis=1)
    roi = None
    if plan.roi is not None:
        # bins outside the ROI are never accumulated; shards fully outside
        # contribute zeros (_hopped_nd semantics under bin sharding)
        first, last = plan.roi
        roi = ((bins >= first) & (bins < last)).astype(fd)
        fre = fre * roi
        fim = fim * roi
    hi = plan.precision.mxu_precision

    samples = samples.astype(td)
    hist_src, new_delayline = _comb_history(state.delayline, samples, n2)
    line = jnp.concatenate([hist_src, samples], axis=-1)
    delta = (samples - line[:, :L]).astype(fd)

    K = hop * sub
    nt = L // K  # L % K == 0 enforced by caller
    dt = delta.reshape(C, nt, K)

    totals_re = jnp.einsum("ctk,km->ctm", dt, fre, precision=hi,
                           preferred_element_type=fd)
    totals_im = jnp.einsum("ctk,km->ctm", dt, fim, precision=hi,
                           preferred_element_type=fd)
    totals = (totals_re + 1j * totals_im).astype(cd)

    # absolute tile-start exponents (exact mod-2m integer phases)
    edt = exponent_dtype(m)
    e0 = jnp.mod(state.offset.astype(edt)[:, None] + d * L
                 + jnp.arange(nt, dtype=edt)[None, :] * K, n2)
    r = mulmod(e0[..., None], bins[None, None, :], n2)
    ang = (-np.pi / m) * r.astype(fd)
    row0 = jnp.cos(ang) + 1j * jnp.sin(ang)

    rt = row0 * totals
    inc = jnp.cumsum(rt, axis=1)

    # two-level carry: device-exclusive prefix over 'time', then local tiles
    local_total = cplx.pack(inc[:, -1])                       # (C, mb, 2)
    dev_prefix, grand = _exclusive_prefix(local_total, "time")
    acc_in = (cplx.unpack(state.accumulator.astype(fd))
              + cplx.unpack(dev_prefix))[:, None, :]
    prefix = acc_in + jnp.concatenate(
        [jnp.zeros_like(inc[:, :1]), inc[:, :-1]], axis=1)

    if sub == 1:
        # accumulator right after each tile's first sample; demodulate by
        # conj(T^(e0+1)) = conj(row0) * conj(T_j)  (c/src/sdft/sdft.h:585)
        d0 = dt[:, :, 0].astype(cd)[..., None]
        acc_sel = prefix + d0 * (row0 if roi is None else row0 * roi)
        conj_base = jnp.exp(1j * (np.pi / m) * bins.astype(fd)).astype(cd)
        aux = acc_sel * jnp.conj(row0) * conj_base
    else:
        # stepped leg: inner hop j's spectrum = (c0 + ptotals_j) * dr_j
        # with c0 the tile-start carry demodulated to absolute phase
        sf_re, sf_im, dr_re, dr_im = stepped
        sfr = lax.dynamic_slice_in_dim(
            sf_re.reshape(K, sub, m), b0, mb, axis=2)
        sfi = lax.dynamic_slice_in_dim(
            sf_im.reshape(K, sub, m), b0, mb, axis=2)
        drc = (lax.dynamic_slice_in_dim(dr_re, b0, mb, axis=1)
               + 1j * lax.dynamic_slice_in_dim(dr_im, b0, mb, axis=1)
               ).astype(cd)                                   # (sub, mb)
        c0 = prefix * jnp.conj(row0)
        pt = (jnp.einsum("ctk,kjm->ctjm", dt, sfr, precision=hi,
                         preferred_element_type=fd)
              + 1j * jnp.einsum("ctk,kjm->ctjm", dt, sfi, precision=hi,
                                preferred_element_type=fd)).astype(cd)
        aux = ((c0[:, :, None, :] + pt) * drc).reshape(C, nt * sub, mb)

    halo = WINDOW_HALO[plan.window]
    padded = _bin_halo_exchange(aux, halo, "bins")
    out = window_convolve(plan, padded, edges=False)
    if roi is not None:
        out = out * roi.astype(out.dtype)

    new_state = State(
        offset=jnp.mod(state.offset + m_total, n2).astype(state.offset.dtype),
        delayline=new_delayline.astype(td),
        accumulator=(state.accumulator.astype(fd) + grand
                     ).astype(state.accumulator.dtype),
    )
    return new_state, cplx.pack(out)


def _driver_block_local(plan: Plan, state: State, samples, fine_re, fine_im,
                        Pc, Qc, sf_re, sf_im, dr_re, dr_im, *, hop: int,
                        sub: int, m_total: int, refresh: bool):
    """Per-device FUSED driver-protocol block (the sharded form of
    ops.lti._fused_driver_nd): hop-rate spectra AND synthesized samples
    from ONE comb/delta stage, one totals GEMM pipeline and one prefix
    combine — the single-program-per-block sharded driver (rather than
    sharded_sdft_hopped and sharded_roundtrip back-to-back, recomputing
    both).

    Tiles are K = hop*sub samples; the spectrum at inner hop j is
    (c0 + ptotals_j) * T^-(j*hop+1) with the INCLUSIVE stepped partial
    totals (ops.lti._stepped_consts_device — for sub == 1 the single
    stepped column reduces to the hop-start delta d0, so one body covers
    degenerate and regular hops).  Collectives per block: the comb-tail
    ppermute + prefix all_gather over 'time', the window-conv halo
    ppermute over 'bins', and the synthesis psum over 'bins'.
    """
    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    K = hop * sub
    C, L = samples.shape
    mb = state.accumulator.shape[-2]

    d = lax.axis_index("time")
    b0 = lax.axis_index("bins") * mb
    bins = b0 + jnp.arange(mb, dtype=jnp.int32)
    hi = plan.precision.mxu_precision

    # local bin columns of the replicated plan constants
    fre = lax.dynamic_slice_in_dim(fine_re, b0, mb, axis=1)
    fim = lax.dynamic_slice_in_dim(fine_im, b0, mb, axis=1)
    Pb = lax.dynamic_slice_in_dim(Pc, b0, mb, axis=1)
    Qb = lax.dynamic_slice_in_dim(Qc, b0, mb, axis=1)
    sfr = lax.dynamic_slice_in_dim(
        sf_re.reshape(K, sub, m), b0, mb, axis=2)
    sfi = lax.dynamic_slice_in_dim(
        sf_im.reshape(K, sub, m), b0, mb, axis=2)
    drr = lax.dynamic_slice_in_dim(dr_re, b0, mb, axis=1)   # (sub, mb)
    dri = lax.dynamic_slice_in_dim(dr_im, b0, mb, axis=1)

    # local causal G: completed by the synthesis psum over 'bins'
    kk = jnp.arange(K)
    G = (jnp.dot(Pb, fre.T, precision=hi, preferred_element_type=fd)
         + jnp.dot(Qb, fim.T, precision=hi, preferred_element_type=fd))
    GLT = (G * (kk[None, :] <= kk[:, None])).T

    samples = samples.astype(td)
    hist_src, new_delayline = _comb_history(state.delayline, samples, n2)
    line = jnp.concatenate([hist_src, samples], axis=-1)
    delta = (samples - line[:, :L]).astype(fd)
    nt = L // K  # L % K == 0 enforced by the caller
    dt = delta.reshape(C, nt, K)

    totals_re = jnp.einsum("ctk,km->ctm", dt, fre, precision=hi,
                           preferred_element_type=fd)
    totals_im = jnp.einsum("ctk,km->ctm", dt, fim, precision=hi,
                           preferred_element_type=fd)

    edt = exponent_dtype(m)
    e0 = jnp.mod(state.offset.astype(edt)[:, None] + d * L
                 + jnp.arange(nt, dtype=edt)[None, :] * K, n2)
    r = mulmod(e0[..., None], bins[None, None, :], n2)
    ang = (-np.pi / m) * r.astype(fd)
    row0_re = jnp.cos(ang)
    row0_im = jnp.sin(ang)

    rt_re = row0_re * totals_re - row0_im * totals_im
    rt_im = row0_re * totals_im + row0_im * totals_re
    inc_re = jnp.cumsum(rt_re, axis=1)
    inc_im = jnp.cumsum(rt_im, axis=1)

    local_total = jnp.stack([inc_re[:, -1], inc_im[:, -1]], axis=-1)
    dev_prefix, grand = _exclusive_prefix(local_total, "time")
    acc_re = state.accumulator[..., 0].astype(fd) + dev_prefix[..., 0]
    acc_im = state.accumulator[..., 1].astype(fd) + dev_prefix[..., 1]
    prefix_re = acc_re[:, None, :] + jnp.concatenate(
        [jnp.zeros_like(inc_re[:, :1]), inc_re[:, :-1]], axis=1)
    prefix_im = acc_im[:, None, :] + jnp.concatenate(
        [jnp.zeros_like(inc_im[:, :1]), inc_im[:, :-1]], axis=1)

    c0_re = prefix_re * row0_re + prefix_im * row0_im
    c0_im = prefix_im * row0_re - prefix_re * row0_im

    # synthesis leg (psum over 'bins' completes the contraction)
    y = (jnp.einsum("ctk,kj->ctj", dt, GLT, precision=hi,
                    preferred_element_type=fd)
         + jnp.einsum("ctm,km->ctk", c0_re, Pb, precision=hi,
                      preferred_element_type=fd)
         + jnp.einsum("ctm,km->ctk", c0_im, Qb, precision=hi,
                      preferred_element_type=fd))
    y = lax.psum(y, "bins").reshape(C, L).astype(td)

    # hopped-spectra leg: inner partial totals + demod rows
    pt_re = jnp.einsum("ctk,kjm->ctjm", dt, sfr, precision=hi,
                       preferred_element_type=fd)
    pt_im = jnp.einsum("ctk,kjm->ctjm", dt, sfi, precision=hi,
                       preferred_element_type=fd)
    u_re = c0_re[:, :, None, :] + pt_re
    u_im = c0_im[:, :, None, :] + pt_im
    aux_re = (u_re * drr - u_im * dri).reshape(C, nt * sub, mb)
    aux_im = (u_re * dri + u_im * drr).reshape(C, nt * sub, mb)
    aux = (aux_re + 1j * aux_im).astype(plan.precision.fdx_dtype)

    halo = WINDOW_HALO[plan.window]
    padded = _bin_halo_exchange(aux, halo, "bins")
    out = window_convolve(plan, padded, edges=False)
    if plan.roi is not None:
        first, last = plan.roi
        roi = ((bins >= first) & (bins < last)).astype(fd)
        out = out * roi.astype(out.dtype)
    hd = cplx.pack(out)

    new_state = State(
        offset=jnp.mod(state.offset + m_total, n2).astype(state.offset.dtype),
        delayline=new_delayline.astype(td),
        accumulator=(state.accumulator.astype(fd) + grand
                     ).astype(state.accumulator.dtype),
    )
    if refresh:
        # the refresh identity reads only (offset, delayline) — both
        # replicated — so each device rebuilds the full accumulator and
        # keeps its bin slice (cheap: two S-chunked GEMMs over 2m samples)
        from ..ops.lti import _refresh_fused

        full = _refresh_fused(
            plan, State(offset=new_state.offset.astype(jnp.int32),
                        delayline=new_state.delayline,
                        accumulator=jnp.zeros(
                            (C, m, 2), new_state.accumulator.dtype)), fd)
        new_state = State(
            offset=new_state.offset,
            delayline=new_state.delayline,
            accumulator=lax.dynamic_slice_in_dim(
                full.accumulator, b0, mb, axis=1))
    return new_state, hd, y


@functools.partial(jax.jit, static_argnums=(0, 1, 5, 6, 7))
def _sharded_driver_chain_jit(plan: Plan, mesh: Mesh, state: State, xs,
                              consts, hop: int, sub: int, refresh: bool):
    m_total = xs.shape[-1]
    rep = P(None, None)

    def dev_body(st, xs_local, *tabs):
        def step(st, x):
            st, hd, y = _driver_block_local(
                plan, st, x, *tabs, hop=hop, sub=sub, m_total=m_total,
                refresh=refresh)
            return st, (hd, y)

        st, (hds, ys) = lax.scan(step, st, xs_local)
        return st, hds, ys

    return jax.shard_map(
        dev_body, mesh=mesh,
        in_specs=(STATE_SPECS, P(None, "channel", "time")) + (rep,) * 8,
        out_specs=(STATE_SPECS, P(None, "channel", "time", "bins", None),
                   P(None, "channel", "time")),
        check_vma=False,
    )(state, xs, *consts)


def sharded_roundtrip_hopped(plan: Plan, mesh: Mesh, state: State, blocks,
                             hop: int, refresh_every: int | None = 1):
    """Chained driver-protocol segment over the mesh: hop-dfts + synthesized
    samples for a stack of blocks in ONE sharded program (one dispatch) —
    the sharded counterpart of api.roundtrip_hopped, and the CLI --mesh
    fast path (one fused program per block inside a lax.scan, against the
    old two-programs-per-block + host-round-trip loop).

    Args:
      plan: static plan.
      mesh: ('channel', 'time', 'bins') mesh.
      state: batched State.
      blocks: (nb, C, B) stacked blocks; the local block B/time must be a
        multiple of hop*sub tiles (sub = driver_sub_factor(hop): 1 for
        hop >= 8).
      hop: hop size in samples (static).
      refresh_every: 1 (default) exactly rebuilds the accumulator from the
        delayline after every block (ops.analysis.refresh_state identity);
        None disables.  Coarser cadences are not offered here — the
        rebuild is two small GEMMs, negligible against a sharded block.

    Returns:
      (new_state, hop_dfts, ys): hop_dfts packed (nb, C, B//hop, m, 2), ys
      (nb, C, B), sharded (-, channel, time[, bins]).
    """
    blocks = jnp.asarray(blocks)
    if blocks.ndim != 3:
        raise ValueError(f"blocks must be (nb, C, B), got {blocks.shape}")
    nb_, C, B = blocks.shape
    _check_layout(plan, mesh, C, B)
    ax = dict(zip(mesh.axis_names, mesh.devices.shape))
    sub = driver_sub_factor(hop)
    K = hop * sub
    if (B // ax["time"]) % K:
        raise ValueError(
            f"local time block {B // ax['time']} not a multiple of the "
            f"driver tile hop*sub = {K}")
    if refresh_every not in (None, 1):
        raise ValueError("refresh_every must be None or 1 for the sharded "
                         "driver chain")
    fd = str(plan.precision.fd_dtype)
    consts = (_lti_consts_device(plan, K, fd)[:4]
              + _stepped_consts_device(plan, hop, sub, fd))
    return _sharded_driver_chain_jit(plan, mesh, state, blocks, consts,
                                     hop, sub, refresh_every == 1)


def _check_layout(plan: Plan, mesh: Mesh, C: int, M: int):
    ax = dict(zip(mesh.axis_names, mesh.devices.shape))
    nc, nt, nb = ax["channel"], ax["time"], ax["bins"]
    if C % nc:
        raise ValueError(f"channels {C} not divisible by mesh channel={nc}")
    if M % nt:
        raise ValueError(f"block {M} not divisible by mesh time={nt}")
    if plan.dftsize % nb:
        raise ValueError(f"dftsize {plan.dftsize} not divisible by mesh bins={nb}")
    if nb > 1 and plan.dftsize // nb <= WINDOW_HALO[plan.window]:
        raise ValueError("bin shard smaller than window halo")


@functools.partial(jax.jit, static_argnums=(0, 1))
def _sharded_sdft_jit(plan: Plan, mesh: Mesh, state: State, samples):
    m_total = samples.shape[-1]
    body = functools.partial(_forward_local, plan, m_total=m_total)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(STATE_SPECS, SAMPLE_SPEC),
        out_specs=(STATE_SPECS, DFT_SPEC),
        check_vma=False,
    )(state, samples)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _sharded_isdft_jit(plan: Plan, mesh: Mesh, dfts):
    nb = dict(zip(mesh.axis_names, mesh.devices.shape))["bins"]
    body = functools.partial(_inverse_local, plan, bins_sharded=nb > 1)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(DFT_SPEC,),
        out_specs=SAMPLE_SPEC,
        check_vma=False,
    )(dfts)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _sharded_roundtrip_jit(plan: Plan, mesh: Mesh, state: State, samples):
    """Fused forward+inverse: spectra never leave their shard."""
    m_total = samples.shape[-1]
    nb = dict(zip(mesh.axis_names, mesh.devices.shape))["bins"]

    def body(st, x):
        new_st, dfts = _forward_local(plan, st, x, m_total=m_total)
        y = _inverse_local(plan, dfts, bins_sharded=nb > 1)
        return new_st, y

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(STATE_SPECS, SAMPLE_SPEC),
        out_specs=(STATE_SPECS, SAMPLE_SPEC),
        check_vma=False,
    )(state, samples)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _sharded_roundtrip_lti_jit(plan: Plan, mesh: Mesh, state: State, samples,
                               consts):
    """Collapsed-LTI round trip over the mesh (sdft_tpu.ops.lti sharded)."""
    m_total = samples.shape[-1]
    body = functools.partial(_roundtrip_local_lti, plan, m_total=m_total)
    rep = P(None, None)  # plan constants replicate to every device
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(STATE_SPECS, SAMPLE_SPEC, rep, rep, rep, rep),
        out_specs=(STATE_SPECS, SAMPLE_SPEC),
        check_vma=False,
    )(state, samples, *consts)


@functools.partial(jax.jit, static_argnums=(0, 1, 4))
def _sharded_roundtrip_transform_jit(plan: Plan, mesh: Mesh, state: State,
                                     samples, transform):
    """Scan-form round trip with a spectral transform between analysis and
    synthesis — the reference's core spectral-processing pattern
    (python/src/sdft/sdft.py: analyze, modify the spectrum, resynthesize)
    under sharding.  The transform runs bin-locally on each shard's slice of
    the spectra, before the psum synthesis reduction."""
    m_total = samples.shape[-1]
    nb = dict(zip(mesh.axis_names, mesh.devices.shape))["bins"]
    mb = plan.dftsize // nb

    def body(st, x):
        new_st, dfts = _forward_local(plan, st, x, m_total=m_total)
        z = cplx.unpack(dfts)                               # (C, L, mb) complex
        bins = (lax.axis_index("bins") * mb
                + jnp.arange(mb, dtype=jnp.int32))          # global bin ids
        z2 = transform(z, bins)
        if z2.shape != z.shape:
            raise ValueError(
                f"transform must preserve the local spectra shape {z.shape}, "
                f"returned {z2.shape}")
        y = _inverse_local(plan, cplx.pack(z2), bins_sharded=nb > 1)
        return new_st, y

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(STATE_SPECS, SAMPLE_SPEC),
        out_specs=(STATE_SPECS, SAMPLE_SPEC),
        check_vma=False,
    )(state, samples)


@functools.partial(jax.jit, static_argnums=(0, 1, 5, 6))
def _sharded_hopped_jit(plan: Plan, mesh: Mesh, state: State, samples,
                        consts, hop: int, sub: int):
    m_total = samples.shape[-1]
    body = functools.partial(_hopped_local, plan, hop=hop, sub=sub,
                             m_total=m_total)
    rep = P(None, None)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(STATE_SPECS, SAMPLE_SPEC) + (rep,) * len(consts),
        out_specs=(STATE_SPECS, DFT_SPEC),
        check_vma=False,
    )(state, samples, *consts)


def sharded_sdft_hopped(plan: Plan, mesh: Mesh, state: State, samples,
                        hop: int):
    """Hopped forward analysis over the mesh: one spectrum per ``hop``
    samples of the global stream (the reference driver protocol,
    test/test.c:69-83), so the sharded CLI path can produce the comparator
    .dft dump without materializing every spectrum.

    Args:
      plan: static plan (ROI folds into the tile tables).
      mesh: ('channel', 'time', 'bins') mesh.
      state: batched State.
      samples: (C, M); M/time must be a multiple of ``hop``.
      hop: hop size in samples (static).

    Returns:
      (new_state, dfts) with dfts packed (C, M/hop, m, 2), sharded
      (channel, time, bins, -).

    Degenerate hops (< 8) ride multi-hop stepped tiles (K = hop*sub,
    ops.lti._stepped_consts_device) when the local block divides into
    them, falling back to hop-depth tiles otherwise — same dispatch as
    the unsharded sdft_hopped.
    """
    samples = jnp.asarray(samples)
    C, M = samples.shape
    _check_layout(plan, mesh, C, M)
    nt = dict(zip(mesh.axis_names, mesh.devices.shape))["time"]
    if (M // nt) % hop:
        raise ValueError(
            f"local time block {M // nt} not a multiple of hop {hop}")
    sub = driver_sub_factor(hop)
    if (M // nt) % (hop * sub):
        sub = 1                      # keep any hop-multiple block legal
    fd_s = str(plan.precision.fd_dtype)
    consts = _hop_consts_device(plan, hop * sub, fd_s)
    if sub > 1:
        consts = consts + _stepped_consts_device(plan, hop, sub, fd_s)
    return _sharded_hopped_jit(plan, mesh, state, samples, consts, hop, sub)


def sharded_sdft(plan: Plan, mesh: Mesh, state: State, samples,
                 use_pallas: bool | None = None):
    """Forward analysis over the mesh.

    Args:
      plan: static plan.
      mesh: ('channel', 'time', 'bins') mesh from make_mesh.
      state: batched State (leading channel axis on all leaves).
      samples: (C, M) samples.
      use_pallas: None (default) takes the spectra-kernel program
        (sharded_sdft_pallas) when the mesh is bins=1 and api.sdft would
        take the kernel (a GPU backend and a kernel plan) — the same rule
        and the same bf16-split contraction class as api.sdft; True forces
        it (raises off the GPU), False forces the XLA scan program.

    Returns:
      (new_state, dfts) with dfts packed (C, M, m, 2), sharded
      (channel, time, bins, -).
    """
    from ..kernels import kernel_platform, use_kernel

    samples = jnp.asarray(samples)
    C, M = samples.shape
    _check_layout(plan, mesh, C, M)
    ax = dict(zip(mesh.axis_names, mesh.devices.shape))
    if use_pallas is None:
        local = (C // ax["channel"]) * (M // ax["time"])
        use_pallas = ax["bins"] == 1 and use_kernel(plan, local)
    elif use_pallas and not kernel_platform():
        raise ValueError("use_pallas=True needs a GPU backend (the spectra "
                         "kernel is compiled for the GPU); on the CPU use "
                         "sharded_sdft_pallas(..., interpret=True)")
    if use_pallas:
        return sharded_sdft_pallas(plan, mesh, state, samples)
    return _sharded_sdft_jit(plan, mesh, state, samples)


def sharded_isdft(plan: Plan, mesh: Mesh, dfts):
    """Inverse synthesis over the mesh; packed dfts (C, M, m, 2) -> (C, M)."""
    dfts = jnp.asarray(dfts)
    C, M, _, _ = dfts.shape
    _check_layout(plan, mesh, C, M)
    return _sharded_isdft_jit(plan, mesh, dfts)


def sharded_roundtrip(plan: Plan, mesh: Mesh, state: State, samples,
                      *, collapsed: bool = True, transform=None):
    """Fused analysis+synthesis step (the flagship full-step program).

    With ``collapsed`` (default) the per-shard compute is the LTI form —
    three matrix products per device, no bin-halo exchange (guards and window
    conv are folded into plan constants).  ``collapsed=False`` runs the
    scan-form program (per-sample spectra inside each shard); both produce
    the same samples and carry state up to rounding.

    With ``transform`` — the reference's core spectral-processing pattern
    (python/src/sdft/sdft.py: analyze, modify the spectrum, resynthesize) —
    the chain is no longer LTI, so the scan-form program runs with the
    transform applied to each shard's bin-local spectra before the psum
    synthesis.  ``transform(spectra, bins)`` must be a traceable pure
    function of the complex (C, L, mb) local spectra and the (mb,) int32
    *global* bin indices of the shard, returning the same shape — e.g. a
    low-pass: ``lambda z, bins: z * (bins < cutoff)``.  It is hashed by
    identity for the jit cache, so define it once rather than inline per
    call.  A bin-sharded mesh applies it shard-wise; results equal the
    single-device ``api.roundtrip(transform=...)`` up to rounding.
    """
    samples = jnp.asarray(samples)
    C, M = samples.shape
    _check_layout(plan, mesh, C, M)
    if transform is not None:
        return _sharded_roundtrip_transform_jit(plan, mesh, state, samples,
                                                transform)
    if collapsed:
        consts = _lti_consts_device(plan, K_TILE,
                                    str(plan.precision.fd_dtype))[:4]
        return _sharded_roundtrip_lti_jit(plan, mesh, state, samples, consts)
    return _sharded_roundtrip_jit(plan, mesh, state, samples)


def _forward_local_pallas(state: State, samples, *, plan: Plan,
                          m_total: int, layout: str, spectra_dtype,
                          interpret: bool):
    """Per-device body for the time-sharded Pallas spectra program.

    Each time shard derives its block-start accumulator from the 2m-sample
    comb history it ALREADY receives for the delta stage (the refresh
    identity, ops.analysis.refresh_state: the carry is a pure function of
    the last 2m samples and the offset) — so the inter-block carry needs
    NO prefix collective at all; the single ppermute of _comb_history is
    the program's only cross-device traffic.  Each device then runs the
    unmodified fused spectra kernel (kernels.forward_block_pallas) on its
    local block, writing only its local (C, L, m) output slab — the
    O(M*m) spectra write, the path's roofline, scales linearly with the
    time axis.
    """
    from ..kernels import forward_block_pallas
    from ..ops.lti import _refresh_fused

    m = plan.dftsize
    n2 = 2 * m
    td = plan.precision.td_dtype
    fd = plan.precision.fd_dtype
    C, L = samples.shape
    d = lax.axis_index("time")

    samples = samples.astype(td)
    hist, new_delayline = _comb_history(state.delayline, samples, n2)

    off_d = jnp.mod(state.offset.astype(jnp.int32) + d * L, n2)
    zero_acc = jnp.zeros_like(state.accumulator)
    st0 = _refresh_fused(
        plan, State(offset=off_d, delayline=hist.astype(td),
                    accumulator=zero_acc), fd)

    def one(st1, x):
        return forward_block_pallas(plan, st1, x, interpret=interpret,
                                    layout=layout, out_dtype=spectra_dtype)

    _, dfts = jax.vmap(one)(st0, samples)

    # global end state (identical on every device): the stream tail plus
    # the end accumulator from the same refresh identity
    off_end = jnp.mod(state.offset + m_total, n2).astype(state.offset.dtype)
    st_end = _refresh_fused(
        plan, State(offset=off_end.astype(jnp.int32),
                    delayline=new_delayline.astype(td),
                    accumulator=zero_acc), fd)
    new_state = State(
        offset=off_end,
        delayline=new_delayline.astype(td),
        accumulator=st_end.accumulator.astype(state.accumulator.dtype))
    return new_state, dfts


@functools.partial(jax.jit, static_argnums=(0, 1, 4, 5, 6))
def _sharded_sdft_pallas_jit(plan: Plan, mesh: Mesh, state, samples,
                             layout: str, spectra_dtype, interpret: bool):
    m_total = samples.shape[-1]
    body = functools.partial(_forward_local_pallas, plan=plan,
                             m_total=m_total, layout=layout,
                             spectra_dtype=spectra_dtype,
                             interpret=interpret)
    if layout == "planar":
        dft_spec = (P("channel", "time", None),) * 2
    else:
        dft_spec = P("channel", "time", None, None)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(STATE_SPECS, SAMPLE_SPEC),
        out_specs=(STATE_SPECS, dft_spec),
        check_vma=False,
    )(state, samples)


def sharded_sdft_pallas(plan: Plan, mesh: Mesh, state: State, samples,
                        layout: str = "packed",
                        spectra_dtype: str | None = None,
                        interpret: bool = False):
    """Forward analysis emitting ALL spectra over the mesh with the fused
    Pallas kernel per time shard (see _forward_local_pallas).

    The scale path for the primary `sdft()` API: the per-sample spectra
    write is the single-device roofline (PERF.md), and this program
    splits it linearly across the `time` axis — the carry comes from the
    comb history each shard already holds, so the only collectives are
    _comb_history's exchanges (size local blocks >= 2m to keep them at a
    tail ppermute + 2m all_gather).  Requires a bins=1 mesh (bin-sharded
    spectra take the XLA scan path, `sharded_sdft`), a kernel plan
    (kernels.plan_supported) and local blocks within the kernel's int32
    output range (spectra_triton.fits).

    Returns (state, dfts) — packed (C, M, m, 2), or the planar (re, im)
    pair with ``layout="planar"`` (optionally bf16 via ``spectra_dtype``),
    sharded (channel, time).
    """
    from ..kernels.spectra_triton import fits, plan_supported

    samples = jnp.asarray(samples)
    C, M = samples.shape
    _check_layout(plan, mesh, C, M)
    ax = dict(zip(mesh.axis_names, mesh.devices.shape))
    if ax["bins"] != 1:
        raise ValueError("sharded_sdft_pallas shards time/channel only; "
                         "use sharded_sdft for bin-sharded spectra")
    if layout not in ("packed", "planar"):
        raise ValueError(f"layout must be 'packed' or 'planar', "
                         f"got {layout!r}")
    if spectra_dtype and layout != "planar":
        raise ValueError("spectra_dtype requires layout='planar'")
    if not (plan_supported(plan)
            and fits(plan, (C // ax["channel"]) * (M // ax["time"]))):
        raise ValueError(f"plan {plan} at {C}x{M} samples is outside the "
                         "spectra kernel; use sharded_sdft")
    return _sharded_sdft_pallas_jit(plan, mesh, state, samples, layout,
                                    spectra_dtype, interpret)
