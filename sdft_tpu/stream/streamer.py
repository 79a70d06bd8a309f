"""Endless bounded-memory streaming driver.

Generalizes the reference's hop-chunked streaming protocol (test/test.c:69-83:
process hopsize samples per call, state persists in the plan) into a
double-buffered block pipeline: while the device processes block k, the host
stages block k+1 (jax dispatch is async, so ``device_put`` of the next block
overlaps with compute).  Memory is O(block), independent of stream length.

Checkpoint/resume: the complete resumable state is (offset, delayline,
accumulator) (SURVEY.md §5); ``Streamer.checkpoint``/``restore`` snapshot it
so a stream can resume at any block boundary after failure.
"""

from __future__ import annotations

import pathlib
from typing import Callable, Iterable, Iterator

import jax
import numpy as np

from ..api import isdft as _isdft
from ..api import refresh as _refresh
from ..api import roundtrip as _roundtrip
from ..api import sdft as _sdft
from ..plan import Plan
from ..state import State, init_state, state_from_arrays, state_to_arrays


class Streamer:
    """Stateful block-stream processor for one or many channels."""

    def __init__(self, plan: Plan, channels: int | None = None,
                 forward: Callable | None = None,
                 inverse: Callable | None = None,
                 refresh_every: int | None = None):
        """Args:
          plan: static SDFT plan.
          channels: None for a mono (M,) stream, else channel count C.
          forward/inverse: optional overrides for the block ops (e.g. the
            sharded or Pallas variants with plan/mesh already bound);
            default to the single-device jitted ops.
          refresh_every: if set, exactly rebuild the accumulator from the
            delayline every N blocks (api.refresh) — two real matvecs
            (re/im) that reset the f32 rounding drift of endless streams to
            zero (SURVEY.md §7 hard part (b)).  None disables.
        """
        self.plan = plan
        self.channels = channels
        self.refresh_every = refresh_every
        self._blocks_since_refresh = 0
        # With default ops and no spectral transform, round trips take the
        # collapsed LTI fast path (sdft_tpu.ops.lti) — spectra never exist.
        self._fused_roundtrip = forward is None and inverse is None
        self._forward = forward or (lambda st, x: _sdft(plan, st, x))
        self._inverse = inverse or (lambda d: _isdft(plan, d))
        self.state: State = init_state(plan, channels)
        self.samples_processed = 0

    def _maybe_refresh(self) -> None:
        if self.refresh_every is None:
            return
        self._blocks_since_refresh += 1
        if self._blocks_since_refresh >= self.refresh_every:
            self.state = _refresh(self.plan, self.state)
            self._blocks_since_refresh = 0

    def process(self, block) -> jax.Array:
        """Analyze one block; returns its DFT matrix (device array)."""
        self.state, dfts = self._forward(self.state, block)
        self.samples_processed += np.shape(block)[-1]
        self._maybe_refresh()
        return dfts

    def synthesize(self, dfts) -> jax.Array:
        """Inverse-transform one block of spectra."""
        return self._inverse(dfts)

    def roundtrip(self, block, transform: Callable | None = None) -> jax.Array:
        """Analyze + synthesize one block.

        Without ``transform`` the spectra are never materialized (collapsed
        LTI path).  With a traceable ``transform`` (complex spectra -> same
        shape) the transform runs *inside* the jitted program
        (api.roundtrip); define it once so the jit cache hits.
        """
        self.state, y = _roundtrip(self.plan, self.state, block, transform)
        self.samples_processed += np.shape(block)[-1]
        self._maybe_refresh()
        return y

    def run(self, blocks: Iterable, transform: Callable | None = None,
            fuse_transform: bool = False) -> Iterator[np.ndarray]:
        """Round-trip a stream of blocks with double buffering.

        Args:
          blocks: iterable of (M,) / (C, M) sample blocks.
          transform: optional spectral-domain callback applied between
            analysis and synthesis (e.g. filtering, pitch shifting).  By
            default it receives the *packed* (..., m, 2) device spectra of
            each block (host-side flexibility).  With ``fuse_transform`` it
            must instead be a jax-traceable pure function on *complex*
            (..., M, m) spectra.
          fuse_transform: run the transform inside the jitted round-trip
            program (api.roundtrip(transform=...)) — no spectra round trip
            through HBM-sized buffers at the jit boundary, and XLA fuses
            elementwise transforms into the synthesis matvec.  Requires the
            default forward/inverse ops.

        Yields:
          synthesized sample blocks as numpy arrays, one per input block.
        """
        if fuse_transform and (transform is None or not self._fused_roundtrip):
            raise ValueError("fuse_transform needs a transform and the "
                             "default forward/inverse ops")
        pending = None  # device array not yet synced to host
        for block in blocks:
            # Stage the next block onto the device; dispatch is async so this
            # overlaps with any in-flight compute.
            staged = jax.device_put(np.asarray(block))
            if self._fused_roundtrip and (transform is None or fuse_transform):
                y = self.roundtrip(staged, transform)
            else:
                dfts = self.process(staged)
                if transform is not None:
                    dfts = transform(dfts)
                y = self.synthesize(dfts)
            if pending is not None:
                yield np.asarray(pending)  # sync the *previous* block only
            pending = y
        if pending is not None:
            yield np.asarray(pending)

    def run_hopped(self, blocks: Iterable, hop: int, chain: int = 16
                   ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Chained driver-protocol streaming (the fast path).

        Groups ``chain`` equal-length blocks and runs each group through ONE
        compiled program (api.roundtrip_hopped: a lax.scan over the group)
        — one dispatch + one fetch per group instead of two programs per
        block, which is what the reference's hop loop (test/test.c:69-83)
        would cost in dispatches.

        Args:
          blocks: iterable of equal-length (M,) / (C, M) sample blocks,
            M a multiple of ``hop`` (a shorter final group is fine — it
            compiles one extra program).
          hop: spectra emission stride in samples.
          chain: blocks per compiled segment (kept modest: the first
            compilation grows with the scan length).

        Yields:
          (hop_dfts, samples) per input block — the packed
          (M//hop, m, 2) first-of-hop spectra and the (M,) synthesized
          round-trip samples, as numpy arrays.

        The accumulator refresh cadence (``refresh_every``) applies within
        each group, restarting at group boundaries.
        """
        from ..api import roundtrip_hopped

        buf: list = []

        def flush():
            xs = np.stack([np.asarray(b) for b in buf])
            self.state, hd, ys = roundtrip_hopped(
                self.plan, self.state, xs, hop,
                refresh_every=self.refresh_every)
            self.samples_processed += xs.shape[0] * xs.shape[-1]
            hd, ys = np.asarray(hd), np.asarray(ys)
            buf.clear()
            for b in range(hd.shape[0]):
                yield hd[b], ys[b]

        for block in blocks:
            buf.append(block)
            if len(buf) == chain:
                yield from flush()
        if buf:
            yield from flush()

    # -- checkpoint / resume --------------------------------------------------

    def checkpoint(self, path: str | pathlib.Path) -> None:
        """Snapshot carry state + stream position to an .npz file."""
        arrays = state_to_arrays(self.state)
        np.savez(path, samples_processed=self.samples_processed, **arrays)

    def restore(self, path: str | pathlib.Path) -> None:
        with np.load(path) as data:
            self.samples_processed = int(data["samples_processed"])
            self.state = state_from_arrays({k: data[k] for k in
                                            ("offset", "delayline", "accumulator")})
        # refresh cadence restarts at the checkpoint boundary, not wherever the
        # pre-restore counter happened to be
        self._blocks_since_refresh = 0

    def reset(self) -> None:
        self.state = init_state(self.plan, self.channels)
        self.samples_processed = 0
        self._blocks_since_refresh = 0


def iter_blocks(samples: np.ndarray, block: int, pad: bool = False
                ) -> Iterator[np.ndarray]:
    """Split (..., n) samples into (..., block) chunks (last one padded with
    zeros when ``pad`` else truncated, like the drivers' whole-hop truncation,
    test/test.c:61)."""
    n = samples.shape[-1]
    stop = n if pad else (n // block) * block
    for i in range(0, stop, block):
        chunk = samples[..., i:i + block]
        if chunk.shape[-1] < block:
            width = [(0, 0)] * (chunk.ndim - 1) + [(0, block - chunk.shape[-1])]
            chunk = np.pad(chunk, width)
        yield chunk
