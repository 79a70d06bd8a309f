"""The SDFT plan: static, hashable configuration.

Unlike the reference — where the plan is a heap object owning mutable buffers
(c/src/sdft/sdft.h:413-450 ``sdft_alloc_custom``) — this design
splits "plan" into two pieces:

  * ``Plan`` (this module): immutable *static* configuration (dftsize, window,
    latency, precision, block/tiling knobs).  It is hashable, so it can be a
    static argument under ``jax.jit``; all derived constants (twiddle tables,
    synthesis weights) are computed *inside* the traced function and constant-
    folded by XLA.
  * ``State`` (:mod:`sdft_tpu.state`): the functional carry
    (offset, delayline, accumulator) — a pytree threaded through ops.

Key numerical choice: the reference C keeps a running per-bin phasor that is
multiplied per sample and reset to exactly 1+0i every 2m samples
(c/src/sdft/sdft.h:566-576), while the reference Python raises a twiddle to an
unbounded integer power (python/src/sdft/sdft.py:101-106).  We combine both:
all phases are derived from *integer exponents reduced mod 2m*, which is exact
for any stream length (twiddle^(2m) == 1), so no reset is ever needed and no
phase drift can accumulate.
"""

from __future__ import annotations

import dataclasses

from .config import Precision, DEFAULT_PRECISION
from .windows import Window, WINDOW_HALO



@dataclasses.dataclass(frozen=True)
class Plan:
    """Immutable SDFT configuration.

    Attributes:
      dftsize: number of DFT bins m; the sliding window spans 2m real samples
        (reference: README.md:20, c/src/sdft/sdft.h:431-433).
      window: analysis window (reference default hann, c/src/sdft/sdft.h:457-460).
      latency: synthesis latency factor in (0, 1]; 1 = best SNR, smaller =
        lower latency and SNR (c/src/sdft/sdft.h:404-412).
      precision: TD/FD dtype pair (c/src/sdft/sdft.h:21-37).
      roi: optional half-open bin range (first, last) to analyze/synthesize.
        The reference carries this as internal plan state, always full-band
        (analysis.roi/synthesis.roi, c/src/sdft/sdft.h:425-426,137-143); here
        it is public: bins outside the ROI are never accumulated and read as
        zero, and the inverse reduces only over ROI bins.  None = full band.
    """

    dftsize: int
    window: Window = Window.HANN
    latency: float = 1.0
    precision: Precision = DEFAULT_PRECISION
    roi: tuple | None = None

    def __post_init__(self):
        if not isinstance(self.dftsize, int) or self.dftsize < 1:
            raise ValueError(f"dftsize must be a positive int, got {self.dftsize!r}")
        object.__setattr__(self, "window", Window.parse(self.window))
        if not (0.0 < float(self.latency) <= 1.0):
            raise ValueError(f"latency must be in (0, 1], got {self.latency!r}")
        object.__setattr__(self, "latency", float(self.latency))
        hop_min = WINDOW_HALO[self.window] + 1
        if self.dftsize < hop_min + 1:
            raise ValueError(
                f"dftsize {self.dftsize} too small for window {self.window.value} "
                f"(needs at least {hop_min + 1} bins for Hermitian guards)"
            )
        if self.roi is not None:
            first, last = (int(self.roi[0]), int(self.roi[1]))
            if not (0 <= first < last <= self.dftsize):
                raise ValueError(
                    f"roi must satisfy 0 <= first < last <= {self.dftsize}, "
                    f"got {self.roi!r}")
            if (first, last) == (0, self.dftsize):
                object.__setattr__(self, "roi", None)  # canonical full band
            else:
                object.__setattr__(self, "roi", (first, last))

    # -- derived static quantities -------------------------------------------

    @property
    def window_size(self) -> int:
        """Sliding window span in samples: N = 2m (c/src/sdft/sdft.h:433)."""
        return 2 * self.dftsize

    @property
    def analysis_weight(self) -> float:
        """Forward normalization 1/(2m) (c/src/sdft/sdft.h:422)."""
        return 1.0 / (2 * self.dftsize)

    @property
    def synthesis_weight(self) -> float:
        """Inverse scale factor 2 (c/src/sdft/sdft.h:423)."""
        return 2.0

    @property
    def roi_bins(self) -> tuple:
        """Resolved half-open bin range (first, last)."""
        return self.roi if self.roi is not None else (0, self.dftsize)

    @property
    def synthesis_delay(self) -> int:
        """Algorithmic round-trip latency in samples: (m-1)*latency
        (python/examples/latency.py:30)."""
        return int((self.dftsize - 1) * self.latency)

    def with_(self, **kwargs) -> "Plan":
        return dataclasses.replace(self, **kwargs)
