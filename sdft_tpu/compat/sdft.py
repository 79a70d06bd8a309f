"""Drop-in stateful SDFT class mirroring the reference Python API.

Reference surface (python/src/sdft/sdft.py:25-145): ``SDFT(dftsize, window,
latency)`` with methods ``sdft``, ``isdft``, ``reset`` and attributes
``size``, ``window``, ``latency``.  A user of ``sdft.SDFT`` can switch to
``sdft_tpu.SDFT`` unchanged; compute runs through the jitted JAX ops on
whatever backend is active (GPU or CPU), and NumPy arrays come back.
"""

from __future__ import annotations

import numpy as np

from ..api import isdft as _isdft
from ..api import sdft as _sdft
from ..cplx import from_complex, to_complex
from ..config import DEFAULT_PRECISION, Precision
from ..plan import Plan
from ..state import init_state, reset_state


class SDFT:
    """Sliding Discrete Fourier Transform (stateful convenience wrapper)."""

    def __init__(self, dftsize: int, window: str = "hann", latency: float = 1,
                 precision: Precision = DEFAULT_PRECISION):
        """Create a new SDFT plan.

        Args:
          dftsize: desired number of DFT bins.
          window: analysis window type (boxcar, hann, hamming or blackman).
          latency: synthesis latency factor between 0 and 1; 1 (default) is
            highest latency / best SNR (c/src/sdft/sdft.h:404-412).
          precision: TD/FD dtype pair (extension over the reference, which
            fixes Python to float64).
        """
        self.plan = Plan(dftsize, window=window, latency=latency, precision=precision)
        self._state = init_state(self.plan)

    # -- reference-compatible attributes --------------------------------------

    @property
    def size(self) -> int:
        return self.plan.dftsize

    @property
    def window(self) -> str:
        return self.plan.window.value

    @property
    def latency(self) -> float:
        return self.plan.latency

    # -- reference-compatible methods -----------------------------------------

    def reset(self) -> None:
        """Reset this SDFT plan to its initial state."""
        self._state = reset_state(self.plan, self._state)

    def sdft(self, samples) -> np.ndarray:
        """Estimate the DFT matrix (samples, frequencies) for a sample array."""
        samples = np.atleast_1d(np.asarray(samples))
        if samples.ndim != 1:
            raise ValueError(f"Expected 1D array (samples,), got {samples.shape}!")
        self._state, dfts = _sdft(self.plan, self._state, samples)
        return to_complex(dfts)

    def isdft(self, dfts) -> np.ndarray:
        """Synthesize the sample array from a DFT matrix."""
        dfts = np.atleast_2d(np.asarray(dfts))
        if dfts.ndim != 2:
            raise ValueError(f"Expected 2D array (samples,frequencies), got {dfts.shape}!")
        packed = from_complex(dfts, dtype=np.dtype(self.plan.precision.fd_dtype))
        return np.asarray(_isdft(self.plan, packed))
