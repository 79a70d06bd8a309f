"""FFT-based STFT comparator, JAX-native.

The reference ships an STFT/iSTFT class purely to validate SDFT output
against the classic FFT short-time transform (python/src/sdft/stft.py:17-197;
README.md:121-129 uses it for the side-by-side spectrogram proof).  Same API
here: ``STFT(framesize, hopsize, dftsize, window, shift)`` with ``stft`` /
``istft``, symmetric and asymmetric windows, WOLA synthesis, optional
circular shift.  Framing/overlap-add are expressed as gather/scatter-add so
the whole pipeline jits.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _symmetric_window(window: str, n: int) -> np.ndarray:
    """Periodic cosine-sum windows (python/src/sdft/stft.py:149-167)."""
    w = str(window).lower()
    t = 2 * np.pi * np.arange(n) / n
    if w == "hann":
        return 0.5 - 0.5 * np.cos(t)
    if w == "hamming":
        return 0.54 - 0.46 * np.cos(t)
    if w == "blackman":
        return 0.42 - 0.5 * np.cos(t) + 0.08 * np.cos(2 * t)
    return np.ones(n)


def _asymmetric_analysis_window(window: str, n: int, m: int) -> np.ndarray:
    """python/src/sdft/stft.py:169-182 (n = analysis size, m = synthesis//2)."""
    left = _symmetric_window(window, 2 * n - 2 * m)
    right = _symmetric_window(window, 2 * m)
    out = np.zeros(n)
    out[: n - m] = left[: n - m]
    out[-m:] = right[-m:]
    return out


def _asymmetric_synthesis_window(window: str, n: int, m: int) -> np.ndarray:
    """python/src/sdft/stft.py:184-197."""
    left = _symmetric_window(window, 2 * n - 2 * m)
    right = _symmetric_window(window, 2 * m)
    out = np.zeros(n)
    out[n - 2 * m: n - m] = np.square(right[:m]) / left[n - 2 * m: n - m]
    out[-m:] = right[-m:]
    return out


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _frame_fft(samples, framesize, hopsize, shift, window):
    nframes = (samples.shape[0] - framesize) // hopsize + 1
    idx = jnp.arange(nframes)[:, None] * hopsize + jnp.arange(framesize)[None, :]
    frames = samples[idx] * window[None, :]
    if shift:
        frames = jnp.fft.fftshift(frames, axes=-1)
    dfts = jnp.fft.rfft(frames, axis=-1, norm="forward")
    # packed at the jit boundary (sdft_tpu.cplx)
    return jnp.stack([jnp.real(dfts), jnp.imag(dfts)], axis=-1)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _ifft_overlap_add(dfts_packed, framesize, hopsize, shift, total, window):
    dfts = jax.lax.complex(dfts_packed[..., 0], dfts_packed[..., 1])
    frames = jnp.fft.irfft(dfts, axis=-1, norm="forward")
    if shift:
        frames = jnp.fft.ifftshift(frames, axes=-1)
    frames = frames * window[None, :]
    nframes = frames.shape[0]
    idx = jnp.arange(nframes)[:, None] * hopsize + jnp.arange(framesize)[None, :]
    out = jnp.zeros(total, frames.dtype)
    return out.at[idx.reshape(-1)].add(frames.reshape(-1))


class STFT:
    """Short-Time Fourier Transform (reference comparator)."""

    def __init__(self, framesize: int, hopsize: int, dftsize: int | None = None,
                 window: str = "hann", shift: bool = False):
        """Create a new STFT plan (python/src/sdft/stft.py:22-52).

        Args:
          framesize: buffer size in samples.
          hopsize: hop size in samples.
          dftsize: optional DFT size enabling asymmetric windows.
          window: window function (boxcar, hann, hamming or blackman).
          shift: enable circular shift.
        """
        self.framesize = framesize
        self.hopsize = hopsize
        self.dftsize = dftsize
        self.window = window
        self.shift = shift

        self.analysis_window_size = framesize if dftsize is None else (dftsize - 1) * 2
        self.synthesis_window_size = framesize
        if self.analysis_window_size < self.synthesis_window_size:
            raise ValueError("Invalid framesize and dftsize combination!")

    def _analysis_window(self) -> np.ndarray:
        n, s = self.analysis_window_size, self.synthesis_window_size
        if n != s:
            return _asymmetric_analysis_window(self.window, n, s // 2)
        return _symmetric_window(self.window, n)

    def _synthesis_window(self) -> np.ndarray:
        n, s = self.analysis_window_size, self.synthesis_window_size
        if n != s:
            return _asymmetric_synthesis_window(self.window, n, s // 2)
        return _symmetric_window(self.window, s)

    def stft(self, samples) -> np.ndarray:
        """Estimate the DFT matrix (frames, frequencies) for a sample array."""
        samples = jnp.atleast_1d(jnp.asarray(samples))
        if samples.ndim != 1:
            raise ValueError(f"Expected 1D array (samples,), got {samples.shape}!")
        w = jnp.asarray(self._analysis_window(), samples.dtype)
        packed = np.asarray(_frame_fft(samples, self.analysis_window_size,
                                       self.hopsize, self.shift, w))
        return packed[..., 0] + 1j * packed[..., 1]

    def istft(self, dfts) -> np.ndarray:
        """WOLA synthesis from a DFT matrix (python/src/sdft/stft.py:83-123)."""
        dfts = np.atleast_2d(np.asarray(dfts))
        if dfts.ndim != 2:
            raise ValueError(f"Expected 2D array (frames,frequencies), got {dfts.shape}!")
        A = self._analysis_window()
        S = self._synthesis_window()
        W = S * self.hopsize / np.sum(A * S)
        total = dfts.shape[0] * self.hopsize + self.analysis_window_size
        packed = jnp.asarray(np.stack([np.real(dfts), np.imag(dfts)], axis=-1))
        return np.asarray(_ifft_overlap_add(packed, self.analysis_window_size,
                                            self.hopsize, self.shift, total,
                                            jnp.asarray(W)))
