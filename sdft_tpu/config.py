"""Precision configuration for the SDFT framework.

The reference keeps time-domain (TD) and frequency-domain (FD) precision
independently configurable (reference: c/src/sdft/sdft.h:21-37 ``SDFT_TD_*`` /
``SDFT_FD_*`` macros; cpp/src/sdft/sdft.h:47-48 template params ``SDFT<T, F>``).
We mirror that with a small frozen dataclass that is hashable, so it can ride
along as a static argument under ``jax.jit``.

float64 is only available when ``jax_enable_x64`` is on.  ``resolve()``
canonicalizes the requested dtypes against the current JAX x64 setting so
the library degrades gracefully instead of tracing dtypes that JAX will
silently downcast.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

_REAL_DTYPES = ("float32", "float64")
#: FD-only extended tier: double-word float32 pairs (ops.twofloat) — the
#: analogue of the reference's `long double` FD tier
#: (c/src/sdft/sdft.h:21-37): ~2^-48 relative spectra accuracy from float32
#: arithmetic alone.
_FD_DTYPES = _REAL_DTYPES + ("float32x2",)


def _complex_of(real_dtype: str) -> str:
    return {"float32": "complex64", "float64": "complex128",
            "float32x2": "complex64"}[real_dtype]


@dataclasses.dataclass(frozen=True)
class Precision:
    """Time-domain / frequency-domain dtype pair.

    Attributes:
      td: real dtype name for time-domain samples ("float32" or "float64").
          Reference default is float (c/src/sdft/sdft.h:101-106).
      fd: real dtype name underlying frequency-domain complex values
          ("float32" or "float64").  Reference default/recommendation is
          double (c/src/sdft/sdft.h:113-118).  "float32x2" selects the
          double-word extended tier (ops.twofloat): api.sdft computes
          f64-class spectra from float32 pairs on any backend, and
          api.isdft synthesizes correctly-rounded samples from them —
          the analogue of the reference's `long double` FD tier; other
          entry points (roundtrip, sdft_power, ...) treat it as float32.
    """

    td: str = "float32"
    fd: str = "float64"
    #: Accumulation mode for float32 contractions (lax.Precision of every
    #: f32 dot): "highest" (the default) is true f32 — on the H100 the dot
    #: runs on the f32 units, never in TF32 — and is what the reference
    #: 1e-7 comparator gate is held to.  "high" lets XLA use a faster
    #: reduced-precision algorithm (on the H100, TF32 tensor cores or a
    #: bf16 split, at XLA's choice); its error is a matrix-product rounding
    #: inside each block that the accumulator refresh cannot heal, so it is
    #: for accuracy-tolerant spectrogram/monitoring work only.  "split4"
    #: (collapsed round trip only) splits BOTH operands into masked bf16
    #: hi+lo halves and takes all four cross products on the bf16 tensor
    #: cores — the exact product of the split operands, ~16-17 mantissa
    #: bits — for throughput-first streaming where the synthesized-sample
    #: tolerance (~1e-4 class) matters rather than the 1e-7 spectra gate.
    #: The error of each mode on the GPU is not measured yet.  Ignored for
    #: f64.
    mxu: str = "highest"

    def __post_init__(self):
        if self.td not in _REAL_DTYPES:
            raise ValueError(f"unsupported td dtype {self.td!r}; pick from {_REAL_DTYPES}")
        if self.fd not in _FD_DTYPES:
            raise ValueError(f"unsupported fd dtype {self.fd!r}; pick from {_FD_DTYPES}")
        if self.mxu not in ("highest", "high", "split4"):
            raise ValueError(f"unsupported mxu mode {self.mxu!r}; "
                             f"pick 'highest', 'high' or 'split4'")

    def resolve(self) -> "Precision":
        """Downgrade float64 requests to float32 when x64 is disabled.

        The "float32x2" extended tier needs no x64 — it is built from
        plain float32 pairs — so it survives resolution on every backend;
        its underlying array dtype is float32 (fd_dtype).
        """
        if jax.config.jax_enable_x64:
            return self
        td = "float32" if self.td == "float64" else self.td
        fd = "float32" if self.fd == "float64" else self.fd
        if (td, fd) == (self.td, self.fd):
            return self
        return Precision(td=td, fd=fd, mxu=self.mxu)

    @property
    def extended(self) -> bool:
        """True for the double-word FD tier (fd="float32x2")."""
        return self.fd == "float32x2"

    @property
    def mxu_precision(self):
        """lax.Precision for f32 contractions (f64 dots ignore it).

        "split4" maps to HIGHEST here: only the collapsed round trip
        implements the 4-pass split-operand scheme; every other contraction
        (hopped analysis, sharded programs, refresh) falls back to exact
        f32 rather than silently degrading to the "high" class.
        """
        from jax import lax

        return (lax.Precision.HIGH if self.mxu == "high"
                else lax.Precision.HIGHEST)

    # dtype accessors (resolved against the runtime x64 flag)
    @property
    def td_dtype(self) -> np.dtype:
        return jnp.dtype(self.resolve().td)

    @property
    def fd_dtype(self) -> np.dtype:
        fd = self.resolve().fd
        return jnp.dtype("float32" if fd == "float32x2" else fd)

    @property
    def fdx_dtype(self) -> np.dtype:
        return jnp.dtype(_complex_of(self.resolve().fd))


#: Reference-parity default: float TD, double FD (c/src/sdft/sdft.h:101-118).
DEFAULT_PRECISION = Precision(td="float32", fd="float64")

#: Fast path: everything in float32 / complex64.
FAST_PRECISION = Precision(td="float32", fd="float32")
