"""Packed-complex boundary layout.

The framework keeps complex values out of jit/program boundaries (complex
*inside* a compiled program is fine — XLA decomposes it): every boundary
uses a packed layout, a real array with a trailing axis of size 2 holding
(real, imag), in the plan's FD real dtype.  This was first forced by an
accelerator runtime that could not transfer complex buffers; it stays as
the one boundary layout every backend handles.  The Pallas kernel uses the
same convention (Pallas has no complex dtypes at all).

Helpers here convert between the packed layout and complex arrays, on device
(inside jit) and on host (numpy).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack(z: jax.Array) -> jax.Array:
    """complex (...,) -> packed (..., 2).  Use inside jit only."""
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)


def unpack(p: jax.Array) -> jax.Array:
    """packed (..., 2) -> complex (...).  Use inside jit only."""
    return jax.lax.complex(p[..., 0], p[..., 1])


def to_complex(p) -> np.ndarray:
    """Host-side: packed array (device or numpy) -> numpy complex array."""
    p = np.asarray(p)
    if p.shape[-1] != 2:
        raise ValueError(f"packed layout needs trailing axis 2, got {p.shape}")
    return p[..., 0] + 1j * p[..., 1]


def planar_to_complex(re, im) -> np.ndarray:
    """Host-side: planar (re, im) pair (device or numpy) -> numpy complex."""
    return np.asarray(re) + 1j * np.asarray(im)


def from_complex(z, dtype=None) -> np.ndarray:
    """Host-side: complex numpy array -> packed numpy array."""
    z = np.asarray(z)
    if not np.iscomplexobj(z):
        z = z.astype(np.complex128)
    real_dtype = dtype or (np.float32 if z.dtype == np.complex64 else np.float64)
    return np.stack([z.real, z.imag], axis=-1).astype(real_dtype)
