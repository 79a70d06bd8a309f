"""Inverse SDFT synthesis.

Per output sample the reference reduces over bins
(c/src/sdft/sdft.h:635-657):

  latency == 1 : y = 2 * sum_i Re(dft[i]) * (-1)^i
  latency <  1 : y = 2 * sum_i Re(dft[i] * polar(w, omega*i*m*latency)),
                 w = 2 / (1 - cos(omega*m*latency))

For a block this is a single (M, m) @ (m,) contraction.  We split the
complex product into real matvecs: Re(dft * t) = Re(dft)*Re(t) - Im(dft)*Im(t).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..plan import Plan
from .twiddle import synthesis_twiddles


def isdft_block(plan: Plan, dfts: jnp.ndarray) -> jnp.ndarray:
    """Synthesize samples from a block of spectra.

    Args:
      plan: static SDFT plan.
      dfts: (..., M, m, 2) packed-complex DFT matrix (sdft_tpu.cplx layout).

    Returns:
      (..., M) real samples in TD precision (cast at the end like
      c/src/sdft/sdft.h:656).
    """
    fd = plan.precision.fd_dtype
    tw = synthesis_twiddles(plan)  # (m,) complex, constant-folded by XLA
    re = dfts[..., 0].astype(fd)
    # an f32 contraction without a precision may run in TF32 on the GPU
    hi = plan.precision.mxu_precision
    if plan.latency == 1.0:
        # Purely real alternating-sign reduction (c/src/sdft/sdft.h:639-645).
        y = jnp.einsum("...sm,m->...s", re, jnp.real(tw), precision=hi,
                       preferred_element_type=fd)
    else:
        im = dfts[..., 1].astype(fd)
        y = jnp.einsum("...sm,m->...s", re, jnp.real(tw), precision=hi,
                       preferred_element_type=fd)
        y = y - jnp.einsum("...sm,m->...s", im, jnp.imag(tw), precision=hi,
                           preferred_element_type=fd)
    y = y * jnp.asarray(plan.synthesis_weight, fd)
    return y.astype(plan.precision.td_dtype)
