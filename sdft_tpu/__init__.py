"""sdft_tpu — a sliding-DFT framework in JAX for NVIDIA GPUs.

A from-scratch JAX/XLA/Pallas implementation of the modulated Sliding
Discrete Fourier Transform (Duda 2010; Bradford/Dobson/ffitch 2005) with the
full capability surface of the reference library jurihock/sdft: forward
analysis, inverse synthesis with latency control, Boxcar/Hann/Hamming/
Blackman frequency-domain windowing, configurable TD/FD precision, endless
bounded-memory streaming, and multi-chip sharding over bins/time/channels.
"""

from .api import (isdft, isdft_interleaved, refresh, roundtrip,
                  roundtrip_hopped, sdft, sdft_interleaved,
                  sdft_hopped, sdft_power)
from .compat import SDFT, STFT
from .config import DEFAULT_PRECISION, FAST_PRECISION, Precision
from .cplx import from_complex, to_complex
from .metrics import roundtrip_snr_db, snr_db
from .ops.twofloat import df_to_float64
from .plan import Plan
from .state import State, init_state, reset_state, state_from_arrays, state_to_arrays
from .stream import Streamer, iter_blocks
from .windows import Window

__version__ = "0.1.0"

__all__ = [
    "Plan",
    "State",
    "Window",
    "SDFT",
    "STFT",
    "Streamer",
    "iter_blocks",
    "Precision",
    "DEFAULT_PRECISION",
    "FAST_PRECISION",
    "sdft",
    "sdft_hopped",
    "sdft_interleaved",
    "sdft_power",
    "isdft",
    "isdft_interleaved",
    "refresh",
    "roundtrip",
    "roundtrip_hopped",
    "to_complex",
    "from_complex",
    "snr_db",
    "roundtrip_snr_db",
    "df_to_float64",
    "init_state",
    "reset_state",
    "state_to_arrays",
    "state_from_arrays",
    "__version__",
]
