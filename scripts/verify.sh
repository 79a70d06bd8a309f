#!/usr/bin/env bash
# End-to-end verification orchestrator — the analogue of the reference's
# test/main.sh:3-23 (build, run every implementation on the golden WAV with
# DFTSIZE/HOPSIZE/WINDOW/LATENCY, then cross-compare).  Here the
# implementations are (a) the JAX/Pallas framework via the 7-arg CLI driver
# protocol and (b) the native C++ oracle engine; scripts/crosscheck.py runs
# both, asserts the reference tolerances, and checks against the FFT STFT.
set -euo pipefail
cd "$(dirname "$0")/.."

DFTSIZE="${DFTSIZE:-1000}"
HOPSIZE="${HOPSIZE:-100}"
WINDOW="${WINDOW:-hann}"
LATENCY="${LATENCY:-1}"
WAV="${WAV:-/root/reference/test/test.wav}"
PLOT="${PLOT:-}"

echo "== build native oracle =="
make -C sdft_tpu/native

echo "== unit + parity tests =="
python -m pytest tests/ -x -q -m "not gpu"

echo "== cross-implementation check ($DFTSIZE $HOPSIZE $WINDOW $LATENCY) =="
python scripts/crosscheck.py "$DFTSIZE" "$HOPSIZE" "$WINDOW" "$LATENCY" "$WAV" $PLOT

# On-card tier: when a GPU is attached, run the f32 parity gates, the
# on-card crosscheck (f64 parity mode and the f32 fast path) and the smoke
# test on the card.  Skip with SKIP_GPU=1.
if [ "${SKIP_GPU:-0}" != "1" ] && python -c 'import sys, jax; sys.exit(0 if jax.default_backend() == "gpu" else 1)' 2>/dev/null
then
  echo "== on-GPU parity gates =="
  SDFT_TEST_GPU=1 python -m pytest tests/test_gpu.py -q
  echo "== on-GPU crosscheck ($DFTSIZE $HOPSIZE $WINDOW $LATENCY, f64) =="
  SDFT_CROSSCHECK_BACKEND=gpu python scripts/crosscheck.py \
      "$DFTSIZE" "$HOPSIZE" "$WINDOW" "$LATENCY" "$WAV"
  for M in 512 1000 4096; do
    echo "== on-GPU crosscheck ($M $HOPSIZE $WINDOW $LATENCY, f32) =="
    SDFT_CROSSCHECK_BACKEND=gpu SDFT_CROSSCHECK_FD=32 \
        python scripts/crosscheck.py "$M" "$HOPSIZE" "$WINDOW" "$LATENCY" "$WAV"
  done
  echo "== smoke test on the card =="
  python chip_smoke.py
else
  echo "== no GPU attached; skipping the on-card tier =="
fi

echo "== examples =="
python examples/latency.py
python examples/stft_window_test.py
python examples/transform.py
python examples/streaming.py
python examples/precision.py

echo "verify OK"
