"""Reference-protocol CLI driver.

Mirrors the reference test drivers' 7-positional-argument protocol
(test/test.c:41-47, test/test.py:16-22):

    python -m sdft_tpu <dftsize> <hopsize> <window> <latency> <src.wav> <out.wav> <out.dft>

Reads the source WAV (mean-mixed to mono), truncates to whole hops, round
trips each hop through sdft/isdft carrying state, writes the synthesized WAV
and dumps the first DFT vector of every hop as raw complex128 — byte-for-byte
the comparator format of test/main.py:46-49.

Extra optional flags (after the 7 positionals):
  --fd32        use float32 frequency-domain math (the fast path)
  --block N     process N-sample blocks internally instead of per-hop calls
                (identical output by chunking invariance; much faster)
  --mesh CxTxB  run the driver over a (channel, time, bins) device mesh
                (sdft_tpu.parallel.sharded_roundtrip_hopped: ONE fused
                sharded program per segment — hop spectra + synthesis from
                a shared comb/totals pass, blocks chained in a lax.scan) —
                C must be 1 (the driver is mono), T*B <= device count.
                Blocks default to tile*T rounded up to >= 16000 samples
                (same output as the single-device path by shard-count and
                chunking invariance).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .config import Precision
from .cplx import to_complex
from .io.dump import dump_complex
from .io.wav import read_wav, write_wav
from .plan import Plan
from .state import init_state
from .api import roundtrip, roundtrip_hopped, sdft_hopped

#: Cap on hop-DFT bytes staged per dispatch (the fetch is chunked anyway;
#: this bounds device memory for hours-long streams, not test.wav).
_SUPER_DFT_BYTES = 256 << 20


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 7:
        print(__doc__)
        return 1

    dftsize = int(argv[0])
    hopsize = int(argv[1])
    window = argv[2]
    latency = float(argv[3])
    srcfile, wavfile, dftfile = argv[4:7]
    extras = argv[7:]
    fd = "float32" if "--fd32" in extras else "float64"
    import jax

    from .runtime import setup_compile_cache

    setup_compile_cache()
    if fd == "float64":
        # the f64 parity mode needs the x64 flag or the dtypes silently
        # resolve to f32 (Precision resolves against the runtime flag) —
        # without it a run drifts at the f32 class and different --block
        # sizes differ at ~1e-7 instead of ~1e-13.  The CPU and the GPU
        # both compute in f64.
        jax.config.update("jax_enable_x64", True)
    mesh = None
    nt_mesh = 1
    if "--mesh" in extras:
        from .parallel import make_mesh

        spec = extras[extras.index("--mesh") + 1]
        try:
            nc, ntm, nb = (int(p) for p in spec.lower().split("x"))
        except ValueError:
            raise SystemExit(f"--mesh expects CxTxB (e.g. 1x4x2), got {spec!r}")
        if nc != 1:
            raise SystemExit("--mesh channel axis must be 1 (mono driver)")
        mesh = make_mesh(nc, ntm, nb)
        nt_mesh = ntm

    # default block: >= 16k samples per chained step — part of the fused
    # driver body's per-step cost is fixed, so hop-sized blocks waste
    # throughput (the 16000 default was tuned on the previous accelerator;
    # re-tuning for the GPU is open work).  Degenerate hops (< 8) run
    # hop*sub multi-hop tiles (ops.lti).
    from .ops.lti import driver_sub_factor

    tile = hopsize * driver_sub_factor(hopsize)
    unit = tile * nt_mesh
    block = unit * max(1, -(-16000 // unit))
    if "--block" in extras:
        block = int(extras[extras.index("--block") + 1])
    if block % hopsize:
        raise SystemExit(f"--block {block} must be a multiple of hopsize {hopsize}")
    if mesh is not None and block % unit:
        raise SystemExit(f"--block {block} must be a multiple of "
                         f"tile*T = {unit} under --mesh")

    precision = Precision(td="float32" if fd == "float32" else "float64", fd=fd)
    plan = Plan(dftsize, window=window, latency=latency, precision=precision)

    x, sr = read_wav(srcfile)
    dev = jax.devices()[0]
    print(f"{dev.platform}:{dev.device_kind}\t{srcfile} {x.size} {sr}")
    size = (x.size // hopsize) * hopsize
    x = x[:size]

    ys = []
    hop_dfts = []
    # segment cap shared by both branches: <= 32 chained blocks per
    # compiled program AND <= _SUPER_DFT_BYTES of staged hop-DFT output
    # per dispatch (degenerate hops emit a spectrum per few samples, so
    # uncapped segments could stage multi-GB outputs)
    bin_bytes = 8 if fd == "float32" else 16  # packed re/im pair
    bytes_per_block = max(1, (block // hopsize) * dftsize * bin_bytes)
    nb_cap = int(min(32, max(1, _SUPER_DFT_BYTES // bytes_per_block)))
    t0 = time.perf_counter()
    if mesh is not None:
        # ONE fused sharded program per segment (a lax.scan of fused
        # driver blocks inside one shard_map): hop spectra AND synthesis
        # share the comb/delta and totals passes — the sharded counterpart
        # of the single-device segment path below
        from .parallel import sharded_roundtrip_hopped

        state = init_state(plan, channels=1)
        progress = 0
        mesh_size = (size // block) * block  # whole sharded blocks
        nb = min(nb_cap, max(1, mesh_size // block))
        seg = nb * block
        for i in range(0, mesh_size, seg):
            chunk = x[i:i + seg]
            nb_i = chunk.size // block
            xs = chunk[:nb_i * block].reshape(nb_i, 1, block)
            state, hd, yy = sharded_roundtrip_hopped(plan, mesh, state, xs,
                                                     hopsize)
            ys.append(np.asarray(yy).reshape(-1))
            hop_dfts.append(
                to_complex(np.asarray(hd).reshape(-1, dftsize, 2)))
            percent = min(i + seg, mesh_size) / size
            if int(percent * 10) != progress:
                progress = int(percent * 10)
                print(f"{progress * 10}%")
        # the trailing partial sharded block runs on the single-device path
        # with the same carried state (chunking invariance) — mesh output is
        # never shorter than the single-device output for the same WAV
        if mesh_size < size:
            tail = x[mesh_size:]
            _, hdfts = sdft_hopped(plan, state, tail[None], hopsize)
            state, y = roundtrip(plan, state, tail[None])
            ys.append(np.asarray(y[0]))
            hop_dfts.append(to_complex(np.asarray(hdfts[0])))
        if progress < 10:
            # reference drivers print through 100% (test/test.c:67-77); the
            # trailing partial block handled above completes the stream
            print("100%")
    else:
        # Single-device fast path: chain NB blocks per compiled program
        # (api.roundtrip_hopped) — one dispatch + one fetch per segment
        # instead of two programs and a host round trip per block (the
        # reference's per-hop call shape, test/test.c:69-83).  The stream is
        # zero-padded to whole (NB, block) segments so every dispatch reuses
        # ONE compiled program (segments hold at most 32 scan steps to keep
        # the first compilation short); the padding only influences carry
        # state past the end of the stream, and outputs are truncated back
        # to the true size below.
        state = init_state(plan)
        # cap segments by the actual stream too: short WAVs must not be
        # zero-padded to a full 32-block segment of wasted compute
        nb = min(nb_cap, max(1, -(-size // block)))
        seg = nb * block
        padded = -(-size // seg) * seg
        xp = np.zeros(padded, x.dtype)
        xp[:size] = x
        for i in range(0, padded, seg):
            xs = xp[i:i + seg].reshape(nb, block)
            state, hd, yy = roundtrip_hopped(plan, state, xs, hopsize)
            ys.append(np.asarray(yy).reshape(-1))
            hop_dfts.append(
                to_complex(np.asarray(hd).reshape(-1, dftsize, 2)))
            print(f"{min(i + seg, size) * 100 // size}%")
    elapsed = time.perf_counter() - t0

    y = np.concatenate(ys).astype(np.float64)[:size]
    dfts_out = np.concatenate(hop_dfts)[:size // hopsize]
    write_wav(wavfile, y, sr)
    dump_complex(dftfile, dfts_out)
    print(f"{size} samples in {elapsed:.3f}s = {size / elapsed:,.0f} samples/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
