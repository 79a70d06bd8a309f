"""Profiling, tracing and roofline accounting.

The reference has no profiling subsystem — its closest artifacts are the
wall-clock microsecond prints of the bench drivers (reference:
cpp/examples/bench.cpp:38-48) and progress percentages in the test drivers
(test/test.c:67-77).  Here it is three pieces:

  * :func:`trace` — context manager around ``jax.profiler.trace`` producing
    TensorBoard/XProf traces of the compiled programs;
  * :class:`OpCost` / :func:`analysis_cost` — analytic FLOP and HBM-byte
    accounting of the blockwise SDFT ops, the inputs to a roofline model;
  * :func:`benchmark` — honest wall-clock timing of a jitted step with
    device synchronization, reporting achieved FLOP/s and HBM bandwidth
    against the chip's peak where known.

Run it from the CLI:  ``python -m sdft_tpu bench [m] [block] [runs]``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import jax
import numpy as np

from .plan import Plan
from .windows import WINDOW_HALO

__all__ = ["trace", "OpCost", "analysis_cost", "synthesis_cost",
           "roundtrip_cost", "benchmark", "benchmark_marginal",
           "device_peaks", "device_record", "require_gpu"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture an XProf/TensorBoard trace of everything run in the block.

    View with ``tensorboard --logdir <logdir>`` (Profile tab) or xprof.
    """
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass(frozen=True)
class OpCost:
    """Analytic cost of one op invocation (per channel)."""

    flops: int          # real FLOPs (adds + muls)
    hbm_bytes: int      # unavoidable HBM traffic (inputs + outputs + state)

    @property
    def intensity(self) -> float:
        """Arithmetic intensity in FLOP/byte — the roofline x-axis."""
        return self.flops / max(self.hbm_bytes, 1)


def _itemsize(plan: Plan) -> int:
    return np.dtype(plan.precision.fd_dtype).itemsize


def analysis_cost(plan: Plan, n_samples: int, emit_dfts: bool = True) -> OpCost:
    """FLOPs/bytes of the forward blockwise analysis (SURVEY.md §0.3).

    Per (sample, bin): rotate delta into the bin frame (2 mul), prefix-sum
    (2 add), carry add (2), demodulate (6: complex multiply), and the
    window convolution — ``2*(1 + 2*halo)`` multiplies plus ``2*2*halo``
    adds plus the normalization.
    """
    m, halo = plan.dftsize, WINDOW_HALO[plan.window]
    per_bin = 2 + 2 + 2 + 6 + 2 * (1 + 2 * halo) + 4 * halo + 2
    flops = n_samples * m * per_bin
    fd = _itemsize(plan)
    td = np.dtype(plan.precision.td_dtype).itemsize
    state_bytes = (2 * m * td) + (m * 2 * fd)       # delayline + accumulator
    bytes_ = n_samples * td + 2 * state_bytes
    if emit_dfts:
        bytes_ += n_samples * m * 2 * fd
    return OpCost(flops=flops, hbm_bytes=bytes_)


def synthesis_cost(plan: Plan, n_samples: int, read_dfts: bool = True) -> OpCost:
    """FLOPs/bytes of the inverse bin-sum (c/src/sdft/sdft.h:635-657)."""
    m = plan.dftsize
    per_bin = 2 if plan.latency == 1.0 else 4
    flops = n_samples * m * per_bin
    fd = _itemsize(plan)
    td = np.dtype(plan.precision.td_dtype).itemsize
    bytes_ = n_samples * td + (n_samples * m * 2 * fd if read_dfts else 0)
    return OpCost(flops=flops, hbm_bytes=bytes_)


def roundtrip_cost(plan: Plan, n_samples: int) -> OpCost:
    """Fused analysis+synthesis: spectra never touch HBM (the Pallas path)."""
    a = analysis_cost(plan, n_samples, emit_dfts=False)
    s = synthesis_cost(plan, n_samples, read_dfts=False)
    return OpCost(flops=a.flops + s.flops, hbm_bytes=a.hbm_bytes + s.hbm_bytes)


#: Published peaks by ``device_kind``: (bf16 tensor-core FLOP/s, f32 FLOP/s
#: without tensor cores, device-memory byte/s).  Source: NVIDIA H100 data
#: sheet, SXM part, dense rates without sparsity, at the full 700 W limit.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12),
}


def device_peaks(device=None):
    """(bf16_flops, f32_flops, bytes_per_s) of the device, from _PEAKS.

    The CPU has no peak here: (None, None, None), and no roofline share is
    reported.  A GPU whose ``device_kind`` is not in the table is an error,
    not a default."""
    device = device or jax.devices()[0]
    if device.platform == "cpu":
        return None, None, None
    try:
        return _PEAKS[device.device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device.device_kind!r}; "
            "add them to sdft_tpu.profiling._PEAKS with their source"
        ) from None


def device_record() -> dict:
    """What every measurement row records about the machine it ran on."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """device_record() of a GPU; exits (SystemExit) on any other backend:
    a measurement that finds no card fails rather than timing the CPU."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(f"this measurement needs a GPU; JAX found "
                         f"{rec['platform']} ({rec['kind']})")
    return rec


def benchmark(fn, args, *, iters: int = 5, warmup: int = 2,
              cost: OpCost | None = None):
    """Time ``fn(*args)`` with device sync; returns a result dict.

    ``fn`` should be jitted; the first (warmup) calls absorb compilation.
    When ``cost`` is given, achieved FLOP/s, HBM GB/s and the roofline
    bound are included.

    For sub-millisecond steps, per-call dispatch is a large share of the
    time: use :func:`benchmark_marginal`, which amortizes dispatch by
    chaining steps inside one compiled program.
    """
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    best = min(times)
    out = {"seconds": best, "median_seconds": float(np.median(times))}
    if cost is not None:
        _add_roofline(out, cost, best)
    return out


def _add_roofline(out, cost, seconds):
    out["flops_per_s"] = cost.flops / seconds
    out["hbm_gb_per_s"] = cost.hbm_bytes / seconds / 1e9
    out["intensity_flop_per_byte"] = cost.intensity
    _, peak_f32, peak_bw = device_peaks()
    if peak_bw:
        out["hbm_roofline_fraction"] = (cost.hbm_bytes / seconds) / peak_bw
    if peak_f32:
        # the cost model counts f32 elementwise work
        out["f32_flops_fraction"] = (cost.flops / seconds) / peak_f32


def benchmark_marginal(step, state, xs, *, k_lo: int = 4, k_hi: int = 12,
                       repeats: int = 3, cost: OpCost | None = None):
    """Marginal per-step cost of a state-threading step function.

    Compiles ``lax.scan`` chains of ``k_lo`` and ``k_hi`` sequential steps
    (state threaded, outputs reduced through a nonlinear scalar fetched to
    host — a hard barrier XLA cannot reassociate away), and reports
    ``(t(k_hi) - t(k_lo)) / (k_hi - k_lo)``: fixed dispatch latency
    cancels out.  ``step(state, x) -> (state, y)``; ``xs`` has a leading
    axis of at least ``k_hi``.
    """
    import functools

    import jax.numpy as jnp
    from jax import lax

    @functools.partial(jax.jit, static_argnums=2)
    def many(state, xs, k):
        def body(st, x):
            st, y = step(st, x)
            return st, jnp.sum(y * y)
        _, ys = lax.scan(body, state, xs[:k])
        return jnp.sum(ys)

    def timed(k):
        float(many(state, xs, k))  # compile + warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(many(state, xs, k))
            best = min(best, time.perf_counter() - t0)
        return best

    t_lo, t_hi = timed(k_lo), timed(k_hi)
    per_step = (t_hi - t_lo) / (k_hi - k_lo)
    out = {"chain_lo_seconds": t_lo, "chain_hi_seconds": t_hi}
    if per_step <= 0:
        # Noise swamped the marginal (tiny problems on a loaded host can
        # time the long chain faster than the short one).  Fall back to the
        # amortized per-step cost of the long chain — a valid upper bound
        # that keeps derived throughputs finite and positive.
        per_step = t_hi / k_hi
        out["marginal_noise_floor"] = True
    out["seconds"] = per_step
    if cost is not None:
        _add_roofline(out, cost, per_step)
    return out


def measure_scaling_proxy(m: int = 1000, block: int = 65536,
                          timeout_s: float = 300.0) -> dict | None:
    """CPU 2-process strong-scaling proxy: spawn a
    real 2-process jax.distributed (Gloo) cluster, one CPU device per
    process, time the chained sharded round trip over a (1, 2, 1) mesh on
    the SAME global block a 1-process/1-device run times unsharded, and
    return the measured strong-scaling efficiency t1 / (2 * t2).

    Runs in subprocesses with JAX_PLATFORMS=cpu, so it is safe to call
    from a process that holds the GPU (bench.py).  Returns None on failure
    (missing toolchain, port clash, timeout) rather than raising — the
    proxy is an auxiliary datapoint, not a gate.
    """
    import json
    import os
    import pathlib
    import socket
    import subprocess
    import sys
    import tempfile

    worker = (pathlib.Path(__file__).resolve().parent.parent
              / "scripts" / "scaling_worker.py")
    if not worker.exists():
        return None
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    # pin every "host" to a disjoint core set of equal size, with the
    # single-process baseline on one of them — otherwise the two XLA
    # runtimes oversubscribe the machine and the proxy measures thread
    # contention instead of collective overhead
    ncpu = os.cpu_count() or 2
    half = max(1, ncpu // 2)
    pin0 = f"0-{half - 1}" if half > 1 else "0"
    pin1 = (f"{half}-{min(2 * half, ncpu) - 1}"
            if min(2 * half, ncpu) - 1 > half else f"{half}")
    taskset = ["taskset", "-c"]
    try:
        with tempfile.TemporaryDirectory() as td:
            single = pathlib.Path(td) / "single.json"
            p = subprocess.run(
                taskset + [pin0, sys.executable, str(worker), "single",
                           str(single), str(m), str(block)],
                env=env, capture_output=True, text=True, timeout=timeout_s)
            if p.returncode != 0:
                return None
            t1 = json.load(open(single))["seconds"]

            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            procs = [subprocess.Popen(
                taskset + [pin0 if pid == 0 else pin1, sys.executable,
                           str(worker), "pair", str(pid), str(port),
                           td, str(m), str(block)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True) for pid in (0, 1)]
            try:
                for pr in procs:
                    pr.communicate(timeout=timeout_s)
            finally:
                for pr in procs:
                    if pr.poll() is None:
                        pr.kill()
            if any(pr.returncode != 0 for pr in procs):
                return None
            t2 = json.load(open(pathlib.Path(td) / "pair.json"))["seconds"]
    except Exception:
        return None
    return {"m": m, "block": block, "t1_ms": round(t1 * 1e3, 3),
            "t2_ms": round(t2 * 1e3, 3),
            "efficiency": round(t1 / (2 * t2), 4)}


def bench_mesh_cli(argv, mesh_spec: str) -> int:
    """``python -m sdft_tpu bench --mesh CxTxB [m] [block] [runs]`` —
    sharded round-trip throughput and strong-scaling efficiency vs one
    device (the §3.5 bench protocol generalized to a mesh; BASELINE.md
    scaling target).  Needs GPUs (exits without one).  Prints one JSON
    line that records the platform, device kind and count.
    """
    import json

    import jax.numpy as jnp

    from .config import FAST_PRECISION
    from .state import init_state
    from .ops.lti import roundtrip_block_lti
    from .parallel import make_mesh, sharded_roundtrip

    try:
        nc, nt, nb = (int(p) for p in mesh_spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects CxTxB (e.g. 1x4x2), got {mesh_spec!r}")

    m = int(argv[0]) if len(argv) > 0 else 4096
    # default block: big enough that every time shard holds >= 2m samples
    # (one-neighbor comb exchange) and the marginal dominates dispatch
    block = int(argv[1]) if len(argv) > 1 else max(16384, 2 * 2 * m * nt)
    runs = int(argv[2]) if len(argv) > 2 else 3

    rec = require_gpu()
    ndev = nc * nt * nb
    mesh = make_mesh(nc, nt, nb)
    plan = Plan(m, window="hann", precision=FAST_PRECISION)
    C = max(nc, 1)
    state = init_state(plan, channels=C)
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.standard_normal((12, C, block)),
                     plan.precision.td_dtype)
    print(f"device: {rec['kind']} ({rec['platform']}) x {rec['count']}; "
          f"mesh channel={nc} time={nt} bins={nb}")

    res = benchmark_marginal(
        lambda st, x: sharded_roundtrip(plan, mesh, st, x),
        state, xs, repeats=runs)
    t_mesh = res["seconds"]
    rate = C * block / t_mesh
    print(f"sharded roundtrip m={m} block={block} C={C}: "
          f"{t_mesh * 1e3:.3f} ms/block marginal -> {rate:,.0f} samples/s "
          f"({rate / ndev:,.0f} per device)")

    # strong-scaling baseline: the same global block on ONE device
    res1 = benchmark_marginal(
        lambda st, x: roundtrip_block_lti(plan, st, x),
        state, xs, repeats=runs)
    t_one = res1["seconds"]
    speedup = t_one / t_mesh
    eff = speedup / ndev
    print(f"single-device: {t_one * 1e3:.3f} ms/block -> "
          f"speedup {speedup:.2f}x on {ndev} devices, "
          f"scaling efficiency {eff:.1%}")
    print(json.dumps({
        "metric": f"sharded_roundtrip_samples_per_s_m{m}",
        "value": round(rate, 1),
        "unit": "samples/s",
        "mesh": {"channel": nc, "time": nt, "bins": nb},
        "per_device_samples_per_s": round(rate / ndev, 1),
        "scaling_efficiency_vs_1dev": round(eff, 4),
        "device": rec,
    }))
    return 0


def bench_cli(argv) -> int:
    """``python -m sdft_tpu bench [m] [block] [runs]`` — the collapsed round
    trip and the per-sample spectra (api.sdft: the kernel on the GPU) with
    roofline accounting (the §3.5 bench protocol, m=4096 default).  Needs a
    GPU (exits without one).  With ``--mesh CxTxB`` runs the sharded
    scaling bench instead."""
    import json

    import jax.numpy as jnp

    from .api import sdft
    from .config import FAST_PRECISION
    from .state import init_state
    from .ops.lti import roundtrip_block_lti

    argv = list(argv)
    if "--mesh" in argv:
        i = argv.index("--mesh")
        mesh_spec = argv[i + 1]
        del argv[i:i + 2]
        return bench_mesh_cli(argv, mesh_spec)

    m = int(argv[0]) if len(argv) > 0 else 4096
    block = int(argv[1]) if len(argv) > 1 else 16384
    runs = int(argv[2]) if len(argv) > 2 else 3

    rec = require_gpu()
    plan = Plan(m, window="hann", precision=FAST_PRECISION)
    state = init_state(plan)
    xs = jnp.asarray(np.random.default_rng(0).standard_normal((12, block)),
                     plan.precision.td_dtype)
    print(f"device: {rec['kind']} ({rec['platform']}) x {rec['count']}")

    # collapsed LTI round trip (the production no-transform path)
    res = benchmark_marginal(lambda st, x: roundtrip_block_lti(plan, st, x),
                             state, xs, repeats=runs)
    rt_rate = block / res["seconds"]
    print(f"roundtrip LTI    m={m} block={block}: "
          f"{res['seconds'] * 1e3:.3f} ms/block marginal "
          f"-> {rt_rate:,.0f} samples/s")

    # per-sample spectra with roofline accounting (the spectra write)
    def step(state, x):
        st, (re, im) = sdft(plan, state, x, layout="planar")
        return st, re[:, 0] + im[:, 0]

    cost = analysis_cost(plan, block)
    res = benchmark_marginal(step, state, xs, repeats=runs, cost=cost)
    sp_rate = block / res["seconds"]
    print(f"spectra (planar) m={m} block={block}: "
          f"{res['seconds'] * 1e3:.3f} ms/block marginal "
          f"-> {sp_rate:,.0f} samples/s")
    print(f"achieved: {res['flops_per_s'] / 1e12:.3f} TFLOP/s (f32), "
          f"{res['hbm_gb_per_s']:.1f} GB/s "
          f"(intensity {res['intensity_flop_per_byte']:.1f} FLOP/B)")
    if "hbm_roofline_fraction" in res:
        print(f"memory roofline fraction: {res['hbm_roofline_fraction']:.1%}")
    print(json.dumps({
        "roundtrip_samples_per_s": round(rt_rate, 1),
        "spectra_samples_per_s": round(sp_rate, 1),
        "m": m, "block": block, "device": rec,
    }))
    return 0
