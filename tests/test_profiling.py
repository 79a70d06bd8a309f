"""Profiling subsystem tests (cost model + marginal timing harness)."""

import jax
import jax.numpy as jnp
import numpy as np

from sdft_tpu import FAST_PRECISION, Plan
from sdft_tpu.profiling import (analysis_cost, benchmark, benchmark_marginal,
                                roundtrip_cost, synthesis_cost)


def test_cost_model_scales_linearly():
    plan = Plan(256, window="hann", precision=FAST_PRECISION)
    a1 = analysis_cost(plan, 1024)
    a2 = analysis_cost(plan, 2048)
    assert a2.flops == 2 * a1.flops
    assert a1.intensity > 0

    # boxcar has no halo taps -> strictly fewer flops than blackman
    fb = analysis_cost(Plan(256, window="boxcar"), 1024).flops
    bl = analysis_cost(Plan(256, window="blackman"), 1024).flops
    assert fb < bl

    # reduced latency synthesis does the full complex product
    s1 = synthesis_cost(Plan(256, latency=1.0), 1024)
    s2 = synthesis_cost(Plan(256, latency=0.5), 1024)
    assert s2.flops == 2 * s1.flops

    # fused roundtrip never writes spectra to HBM
    rt = roundtrip_cost(plan, 1024)
    assert rt.hbm_bytes < analysis_cost(plan, 1024).hbm_bytes


def test_benchmark_and_marginal_smoke():
    def step(state, x):
        state = state + jnp.sum(x)
        return state, x * 2.0

    import jax
    jit_step = jax.jit(step)
    res = benchmark(jit_step, (jnp.float32(0.0), jnp.ones((8,), jnp.float32)),
                    iters=2, warmup=1)
    assert res["seconds"] > 0

    xs = jnp.asarray(np.ones((12, 8), np.float32))
    res = benchmark_marginal(step, jnp.float32(0.0), xs, k_lo=2, k_hi=6,
                             repeats=1)
    assert "seconds" in res and np.isfinite(res["seconds"])


def test_bench_mesh_cli_smoke(capsys):
    """bench --mesh is a measurement: without a GPU it exits before timing
    anything and prints no result line (no CPU number under a device
    metric)."""
    import pytest

    from sdft_tpu.profiling import bench_cli

    with pytest.raises(SystemExit, match="needs a GPU"):
        bench_cli(["64", "1024", "1", "--mesh", "1x4x2"])
    with pytest.raises(SystemExit, match="needs a GPU"):
        bench_cli(["64", "1024", "1"])
    assert "{" not in capsys.readouterr().out


class _Dev:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


def test_device_peaks_table():
    """Peaks come from one table keyed by device_kind: the H100 is found,
    a GPU of unknown kind raises, the CPU has no peak."""
    import pytest

    from sdft_tpu.profiling import device_peaks

    bf16, f32, bw = device_peaks(_Dev("gpu", "NVIDIA H100 80GB HBM3"))
    assert (bf16, f32, bw) == (989e12, 67e12, 3.35e12)
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(_Dev("gpu", "NVIDIA Imaginary 1"))
    assert device_peaks(_Dev("cpu", "cpu")) == (None, None, None)
    assert device_peaks() == (None, None, None)   # this tier's CPU


def test_device_record_and_roofline_keys():
    """Every measurement names its device; on the CPU no roofline share is
    reported."""
    from sdft_tpu.profiling import OpCost, _add_roofline, device_record

    rec = device_record()
    assert rec["platform"] == "cpu" and rec["count"] == len(jax.devices())
    out = {}
    _add_roofline(out, OpCost(flops=10, hbm_bytes=10), 1.0)
    assert "hbm_roofline_fraction" not in out
    assert "f32_flops_fraction" not in out
