#!/usr/bin/env python3
"""Smoke test of sdft_tpu on an NVIDIA GPU, against the native f64 oracle.

    python chip_smoke.py           # one GPU: every single-device phase
    python chip_smoke.py --multi   # four GPUs: the sharded phase only

Drives the system's main paths once, through the entry points a user calls,
at real sizes, with inputs made from a seed:

  * cli: the reference driver protocol (sdft_tpu.cli.main) at m=1000, hop
    100, Hann, latency 1 on an 8 s, 44.1 kHz, 24-bit mono WAV, in the
    default f64 mode and with --fd32;
  * roundtrip: the collapsed round trip (api.roundtrip) at m=4096, f32,
    65536-sample blocks, 1 and 8 channels, chained over 3 blocks;
  * spectra: per-sample spectra at m=4096 on a 32768-sample block through
    api.sdft (packed f32 and planar bf16) and api.sdft_power — the spectra
    kernel — beside the plain XLA composition (ops.analysis.sdft_block);
  * edge: the spectra kernel at the longest block it takes (an 8 GiB
    output) at m=4096 and at the largest m, rows against the oracle;
  * hop1: the hop=1 driver (api.roundtrip_hopped) at m=1000;
  * stream: Streamer.run with a checkpoint and a resume;
  * timing: the spectra kernel against the XLA composition, m=4096 and
    m=1000, median of 7 calls, with each rate's share of the write bound.

Every phase compares with the oracle (sdft_tpu.oracle) against a stated
tolerance.  The last line is one JSON object; it says "ok": true only if
every phase passed.  The script exits non-zero (and prints no result) when
JAX finds no GPU, when a phase exceeds its tolerance, or when one raises.
Scratch files go to .smoke/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

EPS32 = float(np.finfo(np.float32).eps)
#: Published device-memory bandwidth of the H100 SXM (profiling._PEAKS).
WRITE_BW = 3.35e12

# sizes (module constants so a rehearsal can shrink them)
CLI_M, CLI_HOP, CLI_SECONDS, CLI_RATE = 1000, 100, 8, 44100
RT_M, RT_BLOCK, RT_BLOCKS, RT_CHANNELS = 4096, 65536, 3, 8
SP_M, SP_BLOCK = 4096, 32768
H1_M, H1_BLOCK, H1_BLOCKS = 1000, 8000, 4
ST_M, ST_BLOCK, ST_BLOCKS = 4096, 16384, 4
TIME_MS, TIME_BLOCK, TIME_CALLS = (4096, 1000), 32768, 7
MULTI_M, MULTI_BLOCK = 4096, 65536


def log(*a):
    print(*a, flush=True)


def card():
    """name, power.limit of the card, from nvidia-smi in a child process
    (which stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def signal(n, seed, channels=None):
    """Music-like test input from a seed: band-limited noise plus a chirp,
    |x| < 1."""
    rng = np.random.default_rng(seed)
    shape = (n,) if channels is None else (channels, n)
    noise = rng.standard_normal(shape)
    noise = np.convolve(noise.reshape(-1), np.ones(4) / 4, "same").reshape(
        shape)
    t = np.arange(n) / 44100.0
    chirp = 0.3 * np.sin(2 * np.pi * (110 + 400 * t) * t)
    return np.clip(0.25 * noise + chirp, -0.99, 0.99)


class Oracle:
    """The native f64 per-sample engine, fed in chunks so no full
    (n, m) complex128 matrix is ever held: keeps every ``hop``-th spectrum
    and the synthesized samples."""

    def __init__(self, m, window="hann", td_bits=64):
        from sdft_tpu.oracle import NativeSDFT

        self.eng = NativeSDFT(m, window, td_bits=td_bits)

    def run(self, x, hop=1, chunk=8192):
        hops, ys = [], []
        for i in range(0, x.size, chunk):
            d = self.eng.sdft(np.asarray(x[i:i + chunk], np.float64))
            first = (-i) % hop
            hops.append(d[first::hop])
            ys.append(self.eng.isdft(d))
        return np.concatenate(hops), np.concatenate(ys)


def check(name, err, tol, rows):
    ok = bool(np.isfinite(err) and err <= tol)
    rows.append(ok)
    log(f"  {name}: max error {err:.3e} (tolerance {tol:.1e})"
        f"{'' if ok else '  FAIL'}")


def timed_first(fn):
    """(result, seconds of the first call: compilation included)."""
    t0 = time.perf_counter()
    out = fn()
    import jax

    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def median_time(fn, n):
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def f32_bound(x, m, B):
    """The f32 propagation bound of a block of B per-sample spectra:
    eps32 * |acc| * sqrt(B) / (2m), |acc| ~ rms(delta) * sqrt(2m)."""
    delta = x[2 * m:] - x[:-2 * m] if x.size > 2 * m else x
    acc = np.sqrt(np.mean(np.square(delta)) * 2 * m)
    return EPS32 * acc * np.sqrt(B) / (2 * m)


# ---------------------------------------------------------------- phases

def phase_cli(rows):
    """The reference driver protocol through sdft_tpu.cli.main."""
    from sdft_tpu.cli import main as cli_main
    from sdft_tpu.io.dump import load_complex
    from sdft_tpu.io.wav import read_wav, write_wav

    work = ROOT / ".smoke"
    work.mkdir(exist_ok=True)
    src = work / "input.wav"
    write_wav(str(src), signal(CLI_SECONDS * CLI_RATE, 1), CLI_RATE, bits=24)
    x, _ = read_wav(str(src))
    x = x[:(x.size // CLI_HOP) * CLI_HOP]

    for flags, td_bits, tol_d, tol_y in (
            (["--fd32"], 32, None, 1e-5),
            ([], 64, 1e-7, 1e-7)):          # default fd=float64 last: it
        out_wav = work / "out.wav"          # enables x64 for the process
        out_dft = work / "out.dft"
        args = [str(CLI_M), str(CLI_HOP), "hann", "1", str(src),
                str(out_wav), str(out_dft)] + flags
        t0 = time.perf_counter()
        rc = cli_main(args)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise RuntimeError(f"cli.main returned {rc}")
        d_ref, y_ref = Oracle(CLI_M, td_bits=td_bits).run(
            x.astype(np.float32) if td_bits == 32 else x, hop=CLI_HOP)
        got_d = load_complex(str(out_dft), CLI_M)
        got_y, _ = read_wav(str(out_wav))
        label = "fd32" if flags else "fd64"
        log(f"  cli {label}: wall {wall:.2f} s (compilation included)")
        if tol_d is None:                     # f32: the propagation bound
            tol_d = 3 * f32_bound(x, CLI_M, 16000)
        check(f"cli {label} hop DFTs vs oracle",
              float(np.abs(got_d - d_ref).max()), tol_d, rows)
        check(f"cli {label} WAV vs oracle",
              float(np.abs(got_y - y_ref).max()), tol_y, rows)


def phase_roundtrip(rows):
    """Collapsed round trip, 1 and 8 channels, chained over blocks."""
    import jax.numpy as jnp

    from sdft_tpu import FAST_PRECISION, Plan, init_state, roundtrip

    plan = Plan(RT_M, window="hann", precision=FAST_PRECISION)
    n = RT_BLOCK * RT_BLOCKS
    x = signal(n, 2, channels=RT_CHANNELS).astype(np.float32)
    _, y_ref = Oracle(RT_M).run(x[0])

    for C in (1, RT_CHANNELS):
        st = init_state(plan) if C == 1 else init_state(plan, channels=C)
        ys = []
        for b in range(RT_BLOCKS):
            blk = jnp.asarray(x[0] if C == 1 else x)[
                ..., b * RT_BLOCK:(b + 1) * RT_BLOCK]
            (st, y), first = timed_first(lambda: roundtrip(plan, st, blk))
            if b == 0:
                log(f"  roundtrip C={C}: first call {first:.2f} s")
            ys.append(np.asarray(y))
        y = np.concatenate(ys, axis=-1)
        check(f"roundtrip C={C} y (channel 0) vs oracle",
              float(np.abs((y if C == 1 else y[0]) - y_ref).max()), 1e-5,
              rows)
        if C > 1:
            # every channel equals its own single-channel stream
            errs = []
            for c in range(1, C):
                s1 = init_state(plan)
                y1 = []
                for b in range(RT_BLOCKS):
                    s1, yy = roundtrip(plan, s1, jnp.asarray(
                        x[c, b * RT_BLOCK:(b + 1) * RT_BLOCK]))
                    y1.append(np.asarray(yy))
                errs.append(np.abs(y[c] - np.concatenate(y1)).max())
            check(f"roundtrip C={C} channels vs 1-channel streams",
                  float(max(errs)), 1e-5, rows)


def phase_spectra(rows):
    """Per-sample spectra through the kernel, beside the XLA composition."""
    import jax
    import jax.numpy as jnp

    from sdft_tpu import FAST_PRECISION, Plan, init_state, sdft, sdft_power
    from sdft_tpu.api import _sdft_1d
    from sdft_tpu.kernels import use_kernel
    from sdft_tpu.kernels.spectra_triton import DEFAULT_CONFIG, _launch

    plan = Plan(SP_M, window="hann", precision=FAST_PRECISION)
    if not use_kernel(plan, SP_BLOCK):
        raise RuntimeError("api.sdft would not take the spectra kernel")
    x = signal(SP_BLOCK, 3).astype(np.float32)
    xd = jnp.asarray(x)
    st = init_state(plan)

    (_, packed), t_k = timed_first(lambda: sdft(plan, st, xd))
    (_, planar), t_b = timed_first(lambda: sdft(
        plan, st, xd, layout="planar", spectra_dtype="bfloat16"))
    (_, power), t_p = timed_first(lambda: sdft_power(
        plan, st, xd, spectra_dtype="bfloat16"))
    (_, ref), t_x = timed_first(lambda: _sdft_1d(plan, st, xd, "packed",
                                                 None))
    log(f"  first calls (compilation included): kernel packed {t_k:.2f} s, "
        f"planar bf16 {t_b:.2f} s, power bf16 {t_p:.2f} s, "
        f"XLA {t_x:.2f} s")
    ma = _launch.lower(plan, st, xd, "packed", None, False,
                       DEFAULT_CONFIG).compile().memory_analysis()
    log(f"  memory_analysis (spectra step, packed f32): "
        f"argument {ma.argument_size_in_bytes} B, output "
        f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
        f"generated code {ma.generated_code_size_in_bytes} B")

    d_ref, _ = Oracle(SP_M).run(x)
    scale = float(np.abs(d_ref).max())
    packed = np.asarray(packed)
    re, im = (np.asarray(a, np.float32) for a in planar)
    power = np.asarray(power, np.float32)
    ref = np.asarray(ref)
    e_k = e_b = e_p = e_x = e_kx = 0.0
    for i in range(0, SP_BLOCK, 4096):
        sl = slice(i, i + 4096)
        want = d_ref[sl]
        got = packed[sl, :, 0] + 1j * packed[sl, :, 1]
        xla = ref[sl, :, 0] + 1j * ref[sl, :, 1]
        e_k = max(e_k, np.abs(got - want).max())
        e_x = max(e_x, np.abs(xla - want).max())
        e_kx = max(e_kx, np.abs(got - xla).max())
        e_b = max(e_b, np.abs(re[sl] + 1j * im[sl] - want).max())
        e_p = max(e_p, np.abs(power[sl] - np.abs(want) ** 2).max())
    bound = f32_bound(x, SP_M, SP_BLOCK)
    check("spectra kernel packed f32 vs oracle (relative)", e_k / scale,
          3e-6, rows)
    check("spectra kernel vs XLA composition (relative)", e_kx / scale,
          3e-6, rows)
    check("spectra XLA composition f32 vs oracle (absolute)", e_x,
          3 * bound, rows)
    check("spectra kernel planar bf16 vs oracle (relative)", e_b / scale,
          8e-3, rows)
    check("sdft_power bf16 vs oracle (relative to max power)",
          e_p / scale ** 2, 1e-2, rows)
    del packed, planar, power, ref
    jax.clear_caches()


def phase_edge(rows):
    """The spectra kernel at the edge of its dispatch rule: the longest
    block whose output fits its int32 offsets, at m=4096 and at the
    largest m it takes."""
    import jax
    import jax.numpy as jnp

    from sdft_tpu import FAST_PRECISION, Plan, init_state, sdft
    from sdft_tpu.kernels import use_kernel
    from sdft_tpu.kernels.spectra_triton import (MAX_KERNEL_DFTSIZE,
                                                 MAX_OUTPUT_ELEMENTS)
    from sdft_tpu.oracle import NativeSDFT

    # boxcar at the largest m: a block that short fills an eighth of the
    # window, where Hann's stencil cancels to a spectrum far below |acc|
    # and a relative gate would measure that cancellation, not the kernel
    for m, window in ((SP_M, "hann"), (MAX_KERNEL_DFTSIZE, "boxcar")):
        n = MAX_OUTPUT_ELEMENTS // (2 * m)
        plan = Plan(m, window=window, precision=FAST_PRECISION)
        if not use_kernel(plan, n) or use_kernel(plan, n + 1):
            raise RuntimeError(f"the dispatch rule's edge is not at m={m}, "
                               f"{n} samples")
        x = signal(n, 10).astype(np.float32)
        (_, d), first = timed_first(lambda: sdft(plan, init_state(plan),
                                                 jnp.asarray(x)))
        log(f"  edge m={m} {window}, {n} samples ({d.size} output "
            f"elements): first call {first:.2f} s")
        # the first and last row of every chunk of the oracle's run
        chunk = max(1024, n // 32)
        eng = NativeSDFT(m, window, td_bits=64)
        idx, want = [], []
        for i in range(0, n, chunk):
            ref = eng.sdft(x[i:i + chunk].astype(np.float64))
            idx += [i, i + ref.shape[0] - 1]
            want += [ref[0], ref[-1]]
        got = np.asarray(d[np.asarray(idx)])
        del d
        jax.clear_caches()
        want = np.stack(want)
        scale = float(np.abs(want).max())
        check(f"edge m={m} kernel rows {idx[0]}..{idx[-1]} vs oracle "
              f"(relative)",
              float(np.abs(got[..., 0] + 1j * got[..., 1] - want).max())
              / scale, 3e-6, rows)


def phase_hop1(rows):
    """hop=1 driver protocol: every sample's spectrum + the round trip."""
    import jax.numpy as jnp

    from sdft_tpu import FAST_PRECISION, Plan, init_state, roundtrip_hopped
    from sdft_tpu.cplx import to_complex

    plan = Plan(H1_M, window="hann", precision=FAST_PRECISION)
    x = signal(H1_BLOCK * H1_BLOCKS, 4).astype(np.float32)
    (_, hd, ys), first = timed_first(lambda: roundtrip_hopped(
        plan, init_state(plan), jnp.asarray(x.reshape(H1_BLOCKS, H1_BLOCK)),
        1))
    log(f"  hop1: first call {first:.2f} s")
    d_ref, y_ref = Oracle(H1_M).run(x)
    got = to_complex(np.asarray(hd).reshape(-1, H1_M, 2))
    check("hop1 spectra vs oracle (absolute)",
          float(np.abs(got - d_ref).max()),
          3 * f32_bound(x, H1_M, H1_BLOCK), rows)
    check("hop1 y vs oracle", float(np.abs(np.asarray(ys).reshape(-1)
                                           - y_ref).max()), 1e-5, rows)


def phase_stream(rows):
    """Streamer.run with a checkpoint after half the blocks and a resume in
    a fresh Streamer."""
    from sdft_tpu import FAST_PRECISION, Plan, Streamer, iter_blocks

    plan = Plan(ST_M, window="hann", precision=FAST_PRECISION)
    x = signal(ST_BLOCK * ST_BLOCKS, 5).astype(np.float32)
    blocks = list(iter_blocks(x, ST_BLOCK))
    half = ST_BLOCKS // 2
    ckpt = ROOT / ".smoke" / "stream_ckpt.npz"
    ckpt.parent.mkdir(exist_ok=True)

    whole = np.concatenate(list(Streamer(plan, refresh_every=1).run(blocks)))
    s1 = Streamer(plan, refresh_every=1)
    first = list(s1.run(blocks[:half]))
    s1.checkpoint(ckpt)
    s2 = Streamer(plan, refresh_every=1)
    s2.restore(ckpt)
    second = list(s2.run(blocks[half:]))
    resumed = np.concatenate(first + second)
    _, y_ref = Oracle(ST_M).run(x)
    check("stream resumed vs uninterrupted",
          float(np.abs(resumed - whole).max()), 1e-6, rows)
    check("stream y vs oracle", float(np.abs(resumed - y_ref).max()), 1e-5,
          rows)


def phase_timing(rows):
    """The spectra kernel against the XLA composition: median of
    TIME_CALLS calls after warm-up, each ending in block_until_ready."""
    import jax
    import jax.numpy as jnp

    from sdft_tpu import FAST_PRECISION, Plan, init_state, sdft, sdft_power
    from sdft_tpu.api import _sdft_1d, _sdft_power_xla

    xd = jnp.asarray(signal(TIME_BLOCK, 6).astype(np.float32))
    log(f"  {'m':>5} {'output':<12} {'kernel ms':>10} {'XLA ms':>10} "
        f"{'speedup':>8} {'kernel share':>13} {'XLA share':>10}")
    table = {}
    for m in TIME_MS:
        plan = Plan(m, window="hann", precision=FAST_PRECISION)
        st = init_state(plan)
        cases = {
            "packed f32": (8, lambda: sdft(plan, st, xd),
                           lambda: _sdft_1d(plan, st, xd, "packed", None)),
            "planar bf16": (4, lambda: sdft(plan, st, xd, layout="planar",
                                            spectra_dtype="bfloat16"),
                            lambda: _sdft_1d(plan, st, xd, "planar",
                                             "bfloat16")),
            "power bf16": (2, lambda: sdft_power(plan, st, xd,
                                                 spectra_dtype="bfloat16"),
                           lambda: _sdft_power_xla(plan, st, "bfloat16",
                                                   xd)),
        }
        for name, (nbytes, kern, xla) in cases.items():
            t_k = median_time(kern, TIME_CALLS)
            t_x = median_time(xla, TIME_CALLS)
            bound = TIME_BLOCK * m * nbytes / WRITE_BW
            table[f"m{m} {name}"] = (t_k, t_x)
            log(f"  {m:>5} {name:<12} {t_k * 1e3:>10.4f} {t_x * 1e3:>10.4f} "
                f"{t_x / t_k:>7.2f}x {bound / t_k:>12.1%} "
                f"{bound / t_x:>9.1%}")
        jax.clear_caches()
    log("  (share = the spectra write at the published 3.35 TB/s over the "
        "measured time)")
    rows.append(True)
    return table


def phase_multi(rows):
    """The sharded programs on four cards against the single-device result
    of the same input, with each output's sharding and shard shapes."""
    import jax
    import jax.numpy as jnp

    from sdft_tpu import FAST_PRECISION, Plan, init_state, sdft
    from sdft_tpu.cli import main as cli_main
    from sdft_tpu.io.dump import load_complex
    from sdft_tpu.io.wav import read_wav, write_wav
    from sdft_tpu.ops.lti import roundtrip_block_lti
    from sdft_tpu.parallel import make_mesh, sharded_roundtrip, sharded_sdft

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--multi needs 4 GPUs, JAX found "
                           f"{len(jax.devices())}")

    def shards(name, arr):
        log(f"  {name}: sharding {arr.sharding}")
        log("    shards: " + ", ".join(
            f"{s.device.id}:{tuple(s.data.shape)}"
            for s in arr.addressable_shards))

    plan = Plan(MULTI_M, window="hann", precision=FAST_PRECISION)
    C = 4
    x = jnp.asarray(signal(MULTI_BLOCK, 7, channels=C).astype(np.float32))
    _, y1 = roundtrip_block_lti(plan, init_state(plan, channels=C), x)
    y1 = np.asarray(y1)
    for axes in ((1, 4, 1), (4, 1, 1), (1, 2, 2)):
        mesh = make_mesh(*axes)
        _, y = sharded_roundtrip(plan, mesh, init_state(plan, channels=C), x)
        shards(f"sharded_roundtrip mesh {axes} y", y)
        check(f"sharded_roundtrip {axes} vs single device",
              float(np.abs(np.asarray(y) - y1).max()), 1e-5, rows)

    xs = jnp.asarray(signal(MULTI_BLOCK // 2, 8)[None].astype(np.float32))
    _, d1 = sdft(plan, init_state(plan, channels=1), xs)
    d1 = np.asarray(d1)
    scale = float(np.abs(d1).max())
    for axes in ((1, 4, 1), (1, 1, 4)):
        mesh = make_mesh(*axes)
        _, d = sharded_sdft(plan, mesh, init_state(plan, channels=1), xs)
        shards(f"sharded_sdft mesh {axes} dfts", d)
        check(f"sharded_sdft {axes} vs single device (relative)",
              float(np.abs(np.asarray(d) - d1).max()) / scale, 3e-6, rows)
    del d, d1

    work = ROOT / ".smoke"
    work.mkdir(exist_ok=True)
    src = work / "multi.wav"
    write_wav(str(src), signal(4 * CLI_RATE, 9), CLI_RATE, bits=24)
    outs = {}
    for tag, extra in (("single", []), ("mesh", ["--mesh", "1x4x1"])):
        args = [str(CLI_M), str(CLI_HOP), "hann", "1", str(src),
                str(work / f"{tag}.wav"), str(work / f"{tag}.dft")] + extra
        if cli_main(args) != 0:
            raise RuntimeError(f"cli.main {tag} failed")
        outs[tag] = (load_complex(str(work / f"{tag}.dft"), CLI_M),
                     read_wav(str(work / f"{tag}.wav"))[0])
    check("cli --mesh 1x4x1 hop DFTs vs single device",
          float(np.abs(outs["mesh"][0] - outs["single"][0]).max()), 1e-9,
          rows)
    check("cli --mesh 1x4x1 WAV vs single device",
          float(np.abs(outs["mesh"][1] - outs["single"][1]).max()), 1e-9,
          rows)


SINGLE = [phase_spectra, phase_edge, phase_timing, phase_roundtrip,
          phase_hop1, phase_stream, phase_cli]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    from sdft_tpu.runtime import setup_compile_cache

    cache = setup_compile_cache()
    log(f"card: {card()}")
    log(f"device_kind: {dev.device_kind}, devices: {len(jax.devices())}, "
        f"jax {jax.__version__}, compile cache {cache}")

    phases = [phase_multi] if args.multi else SINGLE
    failed = []
    t_all = time.perf_counter()
    for ph in phases:
        rows = []
        log(f"[{ph.__name__[6:]}] {ph.__doc__.splitlines()[0]}")
        t0 = time.perf_counter()
        try:
            ph(rows)
        except Exception:
            traceback.print_exc()
            rows.append(False)
        ok = bool(rows) and all(rows)
        log(f"[{ph.__name__[6:]}] {'passed' if ok else 'FAILED'} in "
            f"{time.perf_counter() - t0:.1f} s")
        if not ok:
            failed.append(ph.__name__)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}; "
        f"total {time.perf_counter() - t_all:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
