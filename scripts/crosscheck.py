"""Cross-implementation verification harness.

This framework's analogue of the reference's test/main.sh + test/main.py
pipeline: run the same 7-arg driver protocol through (a) the JAX/Pallas
framework and (b) the native C++ oracle engine on test.wav, assert the DFT
matrices and round-trip WAVs agree within the reference tolerances
(test/main.py:70-79), compute the FFT-based STFT comparison, and optionally
render side-by-side spectrograms.

Usage:
    python scripts/crosscheck.py [dftsize] [hopsize] [window] [latency] [wav] [plot.png]
Defaults mirror test/main.sh: 1000 100 hann 1 /root/reference/test/test.wav
A sixth argument saves side-by-side SDFT/oracle/STFT spectrograms (the
reference's visual proof-of-concept, test/main.py:83-86) to that path.

Environment:
    SDFT_CROSSCHECK_BACKEND=gpu   run the framework on the GPU (default: cpu)
    SDFT_CROSSCHECK_FD=32         the --fd32 fast path with the f32 gate
                                  (default: the f64 parity mode, 1e-7 gate)
"""

import os
import pathlib
import sys
import tempfile

# By default the parity gate runs the f64 path (SURVEY.md §7: f64 mode for
# parity runs) — the reference tolerance of 1e-7 (test/main.py:79) is a
# float64 contract — on the CPU.  SDFT_CROSSCHECK_BACKEND=gpu runs the same
# on the GPU (which computes in f64 too); SDFT_CROSSCHECK_FD=32 runs the f32
# fast path instead, with f32-calibrated tolerances.
_backend = os.environ.get("SDFT_CROSSCHECK_BACKEND", "cpu")
_on_accel = _backend != "cpu"
_fd32 = os.environ.get("SDFT_CROSSCHECK_FD", "64") == "32"

import jax  # noqa: E402

if not _on_accel:
    # config wins over an installed plugin's default as long as no backend
    # is initialized yet (same as tests/conftest.py)
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
if not _fd32:
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from sdft_tpu.cli import main as cli_main           # noqa: E402
from sdft_tpu.compat import STFT                    # noqa: E402
from sdft_tpu.io.dump import load_complex           # noqa: E402
from sdft_tpu.io.wav import read_wav, write_wav     # noqa: E402
from sdft_tpu.oracle import NativeSDFT, NativeSDFT2  # noqa: E402


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    dftsize = int(argv[0]) if len(argv) > 0 else 1000
    hopsize = int(argv[1]) if len(argv) > 1 else 100
    window = argv[2] if len(argv) > 2 else "hann"
    latency = float(argv[3]) if len(argv) > 3 else 1.0
    src = argv[4] if len(argv) > 4 else "/root/reference/test/test.wav"
    plot = argv[5] if len(argv) > 5 else None

    if _on_accel:
        backend = jax.default_backend()
        print(f"accelerator crosscheck: backend={backend}, "
              f"devices={jax.devices()}")
        assert backend != "cpu", (
            f"SDFT_CROSSCHECK_BACKEND={_backend} but JAX initialized "
            f"backend {backend!r} — no accelerator found")

    # Tolerances: CPU/f64 uses the reference contract (test/main.py:79,
    # atol=1e-7 on DFT matrices).  The f32 path is gated by the
    # f32 rounding-propagation model (same derivation as tests/test_gpu.py):
    # with a per-block accumulator refresh (the chained CLI path refreshes
    # every block), the spectra error is the within-block random walk
    #
    #     err ~ eps32 * |x|_rms * sqrt(block / (2m))
    #
    # (|acc| ~ |x|_rms*sqrt(2m) rotated-delta walk; eps32*|acc|*sqrt(block)
    # random walk over the block; * the 1/(2m) analysis weight).  The gate
    # sits at 3.5x the model (floor 1e-7, the reference's own cross-impl
    # gate); any real defect (wrong tap, phase, or Hermitian guard) shows up
    # at 1e-3+ relative.
    block = hopsize * max(1, 4096 // hopsize)
    if _fd32:
        x_pre, _ = read_wav(src)
        xrms = float(np.sqrt(np.mean(x_pre.astype(np.float64) ** 2)))
        eps32 = float(np.finfo(np.float32).eps)
        model = eps32 * xrms * (block / (2.0 * dftsize)) ** 0.5
        dft_tol = max(1e-7, 3.5 * model)
        wav_tol = max(1e-4, 3.5e3 * model)
    else:
        dft_tol = 1e-7
        wav_tol = 1e-6

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        out_wav = tmp / "sdft.wav"
        out_dft = tmp / "sdft.dft"
        # whole-hop chunking is invariant (test_core_parity.py); a large
        # internal block amortizes dispatch without changing any output bit
        # (the chained CLI refreshes the accumulator at block boundaries,
        # so rounding does not accumulate across blocks)
        args = [str(dftsize), str(hopsize), window, str(latency),
                src, str(out_wav), str(out_dft), "--block", str(block)]
        if _fd32:
            args.append("--fd32")
        rc = cli_main(args)
        assert rc == 0

        x, sr = read_wav(src)
        size = (x.size // hopsize) * hopsize
        x = x[:size]

        print("native oracle pass...")
        eng = NativeSDFT(dftsize, window, latency, td_bits=64)
        hops = size // hopsize
        dfts_ref = np.empty((hops, dftsize), np.complex128)
        y_ref = np.empty(size)
        for h in range(hops):
            d = eng.sdft(x[h * hopsize:(h + 1) * hopsize])
            dfts_ref[h] = d[0]
            y_ref[h * hopsize:(h + 1) * hopsize] = eng.isdft(d)

        # second native engine: the native<->native leg of the triangle
        # (mirrors the reference's C<->C++ default-tolerance assert,
        # test/main.py:78 — two independently written engines, no shared code)
        print("native engine #2 pass...")
        eng2 = NativeSDFT2(dftsize, window, latency, td_bits=64)
        nerr = 0.0
        for h in range(hops):
            d2 = eng2.sdft(x[h * hopsize:(h + 1) * hopsize])
            nerr = max(nerr, float(np.abs(d2[0] - dfts_ref[h]).max()))
        print(f"native #1 vs #2 dft max abs diff: {nerr:.3e} (tolerance 1e-12)")
        assert nerr < 1e-12, nerr

        # extended-precision FD corner (the reference's long-double tier,
        # c/src/sdft/sdft.h:21-37): fd_bits=80 must agree with the double
        # tier to f64 rounding on the first hops
        eng80 = NativeSDFT(dftsize, window, latency, td_bits=64, fd_bits=80)
        xerr = 0.0
        for h in range(min(hops, 16)):
            d80 = eng80.sdft(x[h * hopsize:(h + 1) * hopsize])
            xerr = max(xerr, float(np.abs(d80[0] - dfts_ref[h]).max()))
        print(f"native fd80 vs fd64 dft max abs diff: {xerr:.3e} "
              f"(tolerance 1e-12)")
        assert xerr < 1e-12, xerr

        # the framework's own extended tier (Precision(fd="float32x2"),
        # double-word f32 arithmetic — the on-device long-double analogue)
        # closes the triangle against the native extended tier: df spectra
        # must match eng80's f64-cast output at the f64-class tolerance,
        # on ANY backend (the tier never uses float64)
        from sdft_tpu import Plan as _Plan, Precision as _Prec, init_state
        from sdft_tpu import df_to_float64, sdft as _sdft

        nseg = min(size, 4 * hopsize)
        plan_x2 = _Plan(dftsize, window=window, latency=latency,
                        precision=_Prec("float32", "float32x2"))
        _, ddf = _sdft(plan_x2, init_state(plan_x2),
                       x[:nseg].astype(np.float32))
        got_df = df_to_float64((np.asarray(ddf[..., 0]),
                                np.asarray(ddf[..., 1])))
        got_df = got_df[..., 0] + 1j * got_df[..., 1]
        eng80.reset()
        want80 = eng80.sdft(x[:nseg].astype(np.float32).astype(np.float64))
        x2err = float(np.abs(got_df - want80).max())
        x2scale = float(np.abs(want80).max())
        print(f"float32x2 tier vs native fd80 dft max rel diff: "
              f"{x2err / x2scale:.3e} (tolerance 1e-9)")
        assert x2err < 1e-9 * x2scale, (x2err, x2scale)

        dfts_got = load_complex(str(out_dft), dftsize)
        y_got, _ = read_wav(str(out_wav))

        ref_wav = tmp / "oracle.wav"
        write_wav(str(ref_wav), y_ref, sr)
        y_ref_q, _ = read_wav(str(ref_wav))

        assert dfts_got.shape == dfts_ref.shape, (dfts_got.shape, dfts_ref.shape)
        derr = np.abs(dfts_got - dfts_ref).max()
        yerr = np.abs(y_got - y_ref_q).max()
        print(f"dft  max abs diff: {derr:.3e}  (tolerance {dft_tol:.0e}, "
              f"test/main.py:79)")
        print(f"wav  max abs diff: {yerr:.3e}  (tolerance {wav_tol:.0e})")
        assert derr < dft_tol, derr
        assert yerr < wav_tol, yerr

        # cross-algorithm sanity vs FFT STFT (test/main.py:56-63).  The
        # comparator is host-side reference math: pin it to the CPU backend
        # (nothing device-relevant is gated here; the device paths are gated
        # above, via the CLI).
        framesize = dftsize * 2
        xd = np.roll(x, framesize)
        xd[:framesize] = 0
        stft = STFT(framesize=framesize, hopsize=hopsize, window=window)
        with jax.default_device(jax.devices("cpu")[0]):
            stftx = stft.stft(xd)
        corr = _spectro_corr(dfts_got, stftx[:dfts_got.shape[0]])
        print(f"SDFT vs STFT log-spectrogram correlation: {corr:.4f}")
        assert corr > 0.9, corr

        if plot:
            from sdft_tpu.viz import compare_spectrograms
            compare_spectrograms(
                [("sdft", dfts_got), ("sdft (oracle)", dfts_ref),
                 ("stft (fft)", stftx[:dfts_got.shape[0], :dftsize])],
                samplerate=sr, hopsize=hopsize, path=plot)
            print(f"spectrograms saved to {plot}")

    print("crosscheck OK")
    return 0


def _spectro_corr(a, b):
    """Correlation of dB magnitudes over the common shape."""
    n = min(a.shape[0], b.shape[0])
    k = min(a.shape[1], b.shape[1])
    da = 20 * np.log10(np.abs(a[:n, :k]) + 1e-12)
    db = 20 * np.log10(np.abs(b[:n, :k]) + 1e-12)
    da, db = da.ravel(), db.ravel()
    da -= da.mean()
    db -= db.mean()
    return float((da @ db) / np.sqrt((da @ da) * (db @ db)))


if __name__ == "__main__":
    sys.exit(main())
