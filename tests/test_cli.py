"""CLI driver protocol test: same outputs as the reference driver protocol."""

import sys

import numpy as np
import pytest

from sdft_tpu.cli import main as cli_main
from sdft_tpu.io.dump import load_complex
from sdft_tpu.io.wav import read_wav, write_wav

REF_SRC = "/root/reference/python/src"


@pytest.fixture(scope="module")
def ref():
    sys.path.insert(0, REF_SRC)
    try:
        import sdft as ref_mod
    except ImportError:
        pytest.skip("reference python package not importable")
    finally:
        sys.path.remove(REF_SRC)
    return ref_mod


def test_cli_driver_matches_reference_protocol(ref, test_wav, tmp_path, capsys):
    x, sr = test_wav
    n = 4000
    src = tmp_path / "src.wav"
    write_wav(str(src), x[:n], sr, bits=24)

    m, hop = 200, 100
    out_wav = tmp_path / "out.wav"
    out_dft = tmp_path / "out.dft"
    rc = cli_main([str(m), str(hop), "hann", "1", str(src), str(out_wav), str(out_dft)])
    assert rc == 0

    # reference protocol on the same (requantized) source
    xq, _ = read_wav(str(src))
    size = (xq.size // hop) * hop
    theirs = ref.SDFT(m, "hann", 1)
    y_ref, dfts_ref = [], []
    for i in range(0, size, hop):
        d = theirs.sdft(xq[i:i + hop])
        dfts_ref.append(d[0])
        y_ref.append(theirs.isdft(d))
    y_ref = np.concatenate(y_ref)
    dfts_ref = np.stack(dfts_ref)

    got_dfts = load_complex(str(out_dft), m)
    np.testing.assert_allclose(got_dfts, dfts_ref, atol=1e-7)

    # compare synthesized signals through the same 32-bit wav quantization
    got_y, _ = read_wav(str(out_wav))
    ref_wav = tmp_path / "ref.wav"
    write_wav(str(ref_wav), np.asarray(y_ref, dtype=np.float64), sr)
    want_y, _ = read_wav(str(ref_wav))
    np.testing.assert_allclose(got_y, want_y, atol=1e-6)


def test_cli_block_mode_identical(ref, test_wav, tmp_path):
    x, sr = test_wav
    src = tmp_path / "src.wav"
    write_wav(str(src), x[:3000], sr, bits=24)

    outs = []
    for extra in ([], ["--block", "500"]):
        out_wav = tmp_path / f"out{len(extra)}.wav"
        out_dft = tmp_path / f"out{len(extra)}.dft"
        rc = cli_main(["100", "100", "hamming", "0.5", str(src),
                       str(out_wav), str(out_dft)] + extra)
        assert rc == 0
        outs.append((read_wav(str(out_wav))[0], load_complex(str(out_dft), 100)))

    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-12)
    np.testing.assert_allclose(outs[0][1], outs[1][1], atol=1e-12)


def test_cli_mesh_matches_single_device(test_wav, tmp_path):
    """--mesh 1x4x2 output equals the single-device driver output on the
    virtual 8-device mesh (the sharded driver protocol,
    test/test.c:69-83)."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    x, sr = test_wav
    src = tmp_path / "src.wav"
    write_wav(str(src), x[:3200], sr, bits=24)

    m, hop = 64, 100
    outs = []
    for extra in ([], ["--mesh", "1x4x2", "--block", "800"]):
        tag = "mesh" if extra else "one"
        out_wav = tmp_path / f"{tag}.wav"
        out_dft = tmp_path / f"{tag}.dft"
        rc = cli_main([str(m), str(hop), "hann", "1", str(src),
                       str(out_wav), str(out_dft)] + extra)
        assert rc == 0
        outs.append((read_wav(str(out_wav))[0], load_complex(str(out_dft), m)))

    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1e-12)
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-12)


def test_wav_bit_depths_roundtrip(tmp_path):
    """write_wav/read_wav round trip at every bit depth — regression for
    the 8-bit path, which clipped after the unsigned offset and clamped
    the entire positive half of the waveform to ~zero."""
    from sdft_tpu.io.wav import read_wav, write_wav

    rng = np.random.default_rng(3)
    x = np.clip(rng.standard_normal(512), -1, 1)
    x[:4] = [1.0, -1.0, 0.5, -0.5]  # pin full-scale positives explicitly
    for bits, tol in ((8, 1.2e-2), (16, 5e-5), (24, 2e-7), (32, 1e-9)):
        p = str(tmp_path / f"rt{bits}.wav")
        write_wav(p, x, 44100, bits=bits)
        y, sr = read_wav(p)
        assert sr == 44100
        np.testing.assert_allclose(y, x, atol=tol)


def test_wav_ieee_float_read(tmp_path):
    """IEEE-float WAVs (format tag 3) read through the RIFF fallback —
    the reference's dr_wav accepts these (test/wav.h:38-91); Python's
    ``wave`` module rejects them."""
    import struct

    rng = np.random.default_rng(5)
    x = np.clip(rng.standard_normal((256, 2)), -1, 1)

    def write_float_wav(path, data, sr, dtype, bits):
        raw = data.astype(dtype).tobytes()
        c = data.shape[1]
        fmt = struct.pack("<HHIIHH", 3, c, sr, sr * c * bits // 8,
                          c * bits // 8, bits)
        body = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
                + b"data" + struct.pack("<I", len(raw)) + raw)
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE")
            f.write(body)

    for dtype, bits, tol in (("<f4", 32, 1e-7), ("<f8", 64, 0)):
        p = str(tmp_path / f"float{bits}.wav")
        write_float_wav(p, x, 48000, dtype, bits)
        y, sr = read_wav(p, mono=False)
        assert sr == 48000
        np.testing.assert_allclose(y, x, atol=tol)
        ym, _ = read_wav(p)
        np.testing.assert_allclose(ym, x.mean(axis=-1), atol=tol)
