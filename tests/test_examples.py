"""Pytest smoke coverage for examples/*.py.

scripts/verify.sh runs the examples end-to-end on real inputs; this tier
only guards against import/API regressions from ``pytest tests`` alone, so
each example's ``main`` runs once on the CPU backend with its outputs
redirected into tmp_path (reference example-as-test role:
python/examples/latency.py:50-57).
"""

import importlib.util
import os
import pathlib
import sys

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _load(name, monkeypatch):
    # examples/ is not a package; each file self-inserts the repo root on
    # sys.path and honors JAX_PLATFORMS=cpu (set by conftest) at import
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    spec.loader.exec_module(mod)
    return mod


def test_example_latency(monkeypatch):
    mod = _load("latency", monkeypatch)
    mod.main()


def test_example_streaming(monkeypatch):
    mod = _load("streaming", monkeypatch)
    mod.main(256, 32)


def test_example_stft_window_test(monkeypatch):
    mod = _load("stft_window_test", monkeypatch)
    mod.main()


def test_example_precision(monkeypatch):
    mod = _load("precision", monkeypatch)
    mod.main()


def test_example_analysis(monkeypatch, tmp_path):
    pytest.importorskip("matplotlib")
    monkeypatch.chdir(tmp_path)          # analysis.png lands in cwd
    mod = _load("analysis", monkeypatch)
    mod.main()
    assert (tmp_path / "analysis.png").exists()


def test_example_transform(monkeypatch, tmp_path):
    if not os.path.exists("/root/reference/test/test.wav"):
        pytest.skip("reference test.wav unavailable")
    mod = _load("transform", monkeypatch)
    real_write = mod.write_wav
    written = []

    def write_tmp(path, *a, **k):
        out = tmp_path / pathlib.Path(path).name
        written.append(out)
        return real_write(str(out), *a, **k)

    monkeypatch.setattr(mod, "write_wav", write_tmp)
    monkeypatch.setattr(sys, "argv", ["transform.py"])
    mod.main()
    assert written and written[0].exists()
