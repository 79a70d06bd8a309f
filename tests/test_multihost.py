"""Multi-host runtime helpers (sdft_tpu.parallel.multihost).

Real multi-process clusters cannot run in CI; these tests exercise the
single-process contracts and mock `jax.distributed` for the initialize()
branching (SURVEY.md §2.4 — the reference is single-process, so this whole
module is this framework's own surface with no reference counterpart).
"""

import os
import pathlib

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from sdft_tpu.parallel import multihost


class _Recorder:
    def __init__(self, exc=None):
        self.calls = []
        self.exc = exc

    def initialize(self, **kw):
        self.calls.append(kw)
        if self.exc is not None:
            raise self.exc


def test_initialize_forwards_cluster_args(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(jax, "distributed", rec)
    multihost.initialize(coordinator_address="10.0.0.1:1234",
                         num_processes=4, process_id=2)
    assert rec.calls == [dict(coordinator_address="10.0.0.1:1234",
                              num_processes=4, process_id=2)]


def test_initialize_idempotent_when_group_exists(monkeypatch):
    # re-entry must not probe the backend first (jax.process_count() would
    # initialize a single-process runtime — the bug the real 2-process test
    # caught); the "already initialized" error from jax.distributed is the
    # idempotency signal and is swallowed even with explicit args
    rec = _Recorder(exc=RuntimeError("Distributed system is already initialized"))
    monkeypatch.setattr(jax, "distributed", rec)
    multihost.initialize("localhost:1234", 2, 0)
    assert len(rec.calls) == 1


def test_initialize_explicit_args_failure_raises(monkeypatch):
    # with an explicit coordinator a real failure must surface, not be
    # silently downgraded to single-process mode
    rec = _Recorder(exc=RuntimeError("connection refused"))
    monkeypatch.setattr(jax, "distributed", rec)
    with pytest.raises(RuntimeError, match="connection refused"):
        multihost.initialize("localhost:1", 2, 0)


def test_initialize_tolerates_missing_cluster_env(monkeypatch):
    # single-process run (no coordinator): the RuntimeError is swallowed,
    # SPMD code still works on the local devices
    rec = _Recorder(exc=RuntimeError("no cluster environment detected"))
    monkeypatch.setattr(jax, "distributed", rec)
    multihost.initialize()
    assert len(rec.calls) == 1


def test_global_mesh_uses_all_devices():
    n = len(jax.devices())
    mesh = multihost.global_mesh(time=n)
    assert mesh.axis_names == ("channel", "time", "bins")
    assert mesh.devices.shape == (1, n, 1)
    with pytest.raises(ValueError, match="must use all"):
        multihost.global_mesh(time=max(n // 2, 1), bins=1)


def test_host_local_to_global_roundtrip():
    # single process: the "host-local" shard is the whole array, but the
    # result must come back sharded per spec and numerically intact
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = multihost.global_mesh(channel=2, time=4)
    x = np.arange(2 * 64, dtype=np.float32).reshape(2, 64)
    g = multihost.host_local_to_global(mesh, P("channel", "time"), x)
    assert g.shape == x.shape
    np.testing.assert_array_equal(np.asarray(g), x)
    assert len(g.sharding.device_set) == 8


def test_two_process_distributed_roundtrip(tmp_path):
    """REAL multi-process exercise: spawn 2 local processes with a
    localhost coordinator, build a genuine 2-process (1, 2, 2) global mesh
    (2 virtual CPU devices per process), run chained sharded_roundtrip
    steps whose collectives cross the process boundary, and assert equality
    with the single-process path (worker asserts 1e-12)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = pathlib.Path(__file__).parent / "helpers" / "multihost_worker.py"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(pid), str(port), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert (tmp_path / f"ok{pid}").exists(), out[-3000:]
