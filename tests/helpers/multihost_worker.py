"""Worker for the REAL 2-process jax.distributed test (test_multihost.py).

Each process contributes 2 virtual CPU devices to a genuine 2-process
(1, 2, 2) global mesh, runs two chained sharded_roundtrip steps over it
(collectives ride Gloo across the process boundary), gathers the global
result, and asserts equality with the purely-local single-device reference
at 1e-12.  Invoked as:  python multihost_worker.py <pid> <port> <out_dir>
"""

import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
out_dir = sys.argv[3]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from sdft_tpu import Plan, Precision, init_state  # noqa: E402
from sdft_tpu.ops.lti import roundtrip_block_lti  # noqa: E402
from sdft_tpu.parallel import multihost, sharded_roundtrip  # noqa: E402
from sdft_tpu.parallel.sharded import SAMPLE_SPEC, STATE_SPECS  # noqa: E402
from sdft_tpu.state import State  # noqa: E402


def main():
    multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 4, jax.device_count()
    assert jax.local_device_count() == 2

    mesh = multihost.global_mesh(channel=1, time=2, bins=2)
    plan = Plan(96, window="hann",
                precision=Precision("float64", "float64"))
    rng = np.random.default_rng(5)
    x = np.clip(rng.standard_normal((1, 384)), -3, 3) / 2

    st_host = init_state(plan, channels=1)
    state = State(*[multihost.global_array(mesh, spec, np.asarray(leaf))
                    for leaf, spec in zip(st_host, STATE_SPECS)])
    xg = multihost.global_array(mesh, SAMPLE_SPEC, x)

    ys = []
    for _ in range(2):  # chained: the carry crosses the process boundary too
        state, y = sharded_roundtrip(plan, mesh, state, xg)
        ys.append(multihost_utils.process_allgather(y, tiled=True))
    acc = multihost_utils.process_allgather(state.accumulator, tiled=True)

    # purely local single-device reference
    st_ref = init_state(plan, channels=1)
    for step in range(2):
        st_ref, y_ref = roundtrip_block_lti(plan, st_ref, x)
        np.testing.assert_allclose(ys[step], np.asarray(y_ref), atol=1e-12)
    np.testing.assert_allclose(acc, np.asarray(st_ref.accumulator),
                               atol=1e-12)

    # time-sharded Pallas spectra program across the process boundary
    # (interpret-mode kernel; local blocks < 2m exercise the cross-process
    # comb-history all_gather)
    from sdft_tpu import sdft as _sdft
    from sdft_tpu.parallel import sharded_sdft_pallas

    mesh2 = multihost.global_mesh(channel=1, time=4, bins=1)
    plan2 = Plan(128, window="hann",
                 precision=Precision("float32", "float32"))
    x2 = (np.clip(rng.standard_normal((1, 1024)), -3, 3) / 2
          ).astype(np.float32)
    st2 = State(*[multihost.global_array(mesh2, spec, np.asarray(leaf))
                  for leaf, spec in zip(init_state(plan2, channels=1),
                                        STATE_SPECS)])
    x2g = multihost.global_array(mesh2, SAMPLE_SPEC, x2)
    st2, d2 = sharded_sdft_pallas(plan2, mesh2, st2, x2g, interpret=True)
    d2h = multihost_utils.process_allgather(d2, tiled=True)
    _, d2ref = _sdft(plan2, init_state(plan2, channels=1), x2)
    np.testing.assert_allclose(d2h, np.asarray(d2ref), atol=5e-6)

    with open(os.path.join(out_dir, f"ok{pid}"), "w") as f:
        f.write("OK")
    print(f"worker {pid}: OK", flush=True)


if __name__ == "__main__":
    main()
