"""Worker for the CPU strong-scaling proxy measurement (BASELINE.md
scaling target).

Modes (argv[1]):
  single <out_file> <m> <block>
      one process, ONE virtual CPU device: marginal time of the unsharded
      collapsed-LTI round trip over the full global block.
  pair <pid> <port> <out_dir> <m> <block>
      one of TWO processes, one virtual CPU device each, joined into a
      real jax.distributed (Gloo) cluster with a (1, 2, 1) global mesh:
      marginal time of sharded_roundtrip over the same global block —
      every collective (comb ppermute, prefix all_gather, psum) crosses
      the process boundary.

Timing uses the chained-marginal method (profiling.benchmark_marginal) so
per-dispatch overhead cancels; both modes process the identical global
sample stream, so  eff = t_single / (2 * t_pair)  is a true
strong-scaling efficiency (2 devices, 2 processes, shared-nothing JAX
runtimes on one host — an ICI-free lower bound on collective cost).
"""

import json
import os
import sys

mode = sys.argv[1]

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sdft_tpu import Plan, Precision, init_state  # noqa: E402
from sdft_tpu.profiling import benchmark_marginal  # noqa: E402

PREC = Precision("float32", "float32")


def main():
    if mode == "single":
        out_file, m, block = sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
        # the SAME sharded program on a degenerate 1-device mesh — a
        # different baseline program (e.g. the tuned unsharded
        # roundtrip_block_lti) would fold program-efficiency differences
        # into the "scaling" number
        from sdft_tpu.parallel import make_mesh, sharded_roundtrip

        plan = Plan(m, window="hann", precision=PREC)
        mesh = make_mesh(1, 1, 1)
        state = init_state(plan, channels=1)
        rng = np.random.default_rng(0)
        xs = rng.standard_normal((12, 1, block)).astype(np.float32)
        res = benchmark_marginal(
            lambda st, x: sharded_roundtrip(plan, mesh, st, x), state, xs,
            repeats=3)
        with open(out_file, "w") as f:
            json.dump({"seconds": res["seconds"]}, f)
        print(f"single: {res['seconds'] * 1e3:.3f} ms/block", flush=True)
        return

    assert mode == "pair"
    pid, port, out_dir = int(sys.argv[2]), sys.argv[3], sys.argv[4]
    m, block = int(sys.argv[5]), int(sys.argv[6])

    from sdft_tpu.parallel import multihost, sharded_roundtrip
    from sdft_tpu.parallel.sharded import SAMPLE_SPEC, STATE_SPECS
    from sdft_tpu.state import State

    multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
    assert jax.device_count() == 2
    mesh = multihost.global_mesh(channel=1, time=2, bins=1)
    plan = Plan(m, window="hann", precision=PREC)

    from jax.sharding import PartitionSpec as P

    rng = np.random.default_rng(0)
    xs_host = rng.standard_normal((12, 1, block)).astype(np.float32)
    st_host = init_state(plan, channels=1)
    state = State(*[multihost.global_array(mesh, spec, np.asarray(leaf))
                    for leaf, spec in zip(st_host, STATE_SPECS)])
    # stacked blocks as one global array: leading block axis replicated,
    # trailing sample axis time-sharded (matching SAMPLE_SPEC per block)
    xs_stacked = multihost.global_array(
        mesh, P(None, *SAMPLE_SPEC), xs_host)

    res = benchmark_marginal(
        lambda st, x: sharded_roundtrip(plan, mesh, st, x),
        state, xs_stacked, repeats=3)
    if pid == 0:
        with open(os.path.join(out_dir, "pair.json"), "w") as f:
            json.dump({"seconds": res["seconds"]}, f)
    print(f"pair worker {pid}: {res['seconds'] * 1e3:.3f} ms/block",
          flush=True)


if __name__ == "__main__":
    main()
