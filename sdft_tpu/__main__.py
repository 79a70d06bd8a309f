import os
import sys


def _dispatch() -> int:
    # re-assert the user's platform choice via jax.config before any backend
    # initializes, so `JAX_PLATFORMS=cpu python -m sdft_tpu ...` holds even
    # where an installed plugin would pick another default
    plat = os.environ.get("JAX_PLATFORMS")
    if plat:
        import jax
        jax.config.update("jax_platforms", plat)
    from .runtime import setup_compile_cache

    setup_compile_cache()
    argv = sys.argv[1:]
    if argv and argv[0] == "bench":
        from .profiling import bench_cli
        return bench_cli(argv[1:])
    if argv and argv[0] == "trace":
        # python -m sdft_tpu trace <logdir> <7 driver args...>
        from .profiling import trace
        from .cli import main
        with trace(argv[1]):
            return main(argv[2:])
    from .cli import main
    return main(argv)


raise SystemExit(_dispatch())
