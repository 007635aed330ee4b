"""``kernel_load_s``, layer "kernel library" (``_build.build_all``): the
seconds the program spent building its CUDA kernel libraries with
``nvcc`` or loading them from its build cache, from its counter
``kernels.load_s`` (``utils.telemetry``, on the host clock), all of it
inside the run's set-up; logs the ``nvcc`` builds and libraries loaded.
None where the program has no such counter or loaded nothing. Moves
``setup_s``."""
import sys


def read(run):
    try:
        from positionbaseddynamics_tpu_torch.utils import telemetry
    except ImportError:
        return None
    c = telemetry.counters()
    seconds = c.get("kernels.load_s", 0.0)
    if seconds <= 0:
        return None
    print(f"kernel library: {c.get('kernels.nvcc_builds', 0)} nvcc builds, "
          f"{c.get('kernels.libraries_loaded', 0)} libraries loaded in "
          f"{seconds!r} s", file=sys.stderr, flush=True)
    return seconds
