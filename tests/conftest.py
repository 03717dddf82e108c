"""Test configuration: run on CPU with 8 virtual devices and float64.

Multi-device sharding tests run on a virtual CPU mesh
(xla_force_host_platform_device_count), replacing the reference's
"multi-rank MPI without a cluster" testing mode (SURVEY.md section 4).

jax may already be imported when this file runs, so the platform is set
through jax.config (before first backend use) rather than JAX_PLATFORMS.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# The XLA CPU compiler recurses deeply on the reax autodiff graphs
# (dense bond-order field: the virial transpose is thousands of ops
# deep) and can overflow the default 8 MB main-thread stack as a hard
# SIGSEGV in backend_compile_and_load — observed late in full-suite
# runs where memory layout differs from standalone runs.  The hard
# limit is unlimited here, so raise the soft limit for the test
# process.
import resource

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
if _hard == resource.RLIM_INFINITY and _soft != resource.RLIM_INFINITY:
    resource.setrlimit(resource.RLIMIT_STACK,
                       (resource.RLIM_INFINITY, resource.RLIM_INFINITY))

# A full-suite process accumulates thousands of LLVM-JIT'd executables
# (every jit compile maps several executable pages); at the kernel
# default vm.max_map_count=65530 the process eventually exhausts its
# mmap budget and the NEXT large XLA CPU compile segfaults inside
# backend_compile_and_load — a roving failure that lands on whichever
# big compile comes late (observed on the reax virial and the staged
# melt program; fresh processes always pass).  Raise the limit when
# privileged (silent no-op otherwise); jax.clear_caches() at heavy
# modules (tests/test_reax.py) is the in-process fallback.
import subprocess as _sp

try:
    _sp.run(["sysctl", "-w", "vm.max_map_count=1048576"],
            check=False, capture_output=True)
except OSError:  # sysctl binary absent (slim images): fall back to the
    pass         # in-process cache clears only

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    # Fast profile: `pytest -m "not slow"` for inner-loop development —
    # re-tiered round 5 to hold <10 min on ONE CPU core (this machine):
    # every compile/run-heavy module/test carries the slow mark, each
    # subsystem keeps a cheap representative.  The FULL suite (including
    # slow) remains the gate.
    config.addinivalue_line(
        "markers",
        "slow: test takes >=1 minute on the CPU mesh; deselect with "
        "-m 'not slow' for the fast development profile",
    )
    config._scema_t0 = __import__("time").perf_counter()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    # print the measured wall so the fast-profile promise stays honest
    t0 = getattr(config, "_scema_t0", None)
    if t0 is not None:
        wall = __import__("time").perf_counter() - t0
        terminalreporter.write_line(
            f"[scema] suite wall time: {wall:.0f} s"
            + (" (fast profile target: <600 s)"
               if "not slow" in (config.option.markexpr or "") else ""))

# Build the native C++ runtime once per session so the C++-twin tests
# (tests/test_native.py) execute instead of skipping.  Failures fall
# through silently — every native entry point has a Python fallback.
import shutil
import subprocess

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_native = os.path.join(_repo, "native")
if shutil.which("g++") and os.path.isdir(_native) and not os.path.exists(
    os.path.join(_native, "libscema_native.so")
):
    subprocess.run(["make", "-C", _native], check=False,
                   capture_output=True, timeout=300)
