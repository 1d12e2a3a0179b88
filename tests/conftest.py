"""Test configuration: force CPU with 8 virtual devices, enable x64.

Multi-device sharding is validated on a virtual CPU mesh (chip_smoke.py
--multi runs the real four-card path); fp64 is enabled so the parity tests can
compare against the golden oracle at full precision.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# config updates rather than env vars: they hold even when jax was imported
# before this file (effective until backend initialization)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# mmap-region headroom: XLA:CPU JIT creates ~4,700 mappings PER compiled
# fit/pipeline executable (measured round 4); at the kernel default
# vm.max_map_count=65530 the suite dies after ~13 big compiles with LLVM
# "Cannot allocate memory" — surfacing as segfaults at whatever touches
# mmap next (backend_compile, executable serialize/deserialize, the
# compilation cache). Raise the limit best-effort (root in this image;
# harmless no-op elsewhere). RUNBOOK.md documents the symptom.
def _raise_map_count(target=1048576):
    if os.environ.get("NPSWF_NO_SYSCTL"):
        return  # opt-out: never touch host kernel settings
    path = "/proc/sys/vm/max_map_count"
    try:
        with open(path) as f:
            cur = int(f.read())
        if cur < target:
            with open(path, "w") as f:
                f.write(str(target))
            # mutating host state deserves a visible trace:
            # set NPSWF_NO_SYSCTL=1 to forbid the write entirely
            sys.stderr.write(
                f"[npswf conftest] raised vm.max_map_count {cur} -> {target} "
                "(XLA:CPU mmap exhaustion guard; NPSWF_NO_SYSCTL=1 opts out)\n")
    except (OSError, ValueError):
        pass  # not root / not Linux: accept the platform default


_raise_map_count()

# Persistent compilation cache: the suite's cost is dominated by XLA compiles
# of the full pipeline; caching them on disk makes re-runs start warm.
from npswf.utils.compile_cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import pytest  # noqa: E402
import numpy as np  # noqa: E402

from npswf.core.config import NPSConfig  # noqa: E402
from npswf.core.calibration import synthetic_calibration  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    A full single-process run accumulates ~100 XLA CPU executables (several
    GB RSS) and has been observed to segfault inside backend_compile near the
    end; clearing per module keeps the process lean. Recompiles are cheap via
    the persistent compilation cache above.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def cfg():
    return NPSConfig()


@pytest.fixture(scope="session")
def small_cfg():
    """A reduced-geometry config (6x5 grid) for fast exhaustive tests."""
    return NPSConfig(ncol=5, nlin=6)


@pytest.fixture(scope="session")
def cal(cfg):
    return synthetic_calibration(cfg, seed=1)


@pytest.fixture(scope="session")
def small_cal(small_cfg):
    return synthetic_calibration(small_cfg, seed=2)
