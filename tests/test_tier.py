"""The rule of the root ``conftest.py``, checked in a fresh interpreter so
the environment of the process running the tests cannot decide it."""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib.util, json, os, sys
spec = importlib.util.spec_from_file_location("root_conftest", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps({k: os.environ.get(k) for k in
                  ("VUKE_TEST_PLATFORM", "XLA_FLAGS", "VUKE_STRING_PAD")}))
"""


@pytest.mark.parametrize("given, cpu", [
    ({"JAX_PLATFORMS": "cpu"}, True),
    ({"JAX_PLATFORMS": "cpu", "VUKE_STRING_PAD": "64"}, True),
    ({"JAX_PLATFORMS": "tpu"}, False),
    ({}, False),
], ids=["jax_platforms", "explicit_pad_wins", "other_platform", "neither"])
def test_root_conftest_compile_flags(given, cpu):
    """JAX_PLATFORMS=cpu alone gives the XLA:CPU compile flags and the
    string pad, in the environment that subprocesses inherit, and leaves
    the tier variable and the device count alone."""
    env = {k: v for k, v in os.environ.items() if k not in (
        "JAX_PLATFORMS", "VUKE_TEST_PLATFORM", "XLA_FLAGS", "VUKE_STRING_PAD")}
    env.update(given)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, os.path.join(_REPO, "conftest.py")],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    flags = (seen["XLA_FLAGS"] or "").split()
    assert seen["VUKE_TEST_PLATFORM"] is None
    assert not any(f.startswith("--xla_force_host_platform_device_count") for f in flags)
    if cpu:
        assert "--xla_backend_optimization_level=1" in flags
        assert seen["VUKE_STRING_PAD"] == given.get("VUKE_STRING_PAD", "512")
    else:
        assert flags == []
        assert seen["VUKE_STRING_PAD"] is None
