"""Sizes at which a cell runs on the CPU through the program's plain
versions in seconds: the tests' stand-ins for the chip's."""

import json
import subprocess
import sys

from portbench.harness import ROOT

SMALL = {
    "milksad.scan": {"config": {"targets": 4096},
                     "traffic": {"job_seeds": 1024, "batch": 1024, "planted": 3,
                                 "warmup_seeds": 1024, "trace_jobs": 1}},
    "brainwallet_numeric.scan": {"config": {"targets": 4096},
                                 "traffic": {"job_seeds": 1024, "batch": 1024, "planted": 3,
                                             "warmup_seeds": 1024, "trace_jobs": 1}},
    "milksad.analyze": {"config": {"seed_space": [0, 1 << 14], "max_seeds": 1 << 14},
                        "traffic": {"batch": 1024, "keys": 8, "trace_keys": 2}},
    "b1000_mt64.cascade.4card": {"traffic": {"job_seeds": 1 << 14, "batch": 256,
                                             "stop_slack_seeds": 2048, "warmup_seeds": 512,
                                             "jobs": 8, "trace_jobs": 1}},
}
SECONDS = {"milksad.scan": 3, "brainwallet_numeric.scan": 3, "milksad.analyze": 1,
           "b1000_mt64.cascade.4card": 2}


def run_small(workload: str, seed: int, patch: str = "", trace: int = 0) -> dict:
    """One run of ``workload`` at its small size on the CPU, in a process of
    its own: (its exit code, its result line or None, its standard error)."""
    code = (
        "import json, sys; from portbench import run; "
        f"sys.exit(run.main(sys.argv[1:], device='cpu', overrides=json.loads({json.dumps(json.dumps(SMALL[workload]))}), "
        f"patch={patch!r} or None))")
    p = subprocess.run([sys.executable, "-c", code, "--workload", workload, "--seed", str(seed),
                        "--seconds", str(SECONDS[workload]), "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return {"rc": p.returncode, "result": result, "stderr": p.stderr}
