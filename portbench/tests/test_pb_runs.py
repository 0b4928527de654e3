"""Whole runs of each cell on the CPU at a small size, through the
program's plain versions: a sound run is correct; a run with its control,
or with the timed path broken underneath in each way the cell can be, is
not; and no run loads JAX or the JAX package."""

import sys

import pytest

from portbench.controls import BY_DRIVER
from portbench.harness import BANNED, Cell, ROOT, banned_modules, load_json
from portbench.tests.small import SMALL, run_small

SEED = 4294967311          # above 2^32: the driver's seeds are large
FAULTS = {
    "milksad.scan": ["scan_step_unchanged", "scan_half_batch", "scan_lane_altered"],
    "brainwallet_numeric.scan": ["scan_step_unchanged", "scan_half_batch", "scan_lane_altered"],
    "milksad.analyze": ["sweep_unchanged", "sweep_half_batch", "sweep_seed_altered"],
    "b1000_mt64.cascade.4card": ["no_exchange", "sweep_unchanged", "sweep_half_batch",
                                 "sweep_seed_altered"],
}
CELLS = list(FAULTS)


def upper_half_seed(workload: str) -> int:
    """A run seed whose first due planted seed lies in the upper half of
    its sweep batch, so that a fault that drops half a batch must miss it."""
    from portbench.drivers import analyze, dsweep

    cell = Cell.load(load_json(ROOT / "BENCHMARK.json"), workload)
    cell.config.update(SMALL[workload].get("config", {}))
    cell.traffic.update(SMALL[workload]["traffic"])
    cell.load_reference()
    B = cell.traffic["batch"]
    for seed in range(SEED, SEED + 64):
        if workload == "milksad.analyze":
            off = analyze.plan(cell, seed)[0][1] - cell.config["seed_space"][0]
        else:
            start, _, p = dsweep.plan(cell, seed)[0]
            off = (p - start) % (cell.traffic["job_seeds"] // cell.traffic["ranks"])
        if off % B >= B // 2:
            return seed
    raise AssertionError("no seed found")


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    r = run_small(workload, SEED)
    assert r["rc"] == 0, r["stderr"][-3000:]
    res = r["result"]
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["checks"]["planted_due"]["value"] >= 1
    assert list(res)[-1] == "checks"
    assert res["metrics"]["setup_s"]["value"] > 0
    assert r["stderr"].rstrip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", ["milksad.scan", "milksad.analyze",
                                      "b1000_mt64.cascade.4card"])
def test_traced_run_reads_its_layers(workload):
    r = run_small(workload, SEED + 1, trace=1)
    assert r["rc"] == 0, r["stderr"][-3000:]
    res = r["result"]
    assert res["correct"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    # the CPU has no device trace: only the host's spans can be read here
    for name, m in res["metrics"].items():
        assert name in ("pipeline.host_issue_ms", "dist.reduce_ms_per_round")
        assert m["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    driver = Cell.load(load_json(ROOT / "BENCHMARK.json"), workload).traffic["driver"]
    r = run_small(workload, SEED, patch="portbench.controls:" + BY_DRIVER[driver])
    assert r["rc"] == 0, r["stderr"][-3000:]
    assert r["result"]["correct"] is False


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS for f in FAULTS[w]])
def test_fault_is_not_correct(workload, fault):
    seed = upper_half_seed(workload) if fault == "sweep_half_batch" else SEED
    r = run_small(workload, seed, patch="portbench.tests.faults:" + fault)
    assert r["rc"] == 0, r["stderr"][-3000:]
    assert r["result"]["correct"] is False


def test_banned_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vuke_tpu_torch_lookalike", sys)
    assert "vuke_tpu" not in banned_modules()
    for name in BANNED:
        monkeypatch.setitem(sys.modules, name + ".sub", sys)
        assert name in banned_modules()


def test_a_run_fails_where_jax_is_loaded():
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax'); "
            "from portbench import run; from portbench.tests.small import SMALL; "
            "sys.exit(run.main(sys.argv[1:], device='cpu', overrides=SMALL['milksad.analyze']))")
    import subprocess
    p = subprocess.run([sys.executable, "-c", code, "--workload", "milksad.analyze", "--seed",
                        "5", "--seconds", "0.2"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 3 and not p.stdout.strip()
    assert "jax" in p.stderr


def test_a_run_fails_where_another_rank_loads_jax():
    """The four-rank cell: rank 1 alone holds ``jax``; rank 0 prints no
    result and names it."""
    r = run_small("b1000_mt64.cascade.4card", SEED, patch="portbench.tests.faults:jax_on_rank_1")
    assert r["rc"] == 3 and r["result"] is None
    assert "rank 1: jax" in r["stderr"]


def test_no_card_no_result():
    """Asked for the card where there is none, a run exits non-zero and
    prints no result."""
    import subprocess
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "milksad.scan",
                        "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and not p.stdout.strip()


def test_runs_load_neither_jax_nor_the_jax_package():
    """Every module a run loads, in a process of its own that imports
    nothing else first."""
    import subprocess

    code = ("import sys; from portbench import run; from portbench.tests.small import SMALL; "
            "rc = run.main(sys.argv[1:], device='cpu', overrides=SMALL['milksad.scan']); "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'vuke_tpu'}); print('BANNED', bad); sys.exit(rc or bool(bad))")
    p = subprocess.run([sys.executable, "-c", code, "--workload", "milksad.scan", "--seed", "5",
                        "--seconds", "0.2"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "BANNED []" in p.stdout
