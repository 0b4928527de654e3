"""``chip_smoke.py``'s phase selection on the CPU: the tags ``--phases``
takes, the run's order, and the kernels line a selection prints (only the
kernels whose times the phases took, each launched on a main-path run)."""

import pytest

import chip_smoke


def test_every_phase_without_the_option():
    tags = chip_smoke.parse_phases([])
    assert tags == [tag for tag, _, _ in chip_smoke.PHASES] and len(tags) == len(set(tags))
    assert {"7b", "7f", "10a", "10b", "11"} <= set(tags)
    assert tags[-1] == "11" and chip_smoke.parse_phases(["--phases", "11"]) == ["11"]


def test_a_selection_runs_in_the_run_order():
    assert chip_smoke.parse_phases(["--phases", "10a,7b"]) == ["7b", "10a"]
    assert chip_smoke.parse_phases(["--phases", " 7f , 7b,"]) == ["7b", "7f"]


@pytest.mark.parametrize("arg", ["99", "7b,x", ",", ""])
def test_an_unknown_phase_is_refused(arg):
    with pytest.raises(SystemExit) as e:
        chip_smoke.parse_phases(["--phases", arg])
    assert e.value.code == 2


def _run(times, runs):
    r = chip_smoke.Run(None, "card", 1.0, {})
    for name in times:
        r.kernel(name, (0, (0.1, 1.0, 0.05, "operations")))
    r.runs = runs
    return r


def test_the_kernels_line_of_a_selection():
    """7b and 10a time D2 and E1: the line lists those two, with every key
    and their main-path launches."""
    r = _run(["p2pkh", "records"], [{"p2pkh": 3, "records": 0}, {"p2pkh": 0, "records": 1}])
    line = chip_smoke.kernels_line(r, every=False)["kernels"]
    assert [row["name"] for row in line] == ["p2pkh", "records"]
    assert [row["launches"] for row in line] == [3, 1]
    assert set(line[0]) == {"name", "route", "source", "replaces", "launches", "max_abs_err",
                            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


def test_a_kernel_without_a_launch_fails():
    r = _run(["p2pkh", "records"], [{"p2pkh": 0, "records": 1}])
    with pytest.raises(AssertionError, match="p2pkh was launched no time"):
        chip_smoke.kernels_line(r, every=False)


def test_a_kernel_held_but_not_timed_is_left_out():
    """3b holds K1-K6 against plain and 6 times them: 6 alone lists none."""
    r = _run([], [{"smul": 4}])
    r.times["smul"] = (0.1, 1.0, 0.05, "operations")
    assert chip_smoke.kernels_line(r, every=False) == {"kernels": []}
    r.errs["smul"] = 0
    assert [row["launches"] for row in chip_smoke.kernels_line(r, every=False)["kernels"]] == [4]


def test_the_whole_run_needs_every_kernel():
    r = _run(["p2pkh"], [{"p2pkh": 1}])
    with pytest.raises(AssertionError, match="no times for"):
        chip_smoke.kernels_line(r, every=True)


@pytest.mark.parametrize("seed, want", [
    ((1 << 32) - 17, [1 << 31, 1 << 31]),            # rank 1's last batch: every round
    (5 * (1 << 24) + 3, [6 << 24, 8 << 24]),          # rank 0's first round: one round each
    ((1 << 31) + (9 << 24), [2 << 27, (1 << 27) + (2 << 24)]),   # rank 1's second round
])
def test_phase_11_protocol_model(seed, want):
    """11a's expected searched counts: milksad's 2^32 seeds over 2 ranks at
    batch 2^24, rounds of 8 batches."""
    assert chip_smoke.protocol_searched(0, (1 << 32) - 1, 2, 1 << 24, seed) == want


def test_phase_11_protocol_model_at_a_shard_end():
    """Batches clipped by a shard's end: [0, 4096] at batch 1024, rounds of
    8 batches over 2 ranks (2049 and 2048 seeds)."""
    assert chip_smoke.protocol_searched(0, 4096, 2, 1024, 2048) == [2049, 2048]
    assert chip_smoke.protocol_searched(0, 4096, 2, 1024, 4096) == [2049, 2048]
