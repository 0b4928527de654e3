"""``chip_smoke.py``'s phase selection on the CPU: the tags ``--phases``
takes, the run's order, and the kernels line a selection prints (only the
kernels whose times the phases took, each launched on a main-path run)."""

import pytest

import chip_smoke


def test_every_phase_without_the_option():
    tags = chip_smoke.parse_phases([])
    assert tags == [tag for tag, _, _ in chip_smoke.PHASES] and len(tags) == len(set(tags))
    assert {"7b", "7f", "10a", "10b"} <= set(tags)


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
