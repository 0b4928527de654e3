"""``BENCHMARK.json`` keeps to the rules its readers hold it to: names,
units and texts of the allowed characters, the keys of each entry, every
file it names present under ``paths``, and the limits on counts, bounds and
the run's length."""

import json
import re

import pytest

from portbench.harness import PKG, ROOT, load_json

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|_rank$|head|expansion"
                   r"|experts_per_tok)")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") for w in BENCH["command"])


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_texts():
    names = ([c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    assert len({c["name"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert TEXT.match(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert TEXT.match(e["why"])
    for c in BENCH["configs"]:
        assert TEXT.match(c["source"]) and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])


def test_counts_and_sources():
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    configs = {c["name"] for c in BENCH["configs"]}
    used = set()
    pairs = set()
    for w in BENCH["workloads"]:
        used.add(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mine = [m["name"] for m in e2e.values() if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [])]
        assert layer and all(m["moves"] in mine for m in layer)
    assert used == configs


def test_files_are_where_the_names_say():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = load_json(ROOT / c["file"])
        assert cfg["name"] == c["name"] and (ROOT / cfg["reference"]).is_file()
        assert "assumed" in cfg
    for w in BENCH["workloads"]:
        tr = load_json(PKG / "traffic" / f"{w['traffic']}.json")
        assert (PKG / "drivers" / f"{tr['driver']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file()
    for p in PKG.rglob("*"):
        if "__pycache__" not in p.parts:
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(p.relative_to(ROOT))), p


@pytest.mark.parametrize("cells", [len(BENCH["workloads"]), 24])
def test_a_full_check_fits_its_time(cells):
    r = BENCH["run_seconds"]
    assert 1 <= r <= 51
    runs = 2 + 14 * cells
    assert runs * (r + 60) + cells * 2 * 90 + 1200 <= 43200
