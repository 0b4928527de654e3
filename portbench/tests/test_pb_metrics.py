"""Each per-layer metric's reader on a synthetic trace record, and on one
with nothing to read (it returns nothing, never 0)."""

import pytest

from portbench import work
from portbench.harness import PKG, Trace, load_json, load_module, ROOT

BENCH = load_json(ROOT / "BENCHMARK.json")
NAMES = [m["name"] for m in BENCH["per_layer"]]


def reader(name):
    return load_module(PKG / "metrics" / f"{name}.py", "m_" + name.replace(".", "_"))


def scan_record():
    ops = {"mt19937_kernel": (0.02, 256), "normalize_kernel": (0.004, 256),
           "smul_kernel": (1.0, 256), "inv_affine_kernel": (0.1, 256),
           "hash160_kernel": (0.09, 256), "at::native::searchsorted_cuda_kernel": (0.1, 512)}
    trace = Trace(window_s=1.5, busy_s=1.35, ops=ops, under={"matcher": 0.128},
                  gaps=[("stats.wait", 0.1), ("window", 0.05)])
    return {"trace": trace, "spans": {"ScanProgram.run": {"seconds": 0.512, "calls": 256}},
            "seeds": 256 << 19, "superbatches": 256, "slots": 1,
            "derive_bound_s": work.derive_seconds(work.mt19937(), 256 << 19, 1)}


def sweep_record():
    trace = Trace(window_s=2.0, busy_s=1.8, ops={"sweep_prng_kernel": (1.75, 1024)},
                  gaps=[("analyze", 0.2)])
    return {"trace": trace, "spans": {"analyze": {"seconds": 1.9, "calls": 8},
                                      "all_hosts_any": {"seconds": 0.05, "calls": 100}},
            "keys": 8, "sweep": {"family": "milksad", "mode": "exact", "seeds_per_chip": 1 << 34}}


def test_every_per_layer_metric_has_a_reader():
    for name in NAMES:
        assert callable(reader(name).read)


def test_scan_readers():
    rec = scan_record()
    assert reader("pipeline.host_issue_ms").read(rec) == pytest.approx(2.0)
    assert reader("matcher.device_ms").read(rec) == pytest.approx(0.5)
    assert reader("device.idle_pct.scan").read(rec) == pytest.approx(10.0)
    bound = work.derive_seconds(work.mt19937(), 256 << 19, 1)
    assert reader("derive_roofline").read(rec) == pytest.approx(100 * bound / 1.214)


def test_sweep_readers():
    rec = sweep_record()
    assert reader("analyze.host_ms_per_key").read(rec) == pytest.approx(1e3 * 0.1 / 8)
    assert reader("device.idle_pct.analyze").read(rec) == pytest.approx(10.0)
    assert reader("device.idle_pct.cascade").read(rec) == pytest.approx(10.0)
    assert reader("dist.reduce_ms_per_round").read(rec) == pytest.approx(0.5)
    bound = work.sweep_prng("milksad", "exact", (1.0, 0.0)).seconds(1 << 34)
    assert reader("sweep_roofline").read(rec) == pytest.approx(100 * bound / 1.75)
    assert reader("cascade_roofline").read(rec) == pytest.approx(100 * bound / 1.75)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_nothing(name):
    empty = {"trace": Trace(window_s=1.0, busy_s=0.0), "spans": {}, "seeds": 0,
             "superbatches": 0, "slots": 1, "derive_bound_s": 0.0, "keys": 0,
             "sweep": {"family": "milksad", "mode": "exact", "seeds_per_chip": 0}}
    assert reader(name).read(empty) is None
    assert reader(name).read({}) is None


def test_trace_merge_and_breakdown():
    a = Trace(1.0, 0.8, {"k": (0.8, 10)}, {"m": 0.1}, [("x", 0.2)])
    b = Trace(1.0, 0.6, {"k": (0.6, 10)}, {"m": 0.3}, [("x", 0.4)])
    m = Trace.merge([a, b])
    assert m.busy_s == pytest.approx(0.7) and m.ops["k"] == pytest.approx((0.7, 10))
    assert m.under["m"] == pytest.approx(0.2)
    assert m.breakdown() == {"device_ops": [["k", pytest.approx(0.7)]],
                             "idle_gaps": [["x", pytest.approx(0.3)]]}
    assert Trace.from_dict(a.to_dict()) == a
