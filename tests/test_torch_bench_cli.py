"""The port's ``bench`` and ``--no-tpu`` against the JAX command line.

``bench`` prints what ``vuke_tpu.benchmark.run_benchmark`` prints for the
same result, takes the same options with the same defaults, and runs the
string-only transforms (electrum, multibit, bitimage) over decimal strings
as the JAX function does.  ``--no-tpu`` before any subcommand runs the
device commands on the CPU through the plain versions; ``single`` and
``query`` ignore it.  Every run here is short: the timed windows are a
tenth of a second and the batches a few inputs."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
from click.testing import CliRunner

import vuke_tpu.benchmark as jbenchmark
from vuke_tpu.cli import cli as jcli
from vuke_tpu_torch import benchmark, cli

ROOT = Path(__file__).resolve().parents[1]
RESULT = {"transform": "electrum", "inputs_per_sec": 1234567.891, "keys_per_sec": 24691357.82,
          "batch": 1000, "iterations": 42, "elapsed_secs": 5.0123}
THREE_LINES = (r"Benchmark: {name}\n  \d+\.\d\d M inputs/sec \(\d+\.\d\d M keys/sec\)\n"
               r"  batch={batch} iters=\d+ elapsed=\d+\.\d\ds\n")


def jax_run(argv):
    res = CliRunner().invoke(jcli, argv)
    assert res.exception is None or isinstance(res.exception, SystemExit), res.exception
    return res.exit_code, res.stdout


def port_run(argv, capsys):
    capsys.readouterr()
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture
def fixed_result(monkeypatch):
    """Both packages' ``bench_transform`` replaced by one returning
    ``RESULT``; each call's arguments recorded."""
    calls = {"jax": [], "port": []}

    def fake(who):
        def bench_transform(transform, **kw):
            calls[who].append((transform, kw["batch"], kw["measure_s"]))
            return dict(RESULT)
        return bench_transform

    monkeypatch.setattr(jbenchmark, "bench_transform", fake("jax"))
    monkeypatch.setattr(benchmark, "bench_transform", fake("port"))
    return calls


@pytest.mark.parametrize("as_json", [False, True])
def test_printer_matches_run_benchmark(fixed_result, capsys, as_json):
    """One result dict, both printers: the same text, or the same JSON
    object."""
    jbenchmark.run_benchmark("electrum", as_json=as_json, batch=1000, seconds=5.0)
    want = capsys.readouterr().out
    benchmark.run_benchmark("electrum", as_json=as_json, batch=1000, seconds=5.0)
    got = capsys.readouterr().out
    assert got == want
    if as_json:
        assert list(json.loads(got)) == ["transform", "inputs_per_sec", "keys_per_sec", "batch",
                                         "iterations", "elapsed_secs"]
    else:
        assert got.splitlines()[0] == "Benchmark: electrum"


@pytest.mark.parametrize("argv", [
    [],
    ["--json"],
    ["--transform", "electrum", "--seconds", "0.5"],
    ["--transform", "md5", "--transform", "multibit", "--batch", "7", "--json"],
    ["--transform", "electrum:change", "--batch", "3", "--seconds", "2"],
])
def test_bench_command_matches_jax(fixed_result, capsys, argv):
    """The options, their defaults (sha256, 65536, 5 s) and the last of a
    repeated ``--transform`` reach ``bench_transform`` as the JAX command
    passes them, and stdout is the same."""
    assert port_run(["bench"] + argv, capsys) == jax_run(["bench"] + argv)
    assert fixed_result["port"] == fixed_result["jax"] and len(fixed_result["port"]) == 1


@pytest.mark.parametrize("name, slots", [("electrum", 20), ("multibit", 20), ("bitimage", 1),
                                         ("sha256", 3), ("milksad", 1)])
def test_bench_transform_on_the_cpu(name, slots):
    """``bench_transform`` on the plain versions: keys/s is inputs/s times
    the slots; a string transform's batch is at most 1000 (as
    ``tests/test_cli.py::test_bench_transform_electrum`` holds the JAX one)."""
    r = benchmark.bench_transform(name, batch=2, warmup_s=0.0, measure_s=0.01, device="cpu")
    assert list(r) == list(RESULT)
    assert r["transform"] == name and r["batch"] == 2 and r["iterations"] >= 1
    assert r["inputs_per_sec"] > 0 and r["keys_per_sec"] == r["inputs_per_sec"] * slots


@pytest.mark.parametrize("name, batch, want", [("multibit", 5000, 1000), ("md5", 1500, 1500)])
def test_only_string_batches_are_capped(name, batch, want):
    """At most 1000 strings a call (the forward drivers' string batch); a
    numeric transform takes the whole batch."""
    assert benchmark.bench_transform(name, batch=batch, warmup_s=0.0, measure_s=0.01,
                                     device="cpu")["batch"] == want


@pytest.mark.parametrize("argv, name, batch", [
    (["--transform", "multibit", "--batch", "2", "--seconds", "0.1"], "multibit", 2),
    (["--transform", "bitimage", "--batch", "2", "--seconds", "0.1"], "bitimage", 2),
    (["--transform", "sha256", "--batch", "64", "--seconds", "0.1", "--json"], "sha256", 64),
])
def test_no_tpu_bench_prints_the_jax_lines(capsys, argv, name, batch):
    """``--no-tpu bench`` runs on the CPU, 2 s of warm-up and the window."""
    rc, out = port_run(["--no-tpu", "bench"] + argv, capsys)
    assert rc == 0
    if "--json" in argv:
        r = json.loads(out)
        assert list(r) == list(RESULT) and r["transform"] == name and r["batch"] == batch
    else:
        assert re.fullmatch(THREE_LINES.format(name=name, batch=batch), out), out


def test_no_tpu_bench_electrum_as_a_module():
    """``python -m vuke_tpu_torch --no-tpu bench --transform electrum``: no
    AttributeError, exit 0, the three lines."""
    res = subprocess.run([sys.executable, "-m", "vuke_tpu_torch", "--no-tpu", "bench",
                          "--transform", "electrum", "--batch", "2", "--seconds", "0.1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert re.fullmatch(THREE_LINES.format(name="electrum", batch=2), res.stdout), res.stdout


@pytest.mark.parametrize("argv", [
    ["generate", "range", "--start", "0", "--end", "1"],
    ["scan", "--targets", "t.txt", "range", "--start", "0", "--end", "1"],
    ["warmup"],
    ["analyze", "0x1234"],
    ["bench"],
    ["single", "abc"],
    ["query", "st", "SELECT 1"],
])
@pytest.mark.parametrize("no_tpu", [False, True])
def test_no_tpu_is_accepted_before_every_command(argv, no_tpu):
    """``--no-tpu`` routes the device commands to the CPU and is ignored by
    ``single`` and ``query``; without it every device command stays on
    the card."""
    args = cli.parse_args((["--no-tpu"] if no_tpu else []) + argv)
    assert args.no_tpu is no_tpu
    if argv[0] in ("single", "query"):
        assert not hasattr(args, "device")
    else:
        assert args.device == ("cpu" if no_tpu else "cuda")


@pytest.mark.parametrize("argv", [
    ["single", "correct horse battery staple"],
    ["single", "hello", "--transform", "md5", "--network", "testnet"],
])
def test_no_tpu_single_matches_jax(capsys, argv):
    """``single`` is host-only: the same stdout with ``--no-tpu``, byte for
    byte, as the JAX command's."""
    got = port_run(["--no-tpu"] + argv, capsys)
    assert got == jax_run(["--no-tpu"] + argv) and got[0] == 0
    assert got == port_run(argv, capsys)


def test_no_tpu_generate_is_device_cpu(capsys, monkeypatch):
    """``--no-tpu generate`` gives the bytes of ``generate --device cpu``,
    which ``tests/test_torch_generate.py`` holds against the JAX command."""
    monkeypatch.setenv("VUKE_STRING_PAD", "64")
    src = ["--transform", "sha256", "--transform", "md5", "--batch", "64", "range", "--start",
           "0", "--end", "40"]
    capsys.readouterr()
    assert cli.main(["--no-tpu", "generate"] + src) == 0
    no_tpu = capsys.readouterr()
    assert cli.main(["generate", "--device", "cpu"] + src) == 0
    assert capsys.readouterr() == no_tpu and no_tpu.out.count("\n") == 41 * 4


@pytest.mark.parametrize("argv, called", [
    (["--derive"], ["bench_derive"]),
    (["--derive", "--profile"], ["bench_derive", "profile_derive"]),
    (["--profile"], ["bench_derive", "profile_derive"]),
    (["--sequential"], ["bench_sequential"]),
    (["--derive", "--sequential", "--profile", "--batch", "4096"],
     ["bench_sequential", "profile_sequential"]),
])
def test_the_ports_own_benches_stay_behind_their_flags(capsys, monkeypatch, argv, called):
    """The derive rate a bare ``bench`` gave moved to ``--derive``;
    ``--sequential`` and ``--profile`` keep their meaning: one JSON line
    each, at the port's default batch unless ``--batch`` is given."""
    seen = []
    for name in ("bench_derive", "profile_derive", "bench_sequential", "profile_sequential"):
        monkeypatch.setattr(benchmark, name,
                            lambda batch, name=name: seen.append((name, batch)) or {"f": name})
    rc, out = port_run(["bench"] + argv, capsys)
    batch = 4096 if "--batch" in argv else 1 << 19
    assert rc == 0 and seen == [(name, batch) for name in called]
    assert [json.loads(line)["f"] for line in out.splitlines()] == called


@pytest.mark.parametrize("flag", [["--derive"], ["--profile"], ["--sequential"],
                                  ["--scan", "sha256"], ["--generate", "sha256"],
                                  ["--strings", "sha256"], ["--analyze", "lcg"],
                                  ["--wallet", "electrum"]])
def test_the_ports_own_benches_refuse_no_tpu(capsys, flag):
    """They measure the card; with ``--no-tpu`` they stop with a usage
    error rather than run on the card or fall back to the CPU."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--no-tpu", "bench"] + flag)
    assert e.value.code == 2 and "measure the card" in capsys.readouterr().err
