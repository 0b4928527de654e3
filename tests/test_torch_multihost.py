"""vuke_tpu_torch's runs across processes (``parallel/multihost.py``,
``parallel/mesh.py``, ``parallel/dryrun.py`` and their callers) against the
JAX package on the CPU: ``partition_range``, the collectives in a world of
1 and of 3 gloo ranks on 127.0.0.1, ``DistributedSweep`` against the JAX
one and against the JAX ``sweeps.sweep`` run round by round under the
protocol (a planted seed in each shard, the early stop, an empty shard,
shards that need unequal rounds), ``scan`` and ``generate`` in two ranks
against the JAX command line over each rank's shard (stdout, stderr, the
``.h0``/``.h1`` checkpoint manifests), the dry run, and the device repairs
(``require_cuda``'s card, ``analyze``'s indexed device, the per-device
caches' keys).

The ranks run the plain versions (``--device cpu``).  One spawn of 3 ranks
and one of 2 run every scenario of their world, started together; every
process has a timeout of at most 60 s, so no case can hang.  The JAX
sweeps run eagerly (the ``eager`` fixture of ``test_torch_analyze.py``)."""

import json
import os
import signal
import socket
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from hypothesis import given, settings, strategies as st

import chip_smoke
import vuke_tpu.analyze.sweeps as jsweeps
import vuke_tpu.parallel.multihost as jmh
from vuke_tpu._lazy import numpy_backend
from vuke_tpu.analyze import analyzers as ja
from vuke_tpu.cli import cli as jcli
from vuke_tpu.derive import KeyDeriver as JKeyDeriver
from vuke_tpu_torch import _device, benchmark, cli
from vuke_tpu_torch import analyze as panalyze
from vuke_tpu_torch.analyze import sweeps as psweeps
from vuke_tpu_torch.ecc import field, incremental, smul, smul_w8
from vuke_tpu_torch.parallel import mesh
from vuke_tpu_torch.parallel.dryrun import free_port
from vuke_tpu_torch.parallel import multihost as pmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60
FRAME_FITS = "y" * (65536 - 8)   # '["y..."]' and its 4-byte prefix: exactly 64 KiB
ABSENT = 4_000_000_000           # a seed no sweep below reaches

# every world's sweeps: name -> (start, end, batch, round_batches, planted seed)
WORLD3_SWEEPS = {
    "shard0": (0, 1535, 64, 2, 300),           # shard 0's third round
    "shard1": (0, 1535, 64, 2, 512 + 70),      # shard 1's first round: an early stop
    "shard2": (0, 1535, 64, 2, 1024 + 500),    # shard 2's last round
    "empty": (10, 11, 64, 2, 11),              # 2 seeds over 3 ranks: rank 2's shard is empty
    "empty_absent": (10, 11, 64, 2, ABSENT),
}
WORLD2_SWEEPS = {                              # shards of 2049 and 2048: 2 rounds and 1
    "unequal_absent": (0, 4096, 1024, 2, ABSENT),
    "unequal_hit": (0, 4096, 1024, 2, 2048),
}

RANK_CODE = r"""
import contextlib, io, json, sys
from vuke_tpu_torch import cli
from vuke_tpu_torch.analyze.sweeps import SweepProgram
from vuke_tpu_torch.cores.mt19937 import milksad_key_words_plain
from vuke_tpu_torch.parallel import multihost as mh
import torch

spec = json.loads(sys.argv[1])
rank, world = mh.maybe_initialize_distributed()
out = {"init": [rank, world], "again": list(mh.maybe_initialize_distributed()),
       "index": [mh.process_index(), mh.process_count()]}
if spec["collectives"]:
    out["any"] = [mh.all_hosts_any(rank == r) for r in (-1, 0, 1, 2)]
    out["gather"] = mh.gather_results([[rank, "x" * rank], {"rank": rank}])
    out["fits"] = len(mh.gather_results([spec["fits"]]))
    try:
        mh.gather_results([spec["fits"] + "y"])
        out["too_large"] = None
    except AssertionError as e:
        out["too_large"] = str(e)
for name, (start, end, batch, rounds, seed) in spec["sweeps"].items():
    words = milksad_key_words_plain(torch.tensor([seed], dtype=torch.uint32))[:, 0].tolist()
    prog = SweepProgram("milksad", "exact", batch=batch, device="cpu")
    out[name] = list(mh.DistributedSweep(prog, round_batches=rounds).run(
        start, end, target_words=words))
for name, argv in spec["commands"].items():
    o, e = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        rc = cli.main(argv)
    out[name] = [rc, o.getvalue(), e.getvalue()]
print(json.dumps(out))
"""


@pytest.fixture
def eager(monkeypatch):
    """The JAX sweeps unjitted, their keystreams in eager numpy."""
    monkeypatch.setattr(jsweeps, "jax", types.SimpleNamespace(jit=lambda f: f))
    with numpy_backend():
        yield


def start_world(n: int, spec: dict, port: int | None = None, ranks=None) -> list:
    """The rank processes (``ranks``, default all ``n``) of a world of ``n``
    running ``RANK_CODE`` with the JAX_* variables."""
    port = free_port() if port is None else port
    procs = []
    for rank in range(n) if ranks is None else ranks:
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES=str(n), JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, "-c", RANK_CODE, json.dumps(spec)],
                                      cwd=REPO, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True,
                                      start_new_session=True))
    return procs


def finish_now(procs: list) -> None:
    """Kill each process's group (its own ranks too) if it still runs."""
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


def finish(procs: list) -> list:
    """Each process's (rc, stdout, stderr) within ``TIMEOUT_S``; every
    process is killed past it."""
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
        return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]
    finally:
        finish_now(procs)


def milksad_words(seed: int) -> np.ndarray:
    return np.array(ja.key_bytes_to_words(chip_smoke.host_milksad_key(seed)), dtype=np.uint32)


def jax_protocol(start: int, end: int, world: int, batch: int, rounds: int, seed: int):
    """The JAX ``partition_range`` and ``sweeps.sweep`` (eager), run round
    by round under the protocol: every rank sweeps its next round while it
    has seeds left, all stop after the first round in which any found one.
    (the smallest seed found or None, each rank's searched)."""
    prog = jsweeps.SweepProgram(ja.MilksadAnalyzer._keystream, "exact", batch=batch)
    shards = jmh.partition_range(start, end, world)
    pos, searched, found = [s.start for s in shards], [0] * world, []
    while any(p <= s.end for p, s in zip(pos, shards)) and not found:
        for h, s in enumerate(shards):
            if pos[h] <= s.end:
                round_end = min(s.end, pos[h] + batch * rounds - 1)
                r = jsweeps.sweep(prog, pos[h], round_end, target_words=milksad_words(seed))
                searched[h] += int(r.searched)
                found += [int(r.seed)] if r.found else []
                pos[h] = round_end + 1
    return (min(found) if found else None), searched


def _targets(path, seeds) -> str:
    path.write_text("".join(JKeyDeriver().derive(chip_smoke.host_milksad_key(s)).p2pkh_compressed
                            + "\n" for s in seeds))
    return str(path)


def _commands(tmp) -> dict:
    targets = _targets(tmp / "targets.txt", (1010, 1100))
    return {
        "generate": ["generate", "--transform", "sha256", "--device", "cpu", "--batch", "64",
                     "--checkpoint", str(tmp / "gen.ckpt"), "range", "--start", "0",
                     "--end", "127"],
        "scan": ["scan", "--transform", "milksad", "--device", "cpu", "--targets", targets,
                 "--batch", "64", "--checkpoint", str(tmp / "scan.ckpt"), "range", "--start",
                 "1000", "--end", "1127"],
    }


def dryrun(*args) -> list:
    return [subprocess.Popen([sys.executable, "-m", "vuke_tpu_torch.parallel.dryrun", *args],
                             cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, start_new_session=True)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 3-rank world (collectives, sweeps), the 2-rank world (unequal
    rounds, scan and generate), a rank whose store port is taken and the
    dry run of 2 ranks, started together: {name: [(rc, stdout, stderr) a
    process]}."""
    tmp = tmp_path_factory.mktemp("ranks")
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    started = {}
    try:
        started["world3"] = start_world(3, {"collectives": True, "fits": FRAME_FITS,
                                            "sweeps": WORLD3_SWEEPS, "commands": {}})
        started["world2"] = start_world(2, {"collectives": False, "sweeps": WORLD2_SWEEPS,
                                            "commands": _commands(tmp)})
        started["taken"] = start_world(2, {"collectives": False, "sweeps": {}, "commands": {}},
                                       port=taken.getsockname()[1], ranks=[0])
        started["dryrun"] = dryrun("2", "--device", "cpu", "--timeout", "50")
        done = {name: finish(procs) for name, procs in started.items()}
    finally:
        taken.close()
        for procs in started.values():     # past a timeout: the other worlds too
            finish_now(procs)
    done["tmp"] = tmp
    return done


def results(worlds, name: str) -> list:
    ranks = worlds[name]
    assert [rc for rc, _, _ in ranks] == [0] * len(ranks), [err[-3000:] for _, _, err in ranks]
    return [json.loads(out.splitlines()[-1]) for _, out, _ in ranks]


# --- partition_range and RangeShard ---

@settings(max_examples=300, deadline=None)
@given(start=st.integers(0, (1 << 64) - 1), count=st.integers(0, 1 << 40),
       n_hosts=st.integers(1, 64), data=st.data())
def test_partition_range_matches_jax(start, count, n_hosts, data):
    end = min(start + count - 1, (1 << 64) - 1)
    host = data.draw(st.integers(0, n_hosts - 1))
    want = jmh.partition_range(start, end, n_hosts)
    got = pmh.partition_range(start, end, n_hosts)
    assert [(s.start, s.end, s.count) for s in got] == [(s.start, s.end, s.count) for s in want]
    assert pmh.partition_range(start, end, n_hosts, host) == got[host]


@pytest.mark.parametrize("start, end, n_hosts", [
    (0, 2, 5),                          # a total below n_hosts: empty trailing shards
    (10, 11, 3),
    (0, (1 << 64) - 1, 8),              # end = 2^64 - 1
    ((1 << 64) - 5, (1 << 64) - 1, 3),
    (7, 7, 1), (7, 7, 4),               # one seed
    (0, 4096, 2),                       # 2049 and 2048 seeds
])
def test_partition_range_edges_match_jax(start, end, n_hosts):
    want = [(s.start, s.end, s.count) for s in jmh.partition_range(start, end, n_hosts)]
    got = [(s.start, s.end, s.count) for s in pmh.partition_range(start, end, n_hosts)]
    assert got == want
    assert sum(c for *_, c in got) == end - start + 1
    assert pmh.RangeShard(5, 4).count == jmh.RangeShard(5, 4).count == 0


# --- the collectives ---

def test_one_process_collectives_match_jax(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert pmh.maybe_initialize_distributed() == (0, 1)
    assert (pmh.process_index(), pmh.process_count()) == (0, 1)
    items = [{"seed": 5}, [1, "a"], None]
    big = ["z" * (1 << 17)]                 # past the frame: one process makes no check
    for flag in (True, False, 0, 3):
        assert pmh.all_hosts_any(flag) == jmh.all_hosts_any(flag)
    assert pmh.gather_results(items) == jmh.gather_results(items) == items
    assert pmh.gather_results(big) == jmh.gather_results(big) == big
    assert pmh.gather_results(items) is not items


def test_frame_limit_matches_jax_gather(monkeypatch):
    """The JAX gather in a faked world of 3: the same items back, and the
    same assertion one byte past the frame."""
    from jax.experimental import multihost_utils

    monkeypatch.setattr(jax, "process_count", lambda: 3)
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda b: np.stack([b] * 3))
    assert jmh.gather_results([FRAME_FITS]) == [FRAME_FITS] * 3
    with pytest.raises(AssertionError, match="hit payload too large for gather frame"):
        jmh.gather_results([FRAME_FITS + "y"])


def test_world_of_three_collectives(worlds):
    """Ranks, the OR over ranks, items gathered in rank order, the 64 KiB
    frame's edge and its assertion on every rank."""
    res = results(worlds, "world3")
    gathered = [x for r in range(3) for x in ([r, "x" * r], {"rank": r})]
    for rank, r in enumerate(res):
        assert r["init"] == r["again"] == r["index"] == [rank, 3]
        assert r["any"] == [False, True, True, True]
        assert r["gather"] == gathered
        assert r["fits"] == 3
        assert r["too_large"] == "hit payload too large for gather frame"


# --- DistributedSweep ---

def test_distributed_sweep_one_process_matches_jax(eager):
    """``tests/test_parallel.py``'s case: seed 5000 in [0, 8191], batch 4096,
    rounds of 2 batches."""
    key = chip_smoke.host_milksad_key(5000)
    jprog = jsweeps.SweepProgram(ja.MilksadAnalyzer._keystream, "exact", batch=1 << 12)
    want = jmh.DistributedSweep(jprog, round_batches=2).run(0, 8191,
                                                            target_words=milksad_words(5000))
    prog = psweeps.SweepProgram("milksad", "exact", batch=1 << 12, device="cpu")
    got = pmh.DistributedSweep(prog, round_batches=2).run(
        0, 8191, target_words=ja.key_bytes_to_words(key))
    assert got == (want[0], int(want[1])) == (5000, 8192)


@pytest.mark.parametrize("name", sorted(WORLD3_SWEEPS))
def test_world_of_three_sweeps_follow_the_protocol(name, worlds, eager):
    """Each rank's (found, searched) is the JAX protocol's: the planted
    seed in each shard, the stop after the round that found it, and the
    empty shard that runs no round but joins each reduce."""
    start, end, batch, rounds, seed = WORLD3_SWEEPS[name]
    found, searched = jax_protocol(start, end, 3, batch, rounds, seed)
    assert [r[name] for r in results(worlds, "world3")] == [[found, s] for s in searched]
    if name.startswith("empty"):
        one = psweeps.sweep(psweeps.SweepProgram("milksad", "exact", batch=batch, device="cpu"),
                            start, end, target_words=ja.key_bytes_to_words(
                                chip_smoke.host_milksad_key(seed)))
        assert (found, sum(searched)) == (one.seed, one.searched)
        assert searched[2] == 0


@pytest.mark.parametrize("name", sorted(WORLD2_SWEEPS))
def test_unequal_rounds_finish_with_one_process_results(name, worlds, eager):
    """[0, 4096] at batch 1024, 2 rounds over 2 ranks: rank 0 needs two
    rounds, rank 1 one (the JAX protocol's reduces would not pair up).  The
    run finishes, with the JAX protocol's counts and a one-process run's
    seed."""
    start, end, batch, rounds, seed = WORLD2_SWEEPS[name]
    found, searched = jax_protocol(start, end, 2, batch, rounds, seed)
    assert [r[name] for r in results(worlds, "world2")] == [[found, s] for s in searched]
    assert searched == [2049, 2048]
    one = psweeps.sweep(psweeps.SweepProgram("milksad", "exact", batch=batch, device="cpu"),
                        start, end, target_words=ja.key_bytes_to_words(
                            chip_smoke.host_milksad_key(seed)))
    assert found == one.seed


def test_dispatch_sweep_takes_the_distributed_branch(monkeypatch):
    """``process_count() > 1`` and no checkpoint: ``DistributedSweep`` with
    its default rounds, the result as the JAX package builds it."""
    calls = []

    class Fake:
        def __init__(self, program, round_batches=8):
            calls.append(round_batches)

        def run(self, start, end, target_words=None, progress=None, decode=None):
            calls.append((start, end))
            return 7, 1234

    monkeypatch.setattr(pmh, "process_count", lambda: 2)
    monkeypatch.setattr(pmh, "DistributedSweep", Fake)
    r = psweeps.dispatch_sweep(object(), 0, 99, max_seeds=50)
    assert calls == [8, (0, 49)]
    assert (r.found, r.seed, r.searched, r.cascade_hits) == (True, 7, 1234, 0)


# --- scan and generate in two ranks against the JAX command line ---

@pytest.mark.parametrize("name", ["generate", "scan"])
def test_two_rank_commands_match_jax_per_shard(name, worlds):
    """Each rank's stdout and stderr are the JAX command line's over that
    rank's shard, its stderr with the ``Host i/2`` line after
    ``Scanning...``/``Generating keys...``; its checkpoint manifest is
    ``PATH.h{i}``, with the job id of the shard, the JAX run's manifest."""
    argv = _commands(worlds["tmp"])[name]
    ranks = [r[name] for r in results(worlds, "world2")]
    start, end = int(argv[-3]), int(argv[-1])
    ckpt = argv[argv.index("--checkpoint") + 1]
    for rank, (rc, out, err) in enumerate(ranks):
        shard = jmh.partition_range(start, end, 2, rank)
        host = f"Host {rank}/2: seeds [{shard.start}, {shard.end}]\n"
        jckpt = os.path.join(worlds["tmp"], f"jax.{name}.{rank}")
        jargv = [a for a in argv[:-4] if a not in ("--device", "cpu")]
        jargv[jargv.index(ckpt)] = jckpt
        res = CliRunner().invoke(jcli, jargv + ["--start", str(shard.start), "--end",
                                                str(shard.end)])
        assert res.exit_code == 0, res.output
        first, rest = res.stderr.split("\n", 1) if name == "generate" else \
            res.stderr.split("Scanning...\n", 1)
        head = first + "\n" if name == "generate" else first + "Scanning...\n"
        assert (rc, out, err) == (0, res.stdout, head + host + rest)
        with open(f"{ckpt}.h{rank}") as f, open(jckpt) as g:
            manifest = json.load(f)
            assert manifest == json.load(g)
        assert manifest["job_id"].endswith(f":{shard.start}-{shard.end}")
    assert not os.path.exists(ckpt)
    if name == "scan":
        assert [out.count("========== HIT") for _, out, _ in ranks] == [1, 1]


def test_a_failed_join_fails_the_command(worlds):
    """A rank whose coordinator port is taken exits non-zero with the
    join's error; nothing runs alone."""
    (rc, out, err), = worlds["taken"]
    assert rc != 0 and out == "" and "EADDRINUSE" in err


# --- the dry run ---

def test_dryrun_on_the_cpu(worlds):
    """Its two step lines, then its JSON line."""
    (rc, out, err), = worlds["dryrun"]
    assert rc == 0, err[-3000:]
    lines = out.splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("[dryrun 1/2] scan step: milksad seeds [1, 64] over 2 ranks "
                               "(32 a rank) on cpu: hits 0 (")
    assert lines[1].startswith("[dryrun 2/2] DistributedSweep over [0, 255] (batch 32, "
                               "round_batches 2): found planted seed 131, searched [64, 32] (")
    rep = json.loads(lines[2])
    assert (rep["dryrun"], rep["ranks"], rep["hits"], rep["found"], rep["searched"]) == \
        ("ok", 2, 0, 131, [64, 32])
    assert set(rep["launches"].values()) == {0}         # the plain versions


def test_dryrun_past_its_limit_exits_124():
    (rc, out, err), = finish(dryrun("2", "--device", "cpu", "--timeout", "0.5"))
    assert rc == 124 and out == ""
    assert "past the wall-clock limit of 0 s; ranks killed" in err


# --- the mesh and the derive bench ---

def test_split_seeds_gives_contiguous_slices():
    assert mesh.split_seeds(1 << 19, ["a", "b"]) == [("a", 0, 1 << 18), ("b", 1 << 18, 1 << 18)]
    assert mesh.split_seeds(1000, ["a"]) == [("a", 0, 1000)]
    with pytest.raises(ValueError, match="global batch must be n_dev\\*1024-aligned"):
        mesh.split_seeds(3 * 1024, ["a", "b"])


def test_no_card_no_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for fn in (mesh.get_devices, benchmark.bench_derive, _device.rank_device):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _device.run_device("cuda")


# --- the device repairs ---

@pytest.fixture
def two_cards(monkeypatch):
    """Two visible cards as torch reports them: card 0 an A100, card 1 an
    H100; card 1 current."""
    caps = {0: (8, 0), 1: (9, 0)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i=None: caps[i])
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=None: f"card {i}")


def test_require_cuda_checks_the_card_it_returns(two_cards):
    assert _device.require_cuda(1) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="device 0 'card 0' has capability \\(8, 0\\)"):
        _device.require_cuda(0)
    with pytest.raises(RuntimeError, match="no CUDA device 2 \\(2 visible\\)"):
        _device.require_cuda(2)


def test_rank_r_runs_on_its_card(two_cards, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 3)
    assert _device.rank_device() == torch.device("cuda", 1)
    assert _device.run_device("cuda") == torch.device("cuda", 1)
    assert _device.run_device("cuda:1") == torch.device("cuda", 1)
    assert _device.run_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(dist, "get_rank", lambda: 2)
    with pytest.raises(RuntimeError, match="device 0"):
        _device.rank_device()


def test_analyze_passes_the_indexed_device(monkeypatch):
    """``cmd_analyze`` hands ``run_analyze`` the card with its index (it
    passed "cuda"), and ``run_analyze`` takes the card's batch for it."""
    got, run_analyze = {}, panalyze.run_analyze
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setattr(cli, "run_device", lambda name: torch.device("cuda", 1))
    monkeypatch.setattr(panalyze, "run_analyze", lambda **kw: got.update(kw))
    assert cli.main(["analyze", "0x01", "--analyzer", "milksad"]) == 0
    assert got["device"] == "cuda:1"

    class Stop(Exception):
        pass

    def config(**kw):
        got.update(kw)
        raise Stop

    monkeypatch.setattr(panalyze, "AnalysisConfig", config)
    with pytest.raises(Stop):
        run_analyze("0x01", device="cuda:1")
    assert got["batch"] == psweeps.CARD_SWEEP_BATCH


def test_device_caches_are_keyed_by_the_indexed_card(two_cards, monkeypatch):
    """"cuda" (card 1 current) and "cuda:1" are one entry; the caches keep
    one entry a card."""
    assert _device.device_key("cuda") == _device.device_key("cuda:1") == "cuda:1"
    assert _device.device_key(torch.device("cuda", 0)) == "cuda:0"
    assert _device.device_key("cpu") == "cpu"
    for cache in (smul.table_on, smul_w8.table_on, field._pad_on, incremental._cached_table):
        assert cache.cache_info().maxsize is None
    built = []
    monkeypatch.setattr(incremental, "build_offset_table",
                        lambda n, device, smul13: built.append(device) or device)
    incremental._cached_table.cache_clear()
    try:
        assert incremental.offset_table(16, "cuda", True) == "cuda:1"
        assert incremental.offset_table(16, "cuda:1", True) == "cuda:1"
        assert incremental.offset_table(16, torch.device("cuda", 0), True) == "cuda:0"
    finally:
        incremental._cached_table.cache_clear()
    assert built == ["cuda:1", "cuda:0"]
