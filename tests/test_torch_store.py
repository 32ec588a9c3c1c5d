"""The port's persistent bitstream store, against the JAX package.

Ports the cases of ``tests/test_store.py`` (warm-boot round trips,
corrupt-entry tolerance, persist-vs-evict races, reconfigure invalidation,
two overlays sharing one directory, the measurement ledger, the planner and
the autotuned thresholds that ride on the store), and adds what the port's
serial form needs: every operator kind of a small traced phi3 and mamba2
round-trips bit-identically, kernel keys agree across processes, a payload
naming an unknown operator or tag builds cold and runs nothing it reads, a
directory written by the JAX package is rejected entry by entry, and the
store's bookkeeping (saves, store hits, downloads, reclaim victims, the
ledger's shape and seeding) matches the JAX package on hand-built graphs
through ``Overlay.assemble``.  The JAX tracer cannot run on the installed
jax (``repro/core/trace.py:127``), so the JAX side is held only through
``assemble``.  Small sizes, on the CPU, plain kernel versions, inputs from
a numpy seed; the ``cuda`` test runs on the card.
"""

import io
import json
import os
import pickle
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import smoke_config
from repro_torch.core import (BitstreamStore, Overlay, PlacementError,
                              interpreter as interp, saxpy_graph,
                              trace_to_graph, vmul_reduce_graph)
from repro_torch.core import graph as tgraph
from repro_torch.core import patterns as tpat
from repro_torch.core.store import _MAGIC, FORMAT_VERSION, runtime_header
from repro_torch.core.trace import SerialError
from repro_torch.kernels import ops
from repro_torch.models import model as mdl
from repro_torch.models import params as pm
from repro_torch.serving.metrics import Histogram

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORE_LOGGER = "repro_torch.core.store"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mul_fn(scale=2.0, name="mulacc"):
    def fn(a, b):
        return torch.sum(a * b) * scale
    fn.__name__ = name
    return fn


def _inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(n).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32)))


def _drive_once(store_path, *, name="mulacc", scale=2.0, n=64, **ov_kwargs):
    """One overlay boot: jit one accelerator, call it, drain, close."""
    ov = Overlay(3, 3, store_path=store_path, **ov_kwargs)
    f = ov.jit(_mul_fn(scale, name), name=name)
    a, b = _inputs(n)
    out = f(a, b)
    ov.drain()
    ov.close()
    return ov, out


# ---------------------------------------------------------------------------
# round trip: persist on first boot, load on the second
# ---------------------------------------------------------------------------
def test_warm_boot_round_trip(tmp_path):
    d = str(tmp_path / "store")
    ov1, out1 = _drive_once(d)
    assert ov1.store.stats.saves >= 1
    assert len(BitstreamStore(d).keys()) >= 1

    builds = interp.kernel_builds().get("Kernel", 0)
    ov2, out2 = _drive_once(d)
    assert ov2.cache.stats.store_hits >= 1
    assert ov2.cache.stats.store_load_seconds > 0.0
    assert interp.kernel_builds().get("Kernel", 0) == builds    # none built
    assert torch.equal(out1, out2)


def test_store_hit_is_not_a_cache_hit(tmp_path):
    # a store load still counts as a cache MISS (the artifact was not in
    # memory): hits keep meaning "served without any download"
    d = str(tmp_path / "store")
    _drive_once(d)
    ov2, _ = _drive_once(d)
    assert ov2.cache.stats.store_hits >= 1
    assert ov2.cache.stats.misses >= ov2.cache.stats.store_hits
    assert ov2.cache.stats.hits == 0


def test_store_survives_reclaim_but_not_evict(tmp_path):
    d = str(tmp_path / "store")
    ov = Overlay(3, 3, store_path=d, cost_model_placement=False)
    a, b = _inputs(32)
    f = ov.jit(_mul_fn(2.0, "keepacc"), name="keepacc", tile_budget=3)
    f(a, b)
    ov.drain()
    assert len(ov.store.keys()) == 1
    # fill the fabric until the first accelerator is reclaimed
    for i in range(4):
        ov.jit(_mul_fn(float(i + 3), f"fill{i}"), name=f"fill{i}",
               tile_budget=3)(a, b)
    ov.drain()
    assert ov.stats.reclaims >= 1
    assert not any(r.name == "keepacc" for r in ov.fabric.residents.values())
    keep = [k for k in ov.store.keys() if k.startswith("keepacc:")]
    assert len(keep) == 1                  # a reclaim keeps its disk entry
    f(a, b)                                # re-admission loads it from disk
    assert ov.cache.stats.store_hits == 1

    # explicit evict drops disk entries too
    ov.evict("keepacc")
    assert not [k for k in ov.store.keys() if k.startswith("keepacc:")]
    ov.close()


def test_describe_reports_store(tmp_path):
    ov, _ = _drive_once(str(tmp_path / "store"))
    desc = ov.describe()
    assert desc["store"] is not None
    assert desc["store"]["entries"] >= 1
    assert desc["cost_model_placement"] is True    # store implies planner
    assert desc["autotune_thresholds"] is True
    # store-less overlays advertise the absence, and keep the planner off
    bare = Overlay(2, 2).describe()
    assert bare["store"] is None and bare["cost_model_placement"] is False
    assert bare["autotune_thresholds"] is False


def test_store_and_store_path_are_exclusive(tmp_path):
    st = BitstreamStore(str(tmp_path / "a"))
    with pytest.raises(ValueError):
        Overlay(3, 3, store=st, store_path=str(tmp_path / "b"))
    assert Overlay(3, 3, store=st).store is st


# ---------------------------------------------------------------------------
# corrupt / truncated / mismatched entries: warn + cold build, never crash
# ---------------------------------------------------------------------------
def _rewrite_header(data: bytearray, **changes) -> bytes:
    hlen = int.from_bytes(data[len(_MAGIC):len(_MAGIC) + 4], "little")
    off = len(_MAGIC) + 4
    hdr = json.loads(bytes(data[off:off + hlen]))
    hdr.update(changes)
    new = json.dumps(hdr).encode()
    return (bytes(data[:len(_MAGIC)]) + len(new).to_bytes(4, "little") + new
            + bytes(data[off + hlen:]))


def _garble(path, mode):
    with open(path, "rb") as fh:
        data = bytearray(fh.read())
    if mode == "truncate":
        data = data[: len(data) // 2]
    elif mode == "flip":
        data[-3] ^= 0xFF                       # payload byte: checksum fails
    elif mode == "magic":
        data[:len(_MAGIC)] = b"X" * len(_MAGIC)
    elif mode == "version":
        data = _rewrite_header(data, format_version=FORMAT_VERSION + 999)
    elif mode == "torch":
        data = _rewrite_header(data, torch="0.0.0-not-this-runtime")
    elif mode == "cuda":
        data = _rewrite_header(data, cuda="0.0")
    elif mode == "capability":
        data = _rewrite_header(data, capability="1.0")
    elif mode == "jax":
        data = _rewrite_header(data, runtime="jax", jaxlib="0.9.0")
    with open(path, "wb") as fh:
        fh.write(bytes(data))


@pytest.mark.parametrize("mode", ["truncate", "flip", "magic", "version",
                                  "torch", "cuda", "capability", "jax"])
def test_garbled_entry_cold_compiles(tmp_path, mode, caplog):
    d = str(tmp_path / "store")
    _, out1 = _drive_once(d)
    store = BitstreamStore(d)
    keys = store.keys()
    assert keys
    for k in keys:
        _garble(store._path_for(k), mode)

    with caplog.at_level("WARNING", logger=STORE_LOGGER):
        ov2, out2 = _drive_once(d)
    # never served stale: a cold build produced the same numbers
    assert torch.equal(out1, out2)
    assert ov2.cache.stats.store_hits == 0
    assert ov2.store.stats.load_failures >= 1
    assert any("cold compiling" in r.message for r in caplog.records)
    # the bad file went, the cold build persisted afresh: the next boot is
    # warm
    assert ov2.store.stats.saves == len(keys)
    ov3, out3 = _drive_once(d)
    assert torch.equal(out1, out3) and ov3.cache.stats.store_hits == len(keys)


def test_runtime_header_names_torch():
    hdr = runtime_header()
    assert hdr["runtime"] == "torch" and hdr["torch"] == torch.__version__
    assert hdr["cuda"] == torch.version.cuda
    assert hdr["capability"] is None or "." in hdr["capability"]


def _rewrite_payload(store, key, edit):
    """Re-save ``key``'s entry with its kernel program edited: the checksum
    passes, the contents are bad."""
    blob = store.load_blob(key)
    n = 4
    raw_len = int.from_bytes(blob[n:n + 4], "little")
    program = json.loads(blob[n + 4:n + 4 + raw_len])
    edit(program)
    raw = json.dumps(program).encode()
    store.save(key, blob[:n] + len(raw).to_bytes(4, "little") + raw
               + blob[n + 4 + raw_len:], kind="kernel")


def _first_op(program):
    return next(st for st in program["steps"] if st[1] is not None)


def _aten_op(program):
    return next(op for op in program["ops"] if op["k"] == "aten")


@pytest.mark.parametrize("edit", [
    "unknown_library_op", "unknown_aten_op", "unknown_tag", "unknown_kind",
    "bad_slot", "bad_op_index", "not_a_payload"])
def test_unresolvable_payload_cold_builds(tmp_path, edit, caplog, monkeypatch):
    """A payload that passes the checksum but names an operator, a tag or a
    slot this process cannot resolve: warning, ``note_unusable`` (the entry
    is expunged) and a cold build — and no pickle of code anywhere."""
    d = str(tmp_path / "store")
    ov = Overlay(3, 3, store_path=d)
    f = ov.jit(lambda x: torch.sum(torch.cumsum(x, dim=0) * 2.0), name="edit")
    a, _ = _inputs()
    out1 = f(a)
    ov.drain()
    ov.close()
    store = BitstreamStore(d)
    (key,) = store.keys()

    def edit_program(p):
        if edit == "unknown_library_op":
            p["ops"][0] = {"k": "lib", "name": "no_such_operator"}
        elif edit == "unknown_aten_op":
            _aten_op(p)["target"] = "aten.no_such_op.default"
        elif edit == "unknown_tag":
            _aten_op(p)["args"][-1] = ["pickle", "cos\nsystem\n"]
        elif edit == "unknown_kind":
            p["ops"][0] = {"k": "code", "src": "import os"}
        elif edit == "bad_slot":
            _first_op(p)[2] = [[p["num_slots"] + 5, 0]]
        elif edit == "bad_op_index":
            _first_op(p)[1] = len(p["ops"]) + 3

    if edit == "not_a_payload":
        store.save(key, b"not a payload at all", kind="kernel")
    else:
        _rewrite_payload(store, key, edit_program)

    def no_pickle(*args, **kwargs):
        raise AssertionError("pickle.loads called on a store payload")

    monkeypatch.setattr(pickle, "loads", no_pickle)
    with caplog.at_level("WARNING"):
        ov2 = Overlay(3, 3, store_path=d)
        out2 = ov2.jit(lambda x: torch.sum(torch.cumsum(x, dim=0) * 2.0),
                       name="edit")(a)
    assert torch.equal(out1, out2)
    assert ov2.cache.stats.store_hits == 0
    assert ov2.store.stats.load_failures == 1
    assert any("failed to deserialize" in r.message for r in caplog.records)
    ov2.drain()
    ov2.close()
    # the bad entry was expunged and the cold build persisted afresh
    assert BitstreamStore(d).load_blob(key) is not None


class _Marker:
    fired = False


def _set_marker():
    _Marker.fired = True


class _Evil:
    def __reduce__(self):
        return (_set_marker, ())


def test_const_payload_never_runs_code(tmp_path):
    """A const blob holding a pickle that would run code if unpickled is
    refused by ``weights_only`` loading: the code never runs."""
    d = str(tmp_path / "store")
    g = saxpy_graph(16)
    ov = Overlay(3, 3, store_path=d)
    ov.assemble(g)
    ov.drain()
    ov.close()
    store = BitstreamStore(d)
    (key,) = store.keys()
    blob = store.load_blob(key)
    raw_len = int.from_bytes(blob[4:8], "little")
    buf = io.BytesIO()
    torch.save([_Evil()], buf)
    store.save(key, blob[:8 + raw_len] + buf.getvalue(), kind="kernel")
    ov2 = Overlay(3, 3, store_path=d)
    acc = ov2.assemble(saxpy_graph(16))
    x, y = _inputs(16)
    assert torch.equal(acc(x, y), g.evaluate(x, y))
    assert not _Marker.fired
    assert ov2.store.stats.load_failures == 1 and ov2.cache.stats.store_hits == 0
    ov2.close()


def test_interrupted_persist_every_header_boundary(tmp_path):
    """A persist interrupted mid-write can leave the file truncated at ANY
    byte.  Sweep every boundary of the magic + length + JSON-header region:
    a fresh store must treat each torn file as a miss — no exception, no
    stale load."""
    d = str(tmp_path / "store")
    store = BitstreamStore(d)
    key = "tornacc:deadbeef"
    store.save(key, b"payload bytes " * 8, kind="kernel")
    path = store._path_for(key)
    with open(path, "rb") as fh:
        data = fh.read()
    hlen = int.from_bytes(data[len(_MAGIC):len(_MAGIC) + 4], "little")
    header_end = len(_MAGIC) + 4 + hlen
    assert header_end < len(data)

    for cut in range(header_end + 1):
        with open(path, "wb") as fh:
            fh.write(data[:cut])
        fresh = BitstreamStore(d)           # cold scan over the torn file
        assert fresh.load_blob(key) is None, f"cut at byte {cut}"

    with open(path, "wb") as fh:            # sanity: intact file round-trips
        fh.write(data)
    assert BitstreamStore(d).load_blob(key) is not None


@pytest.mark.parametrize("cut_at", ["start", "mid_magic", "mid_length",
                                    "mid_header", "header_end"])
def test_interrupted_persist_warm_boot_cold_compiles(tmp_path, cut_at):
    # full-overlay version of the boundary sweep: a warm boot over a torn
    # entry degrades to a cold build with identical numbers, never crashes
    d = str(tmp_path / "store")
    _, out1 = _drive_once(d)
    store = BitstreamStore(d)
    keys = store.keys()
    assert keys
    for k in keys:
        path = store._path_for(k)
        with open(path, "rb") as fh:
            data = fh.read()
        hlen = int.from_bytes(data[len(_MAGIC):len(_MAGIC) + 4], "little")
        cut = {"start": 0,
               "mid_magic": len(_MAGIC) // 2,
               "mid_length": len(_MAGIC) + 2,
               "mid_header": len(_MAGIC) + 4 + hlen // 2,
               "header_end": len(_MAGIC) + 4 + hlen}[cut_at]
        with open(path, "wb") as fh:
            fh.write(data[:cut])

    ov2, out2 = _drive_once(d)
    assert torch.equal(out1, out2)
    assert ov2.cache.stats.store_hits == 0


def test_store_scan_ignores_foreign_files(tmp_path):
    d = tmp_path / "store"
    d.mkdir()
    (d / "README.txt").write_text("not a bitstream")
    (d / "junk.bits").write_bytes(b"garbage")
    store = BitstreamStore(str(d))
    assert store.keys() == []
    assert store.load_blob("nope") is None


def test_store_write_and_read_faults_degrade_to_cold_builds(tmp_path, caplog):
    """The fault plan's ``store_write`` channel tears an entry on its way to
    disk and ``store_read`` flips a byte before validation: both are caught
    and built cold."""
    from repro_torch.core import FaultPlan

    d = str(tmp_path / "store")
    _, out1 = _drive_once(d, faults=FaultPlan(1, store_write_corrupt_rate=1.0))
    with caplog.at_level("WARNING", logger=STORE_LOGGER):
        ov2, out2 = _drive_once(d)
    assert torch.equal(out1, out2) and ov2.store.stats.load_failures == 1
    d2 = str(tmp_path / "store2")
    _drive_once(d2)
    ov3, out3 = _drive_once(d2, faults=FaultPlan(1, store_read_corrupt_rate=1.0))
    assert torch.equal(out1, out3)
    assert ov3.store.stats.injected_read_faults == 1
    assert ov3.store.stats.load_failures == 1 and ov3.cache.stats.store_hits == 0


# ---------------------------------------------------------------------------
# persist vs evict races; reconfigure invalidation
# ---------------------------------------------------------------------------
def test_evict_cancels_inflight_persist(tmp_path):
    """An evict racing a queued persist must not resurrect the key on disk:
    the persist job is cancelled and the commit's liveness guard backstops
    the window where serialization already ran."""
    d = str(tmp_path / "store")
    ov = Overlay(3, 3, store_path=d)
    gate = threading.Event()
    orig_pack = BitstreamStore.pack_kernel

    def gated_pack(kernel):
        gate.wait(30)
        return orig_pack(kernel)

    f = ov.jit(_mul_fn(3.0, "raceacc"), name="raceacc")
    a, b = _inputs(32)
    try:
        BitstreamStore.pack_kernel = staticmethod(gated_pack)
        f(a, b)
        ov.evict("raceacc")               # persist still gated: cancel path
        gate.set()
        ov.drain()
    finally:
        BitstreamStore.pack_kernel = staticmethod(orig_pack)
    ov.close()
    assert BitstreamStore(d).keys() == []


def test_commit_persist_drops_dead_entries(tmp_path):
    # even if the scheduler cancel lost the race, _commit_persist refuses
    # to write a key the cache no longer serves
    d = str(tmp_path / "store")
    ov = Overlay(3, 3, store_path=d)
    assert ov._commit_persist("ghost:key", b"blob", "kernel") is None
    assert "ghost:key" not in ov.store
    ov.close()


def test_reconfigure_invalidates_store_entries(tmp_path):
    d = str(tmp_path / "store")
    ov = Overlay(3, 3, store_path=d)
    f = ov.jit(_mul_fn(2.0, "cfgacc"), name="cfgacc")
    a, b = _inputs(32)
    f(a, b)
    ov.drain()
    assert len(ov.store.keys()) >= 1

    ov.reconfigure(prefetch=False)
    assert ov.store.keys() == []          # dropped registries leave no disk
    ov.close()


def test_unpersistable_kernel_still_serves_and_is_counted(tmp_path):
    """A graph holding an operator with no serial form (an arbitrary
    callable) is not written; it serves all the same, and the store counts
    it."""
    g = tgraph.Graph("custom")
    x = g.input("x", (8,), torch.float32)
    g.output(g.apply(tpat.Operator("twice", 1, lambda t: t * 2.0), x))
    ov = Overlay(3, 3, store_path=str(tmp_path / "store"))
    acc = ov.assemble(g)
    ov.drain()
    assert torch.equal(acc(torch.ones(8)), torch.full((8,), 2.0))
    assert ov.store.stats.unpersistable == 1 and ov.store.keys() == []
    ov.close()


def test_concurrent_members_one_directory(tmp_path):
    """Two overlays sharing one store persist different accelerators into
    one directory concurrently: every save lands, the index stays
    consistent."""
    d = str(tmp_path / "store")
    store = BitstreamStore(d)
    members = [Overlay(3, 3, store=store) for _ in range(2)]
    a, b = _inputs(32)
    outs = {}
    # make_fx is not thread-safe: trace on this thread, assemble and
    # persist concurrently
    fns = [m.jit(_mul_fn(float(i + 2), f"conc{i}"), name=f"conc{i}")
           for i, m in enumerate(members)]
    for f in fns:
        f.lower(a, b)

    def drive(i):
        outs[i] = fns[i](a, b)

    threads = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for m in members:
        m.drain()
        m.close()
    assert store.stats.saves == 2
    names = {k.split(":")[0] for k in BitstreamStore(d).keys()}
    assert names == {"conc0", "conc1"}


# ---------------------------------------------------------------------------
# measurement ledger: EWMA costs + dispatch histograms survive restarts
# ---------------------------------------------------------------------------
def test_ledger_round_trip(tmp_path):
    d = str(tmp_path / "store")
    ov = Overlay(3, 3, store_path=d)
    f = ov.jit(_mul_fn(2.0, "ledacc"), name="ledacc")
    a, b = _inputs(32)
    for _ in range(4):
        f(a, b)
    ov.drain()
    ov.close()

    ledger = BitstreamStore(d).load_ledger()
    assert ledger and ledger["download_costs"]
    assert any(v > 0 for v in ledger["download_costs"].values())
    assert ledger["dispatch"]          # the resident's latency histogram

    ov2 = Overlay(3, 3, store_path=d)
    assert ov2.fabric.mean_download_cost() > 0.0
    f2 = ov2.jit(_mul_fn(2.0, "ledacc"), name="ledacc")
    f2(a, b)
    (res,) = ov2.fabric.residents.values()
    assert res.dispatch_hist.count >= 3         # re-seeded at admission
    ov2.close()


def test_ledger_merge_keeps_other_rows(tmp_path):
    store = BitstreamStore(str(tmp_path / "store"))
    store.save_ledger({"download_costs": {"a": 1.0},
                       "download_counts": {"a": 2},
                       "dispatch": {}})
    store.save_ledger({"download_costs": {"b": 3.0},
                       "download_counts": {"b": 1},
                       "dispatch": {}})
    ledger = store.load_ledger()
    assert ledger["download_costs"] == {"a": 1.0, "b": 3.0}
    assert os.path.exists(os.path.join(store.path, "ledger.json"))


def test_histogram_state_round_trip():
    from repro.serving.metrics import Histogram as JHistogram

    h, j = Histogram(), JHistogram()
    for us in (10, 100, 1000, 10000):
        h.record(us)
        j.record(us)
    assert h.state() == j.state()             # the reference's ledger shape
    h2 = Histogram.from_state(j.state())
    assert h2.count == h.count
    assert h2.percentile(0.5) == h.percentile(0.5)
    # malformed states degrade to an empty histogram, never raise
    assert Histogram.from_state({"bogus": 1}).count == 0
    assert Histogram.from_state(None).count == 0


# ---------------------------------------------------------------------------
# cost-model planner + autotuned thresholds
# ---------------------------------------------------------------------------
def test_planner_improves_cyclic_churn():
    """A rotation of 6 accelerators over a 3-capacity fabric: first-fit +
    LRU misses every call; the planner's anti-thrash victim rule pins a
    stable subset resident."""
    def drive(cost_model):
        ov = Overlay(3, 3, cost_model_placement=cost_model)
        a, b = _inputs(64)
        fns = [ov.jit(_mul_fn(float(i + 1), f"rot{i}"), name=f"rot{i}")
               for i in range(6)]
        for f in fns:
            f(a, b)
        dl0 = ov.stats.downloads
        for _ in range(2):
            for f in fns:
                f(a, b)
        redl = ov.stats.downloads - dl0
        return 1.0 - redl / 12.0, ov.stats.reclaims

    hit_ff, reclaims_ff = drive(False)
    hit_cm, reclaims_cm = drive(True)
    assert hit_cm >= hit_ff
    assert reclaims_cm < reclaims_ff


def test_planner_compacts_under_pressure():
    # the planner produces valid placements for several admissions without
    # reclaiming anything that fits
    ov = Overlay(3, 3, cost_model_placement=True)
    a, b = _inputs(32)
    for i in range(3):
        ov.jit(_mul_fn(float(i + 1), f"cp{i}"), name=f"cp{i}")(a, b)
    assert len(ov.fabric) == 3
    assert ov.stats.reclaims == 0


def test_planner_unplaceable_still_raises():
    """A graph that cannot fit even an EMPTY fabric propagates the
    structural PlacementError on the planner path, as first-fit does."""
    ov = Overlay(2, 2, large_fraction=0.0, cost_model_placement=True)
    with pytest.raises(PlacementError):
        ov.assemble(vmul_reduce_graph(64))


def test_autotune_specialize_after_direction():
    ov = Overlay(3, 3, autotune_thresholds=True)
    ov.cache.spec_stats.specializations = 4
    ov.cache.spec_stats.compile_seconds = 4 * 0.08      # 80ms per spec
    for _ in range(32):
        ov.dispatch_hist.record(200.0)                  # 200us dispatches
    ov._autotune()
    slow_dispatch = ov.specialize_after
    assert 8 <= slow_dispatch <= 512

    ov2 = Overlay(3, 3, autotune_thresholds=True)
    ov2.cache.spec_stats.specializations = 4
    ov2.cache.spec_stats.compile_seconds = 4 * 0.08
    for _ in range(32):
        ov2.dispatch_hist.record(20000.0)               # 20ms dispatches
    ov2._autotune()
    # slower dispatches amortize the same spec cost sooner
    assert ov2.specialize_after <= slow_dispatch


def test_autotune_defrag_threshold_adapts():
    ov = Overlay(3, 3, auto_defragment=True, autotune_thresholds=True)
    t0 = ov.defrag_threshold
    ov.defragment = lambda: 0
    ov.fabric.fragmentation = lambda: 1.0
    ov._maybe_defragment()
    assert ov.defrag_threshold > t0                     # useless pass: raise
    ov.defragment = lambda: 2
    t1 = ov.defrag_threshold
    ov._maybe_defragment()
    assert ov.defrag_threshold < t1                     # useful pass: lower


def test_victim_price_is_store_aware(tmp_path):
    """A store-backed resident is priced at the mean measured store load
    (else a prior), not at its build cost."""
    d = str(tmp_path / "store")
    _drive_once(d)
    ov = Overlay(3, 3, store_path=d)
    f = ov.jit(_mul_fn(2.0, "mulacc"), name="mulacc")
    f(*_inputs())
    (res,) = ov.fabric.residents.values()
    st = ov.cache.stats
    assert st.store_hits == 1
    assert ov._victim_price(res) == pytest.approx(st.store_load_seconds)
    ov.close()
    cold = Overlay(3, 3, store_path=str(tmp_path / "other"))
    cold.jit(_mul_fn(2.0, "mulacc"), name="mulacc")(*_inputs())
    cold.drain()
    (res,) = cold.fabric.residents.values()
    assert cold._victim_price(res) == cold._STORE_LOAD_PRIOR_S
    cold.close()


def test_specialized_tier_persists_and_reloads(tmp_path):
    """The route-constant tier round-trips through the store: boot B's
    specialization loads the walk (a store hit) instead of building it."""
    d = str(tmp_path / "store")

    def boot():
        # first-fit: the planner may place a warm boot elsewhere (it prices
        # with the seeded ledger), and a spec entry is keyed by its hops
        ov = Overlay(3, 3, store_path=d, autotune_thresholds=False,
                     cost_model_placement=False)
        f = ov.jit(_mul_fn(2.0, "specacc"), name="specacc")
        a, b = _inputs(32)
        f(a, b)
        builds = interp.kernel_builds().get("SpecializedKernel", 0)
        f.specialize(a, b)
        out = f(a, b)
        assert ov.cache.spec_stats.specialized_hits == 1
        ov.drain()
        hits = ov.cache.stats.store_hits
        built = interp.kernel_builds().get("SpecializedKernel", 0) - builds
        ov.close()
        return out, hits, built

    out1, hits1, built1 = boot()
    assert hits1 == 0 and built1 == 1
    kinds = BitstreamStore(d).describe()["kinds"]
    assert kinds == {"kernel": 1, "specialized": 1}
    assert any("|spec|" in k for k in BitstreamStore(d).keys())
    out2, hits2, built2 = boot()
    assert torch.equal(out1, out2)
    assert hits2 == 2 and built2 == 0          # the kernel and the walk


# ---------------------------------------------------------------------------
# the serial form: every operator kind, across processes
# ---------------------------------------------------------------------------
def _probe(x, w, cache):
    """Residues with dtype, device and list arguments, a custom call with
    eps, projections of a multi-result op, a select and a tensor const."""
    h = ops.rmsnorm(x, w, 1e-5)                       # call, float eps
    parts = torch.split(h, [3, 5], dim=-1)            # residue, list arg; proj[i]
    z = torch.cat([parts[1], parts[0]], dim=-1)
    z = z + torch.arange(8, dtype=torch.float32, device=x.device)  # dtype, device
    z = torch.where(z > 0, z, cache)                  # select
    return z * torch.tensor([0.5, 2.0] * 4)           # a tensor const


def _small_model(arch):
    cfg = smoke_config(arch).scaled(d_model=128, head_dim=32,
                                    dtype="float32")
    params = pm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, pytree.tree_map(lambda t: t.float(), params)


def _graphs(kind):
    """(name, lowered graph, example inputs) for one case."""
    if kind == "probe":
        rng = np.random.default_rng(3)
        args = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for s in ((4, 8), (8,), (4, 8)))
        with torch.no_grad():
            return [("probe", trace_to_graph(_probe, *args, name="probe"), args)]
    cfg, params = _small_model(kind)
    cache = mdl.init_cache(cfg, 2, 32, "cpu")
    toks = torch.tensor([[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]], dtype=torch.int32)
    pos = torch.tensor([5, 5], dtype=torch.int32)
    pf = lambda p, t, c: mdl.prefill(p, cfg, t, c)
    dec = lambda p, t, c, q: mdl.decode_step(p, cfg, t, c, positions=q)
    out = []
    for name, fn, args in (("prefill", pf, (params, toks, cache)),
                           ("decode", dec, (params, toks[:, :1], cache, pos))):
        lowered = trace_to_graph(fn, *args, name=f"{kind}.{name}")
        out.append((name, lowered, tuple(pytree.tree_leaves(args))))
    return out


def _kinds(desc, acc):
    acc.add(desc["k"])
    if "op" in desc:
        _kinds(desc["op"], acc)
    for a in list(desc.get("args", ())) + list(desc.get("kwargs", {}).values()):
        _tags(a, acc)
    return acc


def _tags(t, acc):
    acc.add("tag:" + t[0])
    if t[0] in ("list", "tuple"):
        for x in t[1]:
            _tags(x, acc)


@pytest.mark.parametrize("kind", ["probe", "phi3-mini-3.8b", "mamba2-130m"])
def test_every_operator_kind_round_trips_bit_identically(kind):
    seen: set = set()
    for name, lowered, leaves in _graphs(kind):
        kernel = interp.build_kernel(lowered.graph)
        program, consts = kernel.serial_form()
        for st in program["steps"]:
            if st[1] is None:
                seen.add("select")
            else:
                _kinds(program["ops"][st[1]], seen)
        seen.update("const:" + type(c).__name__ for c in consts)
        loaded = BitstreamStore.unpack_kernel(BitstreamStore.pack_kernel(kernel))
        assert type(loaded) is interp.Kernel and loaded.name == kernel.name
        routes = interp.route_vector(lowered.graph, _placement(lowered.graph))
        want, got = kernel(routes, *leaves), loaded(routes, *leaves)
        for w, g in zip(pytree.tree_leaves(want), pytree.tree_leaves(got)):
            assert torch.equal(w, g), f"{kind} {name}: reloaded kernel differs"
    want = {"probe": {"call", "aten", "proj", "select", "tag:float", "tag:list",
                      "tag:dtype", "tag:device", "tag:in", "const:Tensor"},
            "phi3-mini-3.8b": {"call", "aten", "lib", "tag:float", "tag:int",
                               "tag:list"},
            "mamba2-130m": {"call", "aten", "tag:float", "tag:list",
                            "tag:int"}}[kind]
    assert want <= seen, sorted(want - seen)


def _placement(graph):
    from repro_torch.core import PlacementPolicy, TileGrid, place
    return place(graph, TileGrid(3, 3), PlacementPolicy.DYNAMIC)


def test_specialized_kernel_round_trips_with_its_hops():
    g = vmul_reduce_graph(32)
    kernel = interp.specialize_kernel(g, (0, 3, 1))
    loaded = BitstreamStore.unpack_kernel(BitstreamStore.pack_kernel(kernel))
    assert isinstance(loaded, interp.SpecializedKernel) and loaded.hops == (0, 3, 1)
    a, b = _inputs(32)
    assert torch.equal(kernel(None, a, b), loaded(None, a, b))


def test_encode_refuses_values_with_no_serial_form():
    from repro_torch.core.trace import decode_value, encode_value

    for v in (1, -2.5, float("inf"), True, None, "s", torch.bfloat16,
              torch.device("cpu"), torch.strided, torch.channels_last,
              [1, (2.0, [None])]):
        back = decode_value(json.loads(json.dumps(encode_value(v))))
        assert back == v and type(back) is type(v)
    nan = decode_value(encode_value(float("nan")))
    assert nan != nan
    for bad in (object(), {1: 2}, torch.ones(1), 1j):
        with pytest.raises(SerialError):
            encode_value(bad)
    for bad in (["int", True], ["dtype", "not_a_dtype"], ["pickle", "x"],
                ["device", 3], "flat", ["list", "x"]):
        with pytest.raises(SerialError):
            decode_value(bad)


_KEY_SCRIPT = """
import sys, json, torch
sys.path.insert(0, {src!r})
from repro_torch.configs import smoke_config
from repro_torch.core import Overlay, interpreter as interp
from repro_torch.core.store import BitstreamStore
from repro_torch.models import model as mdl, params as pm
cfg = smoke_config("phi3-mini-3.8b").scaled(d_model=128, head_dim=32, dtype="float32")
params = pm.init(cfg, torch.Generator().manual_seed(0), "cpu")
ov = Overlay(3, 3)
f = ov.jit(lambda p, t, c, q: mdl.decode_step(p, cfg, t, c, positions=q), name="dec")
cache = mdl.init_cache(cfg, 2, 32, "cpu")
args = (params, torch.zeros((2, 1), dtype=torch.int32), cache,
        torch.zeros(2, dtype=torch.int32))
g = f.lower(*args).graph
k = ov._kernel_key(g, g.input_avals())
blob = BitstreamStore.pack_kernel(interp.build_kernel(g))
import hashlib
print(json.dumps({{"key": k, "rid": ov._resident_key(g, g.input_avals(), None),
                  "payload": hashlib.sha256(blob[:8 + int.from_bytes(blob[4:8], "little")]).hexdigest()}}))
"""


def test_kernel_keys_are_stable_across_processes():
    """Keys carry reprs of residue arguments, the graph fingerprint and the
    device: two fresh processes tracing the same step agree on the kernel
    key, the resident key and the serial program."""
    script = _KEY_SCRIPT.format(src=os.path.join(ROOT, "src"))
    runs = [subprocess.run([sys.executable, "-c", script], capture_output=True,
                           text=True, timeout=300, env={**os.environ,
                                                        "OMP_NUM_THREADS": "1"})
            for _ in range(2)]
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    a, b = (json.loads(r.stdout.strip().splitlines()[-1]) for r in runs)
    assert a == b


def _boot(args: list) -> dict:
    """One serve-launcher process on the CPU: its result line."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args,
                        "--device", "cpu"], capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1",
                                      "PYTHONPATH": os.path.join(ROOT, "src")})
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_fleet_warm_boot_across_processes_loads_every_key(tmp_path):
    """``--fleet 2 --store D`` in two processes, cold then warm: the two
    members of the cold boot save every kernel key into one directory; the
    warm boot's members load them all and build none; both boots' streams
    equal a plain boot's.  gemma2's smoke config: the operators of its
    local and global layers, softcaps and post norms persist too."""
    d = str(tmp_path / "store")
    args = ["--arch", "gemma2-27b", "--smoke", "--requests", "3", "--batch", "2",
            "--max-new", "4", "--prompt-lens", "5,20"]
    plain = _boot(args)
    cold = _boot(args + ["--fleet", "2", "--store", d])
    warm = _boot(args + ["--fleet", "2", "--store", d])
    keys = cold["store"]["entries"]
    assert keys >= 3 and cold["store"]["stats"]["saves"] >= keys
    assert cold["kernels_built"] == {"Kernel": keys} and cold["store_hits"] == 0
    assert os.path.exists(os.path.join(d, "ledger.json"))
    assert warm["kernels_built"] == {"loaded": warm["store_hits"]}
    assert warm["store_hits"] == warm["downloads"] >= keys
    assert warm["store"]["stats"]["load_failures"] == 0 and warm["store"]["entries"] == keys
    assert cold["streams"] == warm["streams"] == plain["streams"]


# ---------------------------------------------------------------------------
# against the JAX package, through Overlay.assemble on hand-built graphs
# ---------------------------------------------------------------------------
def test_directory_written_by_the_jax_package_is_rejected_entry_by_entry(
        tmp_path, caplog):
    from repro.core import Overlay as JOverlay
    from repro.core import saxpy_graph as jsaxpy
    from repro.core import vmul_reduce_graph as jvmul
    from repro.core.store import BitstreamStore as JStore

    d = str(tmp_path / "store")
    jov = JOverlay(3, 3, store_path=d)
    jov.assemble(jsaxpy(64))
    jov.assemble(jvmul(64))
    jov.drain()
    jov.close()
    jkeys = JStore(d).keys()
    assert len(jkeys) == 2

    store = BitstreamStore(d)
    assert store.keys() == []                  # foreign runtime: not indexed
    with caplog.at_level("WARNING", logger=STORE_LOGGER):
        for k in jkeys:
            assert store.load_blob(k) is None
    assert store.stats.load_failures == 2
    assert sum("runtime" in r.message for r in caplog.records) == 2

    ov = Overlay(3, 3, store_path=d)           # boots, builds cold
    x, y = _inputs(64)
    acc = ov.assemble(saxpy_graph(64))
    assert torch.equal(acc(x, y), saxpy_graph(64).evaluate(x, y))
    ov.drain()
    ov.close()
    assert ov.store.stats.saves == 1 and ov.cache.stats.store_hits == 0


COSTS = {"saxpy": 0.5, "vmul": 2.0, "branchy": 1.0, "r0": 3.0, "r1": 0.25,
         "r2": 1.5}


def _parity_graphs(pkg):
    from test_torch_relocation import canned, build, recipe
    out = [canned(pkg, k, k) for k in ("vmul", "saxpy", "branchy")]
    out += [build(pkg, recipe(7000 + i), f"r{i}") for i in range(3)]
    return out


def _drive_parity(pkg, d):
    """One boot: admit the six graphs in a fixed order twice under the
    cost model with a store, pinning download costs (the packages measure
    different build times) and draining each persist; returns what the
    planner did."""
    if pkg == "jax":
        from repro.core import Overlay as Ov
    else:
        Ov = Overlay
    ov = Ov(3, 3, store_path=d)
    victims = []
    evict = ov._evict_resident

    def recording(rid, **kw):
        res = ov.fabric.get(rid)
        if res is not None:
            victims.append(res.name)
        return evict(rid, **kw)

    ov._evict_resident = recording
    gs = _parity_graphs(pkg)
    for g in gs + gs[::-1]:
        ov.assemble(g, tile_budget=2)
        ov.drain()
        for res in ov.fabric.residents.values():
            ov.fabric._download_costs[res.rid] = COSTS[res.name]
            res.download_cost = COSTS[res.name]
    ov.close()
    return {"saves": ov.store.stats.saves, "store_hits": ov.cache.stats.store_hits,
            "downloads": ov.stats.downloads, "reclaims": ov.stats.reclaims,
            "victims": victims,
            "residents": sorted(r.name for r in ov.fabric.residents.values()),
            "entries": len(ov.store.keys())}


def test_store_bookkeeping_matches_jax(tmp_path):
    """Cold and warm boots of one admission sequence under the cost model
    with a store: the same saves, store hits, downloads, reclaims and
    reclaim victims in both packages."""
    got = {pkg: [_drive_parity(pkg, str(tmp_path / pkg)) for _ in range(2)]
           for pkg in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    cold, warm = got["torch"]
    assert cold["victims"]                 # the sequence did reclaim
    # a cold boot persists each kernel once and re-downloads reclaimed ones
    # off disk; a warm boot downloads only off disk
    assert cold["saves"] == 6 and cold["store_hits"] == cold["downloads"] - 6
    assert warm["saves"] == 0 and warm["store_hits"] == warm["downloads"]


def _ledger_from(pkg, d):
    if pkg == "jax":
        from repro.core import Overlay as Ov
    else:
        Ov = Overlay
    ov = Ov(3, 3, store_path=os.path.join(d, pkg))   # measured downloads
    for g in _parity_graphs(pkg)[:4]:
        ov.assemble(g)
    for i, res in enumerate(ov.fabric.residents.values()):
        for us in (10.0 * (i + 1), 300.0, 4000.0):
            res.dispatch_hist.record(us)
    ov.evict("vmul")
    ledger = ov.fabric.export_ledger()
    ov.close()                       # retire the persist workers
    return ledger


def _shape(obj):
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    return type(obj).__name__


def test_export_ledger_has_the_jax_shape(tmp_path):
    jl, tl = (_ledger_from(p, str(tmp_path)) for p in ("jax", "torch"))
    assert set(jl) == set(tl) == {"download_costs", "download_counts", "dispatch"}
    names = lambda led, sec: sorted(k.split(":")[0] for k in led[sec])
    for sec in jl:
        assert names(jl, sec) == names(tl, sec)
    jrow = next(iter(jl["dispatch"].values()))
    trow = next(iter(tl["dispatch"].values()))
    assert _shape(jrow) == _shape(trow)
    assert jrow == trow or set(jrow) == set(trow)
    json.dumps(tl)                                  # JSON-ready


def test_seed_ledger_applies_the_jax_rows():
    from repro.core.fabric import Fabric as JFabric
    from repro.core.placement import TileGrid as JGrid
    from repro_torch.core import Fabric, TileGrid

    h = Histogram()
    for us in (5.0, 50.0, 500.0):
        h.record(us)
    ledger = {
        "download_costs": {"a": 0.5, "b": "0.25", "c": "bogus", "d": -1.0,
                           "e": None},
        "download_counts": {"a": 3, "b": "x", "c": 2.0},
        "dispatch": {"a": h.state(), "b": {"bogus": 1}, "c": "nope",
                     "d": Histogram().state()},
        "extra": [1, 2, 3],
    }
    jf, tf = JFabric(JGrid(3, 3)), Fabric(TileGrid(3, 3))
    tf._download_costs["a"] = 9.0              # in-process measurement wins
    jf._download_costs["a"] = 9.0
    assert jf.seed_ledger(ledger) == tf.seed_ledger(ledger)
    assert jf._download_costs == tf._download_costs
    assert jf._download_counts == tf._download_counts
    assert jf._dispatch_states == tf._dispatch_states
    assert tf._download_costs["a"] == 9.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_warm_loaded_phi3_decode_kernel_is_bit_identical_on_card(tmp_path):
    """A phi3-width decode step (d_model 3072, 2 layers, bf16) built and
    persisted, then loaded in a fresh store: the loaded kernel gives the
    built one's bits on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python -m pytest -m cuda)")
    from repro_torch.configs import get_config

    dev = torch.device("cuda")
    cfg = get_config("phi3-mini-3.8b").scaled(blocks=((("dense",), 2),))
    params = pm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    cache = mdl.init_cache(cfg, 2, 64, dev)
    toks = torch.tensor([[11], [42]], dtype=torch.int32, device=dev)
    pos = torch.tensor([3, 7], dtype=torch.int32, device=dev)
    dec = lambda p, t, c, q: mdl.decode_step(p, cfg, t, c, positions=q)
    lowered = trace_to_graph(dec, params, toks, cache, pos, name="phi3.decode")
    kernel = interp.build_kernel(lowered.graph)
    store = BitstreamStore(str(tmp_path / "store"))
    assert store.save("phi3.decode:k", BitstreamStore.pack_kernel(kernel))
    blob = BitstreamStore(str(tmp_path / "store")).load_blob("phi3.decode:k")
    loaded = BitstreamStore.unpack_kernel(blob)
    leaves = tuple(pytree.tree_leaves((params, toks, cache, pos)))
    routes = interp.route_vector(lowered.graph, _placement(lowered.graph))
    before = ops.LAUNCH_COUNTERS[1].count
    want, got = kernel(routes, *leaves), loaded(routes, *leaves)
    assert ops.LAUNCH_COUNTERS[1].count - before == 2 * (2 * cfg.num_layers + 1)
    for w, g in zip(pytree.tree_leaves(want), pytree.tree_leaves(got)):
        assert torch.equal(w, g)
