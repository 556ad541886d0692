"""The readers of the port's spans on a synthetic slice: the sync count, the
idle time put down to syncs, the device ms of the train step's phases and
the slot tables' host seconds; and each reader's None where the program
has no spans (an older port)."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mswe_gnn_tpu_torch.utils import profiling
from portbench import run, trace

# a train step's phases with a sync span in the preparation; times in us
HOST = [("mswe.train.forward", 0.0, 100.0), ("mswe.prepare_graph", 5.0, 40.0),
        ("mswe.sync.check_rows*2", 10.0, 20.0), ("aten::min", 10.0, 12.0),
        ("mswe.sync.out_slot_bincount*2", 30.0, 35.0),
        ("mswe.train.backward", 100.0, 180.0), ("mswe.train.optimizer", 180.0, 200.0),
        ("mswe.sync.out_slot_check", 185.0, 190.0)]
# busy [0, 12] [20, 32] [50, 190] [195, 200]: gaps (12, 20) and (32, 50)
# begin inside sync spans, (190, 195) at a sync span's very end
DEVICE = [("k", 0.0, 12.0), ("k", 20.0, 32.0), ("k", 50.0, 150.0), ("k", 140.0, 190.0),
          ("k", 195.0, 200.0)]
CTX = {"mode": "train", "batch": 8, "units": 2, "model_steps_per_unit": 6, "device": DEVICE,
       "host": HOST, "graph_build_s": 3.0}
TABLE = {"mswe.prepare_graph": {"count": 2, "host_s": 0.01, "device_s": 0.004,
                                "self_device_s": 0.004},
         "mswe.train.forward": {"count": 2, "host_s": 0.5, "device_s": 0.1,
                                "self_device_s": 0.096},
         "mswe.train.backward": {"count": 2, "host_s": 0.2, "device_s": 0.3,
                                 "self_device_s": 0.3},
         "mswe.train.optimizer": {"count": 2, "host_s": 0.05, "device_s": 0.02,
                                  "self_device_s": 0.02},
         "mswe.graph.slot_tables": {"count": 24, "host_s": 2.5, "device_s": 0.0,
                                    "self_device_s": 0.0}}


def read(name, ctx=CTX):
    return run.reader("layer_metrics", name)(ctx)


def test_host_syncs_per_step_weighs_each_site_by_its_count():
    # 2 + 2 + 1 blocking reads over 2 units of 6 model steps
    assert read("host_syncs_per_step.train") == pytest.approx(5 / 12)
    phases_only = dict(CTX, host=[h for h in HOST if not h[0].startswith("mswe.sync.")])
    assert read("host_syncs_per_step.rollout", phases_only) == 0.0


def test_sync_idle_counts_gaps_that_begin_inside_a_sync_span():
    # idle 8 + 18 + 5 = 31 us; (12, 20) and (32, 50) begin in sync spans, and
    # (190, 195) at the end of one (the read returns as the device goes idle)
    assert read("sync_idle.train") == pytest.approx(100.0 * 31 / 31)
    outside = dict(CTX, device=DEVICE + [("k", 210.0, 220.0)])      # (200, 210): no sync
    assert read("sync_idle.train", outside) == pytest.approx(100.0 * 31 / 41)


def test_sync_idle_finds_a_sync_span_long_after_its_phase_began():
    """A sync span opened more than 64 host events after a long phase span
    began: the interval search finds it. The breakdown, which scans back
    over 64 host events only, cannot see the phase that far back and puts
    the later gap under no host op."""
    host = [("mswe.train.forward", 0.0, 1000.0)]
    host += [("aten::add", 1.0 + i, 1.5 + i) for i in range(100)]
    host += [("mswe.sync.check_rows*2", 500.0, 520.0), ("aten::item", 500.0, 520.0)]
    host += [("aten::mul", 501.0 + i * 0.1, 501.05 + i * 0.1) for i in range(80)]
    device = [("k", 0.0, 505.0), ("k", 515.0, 600.0), ("k", 700.0, 800.0)]
    ctx = dict(CTX, host=host, device=device)
    # gaps (505, 515) in the sync span, (600, 700) in the forward alone
    assert read("sync_idle.rollout", ctx) == pytest.approx(100.0 * 10 / 110)
    labels = dict(map(tuple, trace.breakdown({"device": device, "host": host})["idle_gaps"]))
    assert labels["(no host op)"] == pytest.approx(100e-6)
    assert "mswe.train.forward" not in labels


def test_phase_readers_read_the_span_table(monkeypatch):
    monkeypatch.setattr(profiling, "span_table", lambda: TABLE)
    assert read("prepare_ms.train") == pytest.approx(2.0)          # 4 ms over 2 units
    assert read("forward_ms.train") == pytest.approx(48.0)         # self time: 96 ms / 2
    assert read("backward_ms.train") == pytest.approx(150.0)
    assert read("optimizer_ms.train") == pytest.approx(10.0)
    assert read("slot_tables_s") == pytest.approx(2.5)


class _HostClockEvent:
    """A CUDA timing event on the host's clock, for the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_nested_phase_spans_tile_the_step(monkeypatch):
    """Real spans, nested as the train step nests them and timed under a
    profiler (on a stand-in CUDA device): the four phase readers add up to
    the phases' time, since the forward's self time leaves out the
    preparation inside it."""
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        monkeypatch.setattr(torch.cuda, "Event", _HostClockEvent)
        t0 = time.perf_counter()
        for _ in range(2):
            with profiling.span("mswe.train.forward"):
                with profiling.span("mswe.prepare_graph"):
                    with profiling.span("mswe.sync.check_rows", 2):
                        time.sleep(0.002)
                time.sleep(0.003)
            with profiling.span("mswe.train.backward"):
                time.sleep(0.004)
            with profiling.span("mswe.train.optimizer"):
                time.sleep(0.001)
        wall_ms = (time.perf_counter() - t0) * 1e3
        monkeypatch.undo()
    ctx = dict(CTX, units=2)
    parts = {p: read(f"{p}.train", ctx) for p in ("prepare_ms", "forward_ms", "backward_ms",
                                                  "optimizer_ms")}
    assert parts["prepare_ms"] >= 2.0 and parts["forward_ms"] >= 3.0
    table = profiling.span_table()
    total = sum(table[f"mswe.train.{p}"]["device_s"] for p in ("forward", "backward",
                                                                 "optimizer"))
    assert sum(parts.values()) == pytest.approx(1e3 * total / 2)
    assert sum(parts.values()) <= wall_ms / 2
    profiling.reset_spans()


def test_readers_return_none_without_spans(monkeypatch):
    bare = dict(CTX, host=[("aten::add", 0.0, 1.0)])
    for name in ("host_syncs_per_step.train", "sync_idle.train"):
        assert read(name, bare) is None
    monkeypatch.delattr(profiling, "span_table")                    # an older port
    for name in ("prepare_ms.train", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "slot_tables_s"):
        assert read(name) is None


def test_phase_readers_return_none_when_nothing_was_timed(monkeypatch):
    """Spans that ran with no profiler recording have no device seconds."""
    monkeypatch.setattr(profiling, "span_table", lambda: {
        k: dict(v, device_s=0.0, self_device_s=0.0) for k, v in TABLE.items()})
    for name in ("prepare_ms.train", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train"):
        assert read(name) is None
    monkeypatch.setattr(profiling, "span_table", lambda: {})
    assert read("slot_tables_s") is None
