"""The port's spans (``utils/profiling.span``): nesting, counts and self
time, the profiler's host events, and that every blocking read of the
device on the training and rollout paths lies inside a ``mswe.sync.*``
span.

The containment cases run one train step (3-step pushforward, remat) and
one rollout of a union of two 16x16 bench graphs under torch's CPU
profiler, MSGNN (3 scales) and the single-scale GNN at F=8, K=1, and find
every ``aten::_local_scalar_dense`` (a scalar read back to the host) and
every ``aten::bincount`` (on CUDA it reads its input's extrema back) whose
nearest Python frame is in the port. AdamW's reads of its step counters
(``torch/optim``) are CPU tensors on the card too, no device sync, and are
not counted. The last test runs on the card (marker ``gpu``) under
``torch.cuda.set_sync_debug_mode``, which names every synchronising call.
"""
import re
import threading
import time
import traceback
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mswe_gnn_tpu_torch.bench_problem import (build_bench_model, build_bench_sample,
                                              build_bench_train_step, build_pareto_gnn_model)
from mswe_gnn_tpu_torch.graph import concat_graphs, stack_graphs
from mswe_gnn_tpu_torch.training.rollout import rollout, rollout_batch
from mswe_gnn_tpu_torch.utils import profiling

PY_FRAME = re.compile(r"^(\S+\.py)\(\d+\): ")


@pytest.fixture(autouse=True)
def fresh_table():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_span_counts_nesting_and_host_time():
    with profiling.span("mswe.outer"):
        assert profiling.open_spans() == ["mswe.outer"]
        for _ in range(3):
            with profiling.span("mswe.inner"):
                assert profiling.open_spans() == ["mswe.outer", "mswe.inner"]
                time.sleep(0.002)
        with profiling.span("mswe.sync.site", 2):
            pass
    assert profiling.open_spans() == []
    table = profiling.span_table()
    assert {k: v["count"] for k, v in table.items()} == {
        "mswe.outer": 1, "mswe.inner": 3, "mswe.sync.site": 2}
    assert table["mswe.inner"]["host_s"] >= 0.006
    assert table["mswe.outer"]["host_s"] >= table["mswe.inner"]["host_s"]
    # no profiler recorded: nothing was timed on a device
    assert all(v["device_s"] == 0.0 == v["self_device_s"] for v in table.values())
    profiling.reset_spans()
    assert profiling.span_table() == {}


def test_span_closes_when_its_body_raises():
    with pytest.raises(ValueError):
        with profiling.span("mswe.raises"):
            raise ValueError("body")
    assert profiling.open_spans() == []
    assert profiling.span_table()["mswe.raises"]["count"] == 1


def test_each_thread_keeps_its_own_stack_and_the_table_sums_them():
    seen = {}

    def worker():
        with profiling.span("mswe.worker"):
            seen["open"] = profiling.open_spans()

    with profiling.span("mswe.main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["open"] == ["mswe.worker"]
    assert {k: v["count"] for k, v in profiling.span_table().items()} == {
        "mswe.main": 1, "mswe.worker": 1}


def _host_names(prof):
    return [e.name for e in prof.events() if e.name.startswith("mswe.")]


def test_a_host_event_only_while_a_profiler_records():
    with profiling.span("mswe.before"):
        torch.ones(4).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert _host_names(prof) == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("mswe.during"):
            with profiling.span("mswe.sync.twice", 2):
                torch.ones(4).sum()
    assert sorted(_host_names(prof)) == ["mswe.during", "mswe.sync.twice*2"]
    events = {e.name: e for e in prof.events()}
    # a function-scope event: no user annotation, so no device-side copy
    assert not events["mswe.during"].is_user_annotation
    outer, inner = events["mswe.during"].time_range, events["mswe.sync.twice*2"].time_range
    assert outer.start <= inner.start and inner.end <= outer.end
    assert profiling.span_table()["mswe.sync.twice"]["count"] == 2


class _FakeEvent:
    """A CUDA timing event on the host's clock, for the CPU."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_seconds_and_self_time(monkeypatch):
    """Under a profiler on a (stand-in) CUDA device, a span's events give
    its device seconds when the table is read, and its self time is that
    less what the spans opened inside it took."""
    with profile(activities=[ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
        with profiling.span("mswe.phase"):
            time.sleep(0.004)
            for _ in range(2):
                with profiling.span("mswe.child"):
                    time.sleep(0.003)
        monkeypatch.undo()
    table = profiling.span_table()
    phase, child = table["mswe.phase"], table["mswe.child"]
    assert child["device_s"] >= 0.006 and child["self_device_s"] == child["device_s"]
    assert phase["device_s"] >= 0.010
    assert phase["self_device_s"] == pytest.approx(phase["device_s"] - child["device_s"])
    assert phase["self_device_s"] >= 0.004
    # read once: a second read adds nothing
    assert profiling.span_table() == table


def _port_frame(event):
    """The nearest Python frame above a profiler event, if it is the port's."""
    parent = event.cpu_parent
    while parent is not None:
        m = PY_FRAME.match(parent.name)
        if m:
            return parent.name if "mswe_gnn_tpu_torch/" in m.group(1) else None
        parent = parent.cpu_parent
    return None


def _reads_in_sync_spans(fn) -> dict:
    """The port's scalar reads and ``bincount`` calls in ``fn`` under the CPU
    profiler -> ``{(op, inside a mswe.sync span of its thread): count}``."""
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        fn()
    events = list(prof.events())
    syncs = [(e.thread, e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith(profiling.SYNC)]
    out = {}
    for e in events:
        if e.name not in ("aten::_local_scalar_dense", "aten::bincount") or not _port_frame(e):
            continue
        inside = any(th == e.thread and s <= e.time_range.start and e.time_range.end <= end
                     for th, s, end in syncs)
        out[(e.name, inside)] = out.get((e.name, inside), 0) + 1
    return out


@pytest.fixture(scope="module")
def bench_models():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for model in ("MSGNN", "GNN"):
        sample, _ = build_bench_sample(16, 16, 8, num_scales=3 if model == "MSGNN" else 1)
        if model == "MSGNN":
            built = build_bench_model(sample, device="cpu", hid_features=8, K=1,
                                      compute_dtype="float32")
        else:
            built = build_pareto_gnn_model(sample, device="cpu", hid_features=8, K=1)
        out[model] = (sample, *built)
    yield out
    torch.set_num_threads(threads)


@pytest.mark.parametrize("model, unit, reads, bincounts", [
    ("MSGNN", "train", 29, 5), ("MSGNN", "rollout", 14, 0),
    ("GNN", "train", 5, 1), ("GNN", "rollout", 2, 0)])
def test_every_blocking_read_lies_in_a_sync_span(bench_models, model, unit, reads, bincounts):
    """MSGNN's train step reads 24 scalars in ``_check_rows`` (7 tables
    built by ``_msgnn_cache`` and 5 out-slot tables, two reads each) and 5
    in ``out_slot_table``'s check, and runs 5 ``bincount``s; its rollout
    builds no out-slot table (14 reads). The GNN has one table of each."""
    sample, cfg, params, apply_fn = bench_models[model]
    if unit == "train":
        step = build_bench_train_step(sample, cfg, params, apply_fn, device="cpu", batch=2,
                                      multiscale=model == "MSGNN")
        step.rollout_steps = 3
        fn = step
    else:
        union = concat_graphs([sample] * 2)
        steps = sample.y.shape[-1]

        def fn():
            rollout(apply_fn, params, cfg, union, steps, device="cpu")
    want = {("aten::_local_scalar_dense", True): reads}
    if bincounts:
        want[("aten::bincount", True)] = bincounts
    assert _reads_in_sync_spans(fn) == want
    table = profiling.span_table()
    synced = sum(v["count"] for k, v in table.items() if k.startswith(profiling.SYNC))
    # a bincount blocks twice on CUDA, and the loss's scaler is one blocking copy
    assert synced == reads + 2 * bincounts + (unit == "train")
    assert table["mswe.prepare_graph"]["count"] == 1
    phases = {"mswe.train.forward", "mswe.train.backward", "mswe.train.optimizer"}
    assert phases <= set(table) if unit == "train" else not phases & set(table)


def test_graph_build_times_its_slot_tables():
    build_bench_sample(12, 12, 4, num_scales=2)
    row = profiling.span_table()["mswe.graph.slot_tables"]
    assert row["count"] == 1 and row["host_s"] > 0


@pytest.mark.gpu
def test_every_synchronising_call_lies_in_a_sync_span_on_the_card():
    """On the card, every call that ``set_sync_debug_mode`` names during a
    train step, a rollout and a ``rollout_batch`` of small bench graphs
    happens inside a ``mswe.sync.*`` span, and each span's count is the
    number of such calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    dev = torch.device("cuda")
    sample, _ = build_bench_sample(16, 16, 8)
    cfg, params, apply_fn = build_bench_model(sample, device=dev, hid_features=16, K=2)
    step = build_bench_train_step(sample, cfg, params, apply_fn, device=dev, batch=2)
    step.rollout_steps = 3
    union = concat_graphs([sample] * 2).to(dev)
    stacked = stack_graphs([sample] * 2).to(dev)
    steps = sample.y.shape[-1]
    units = [step, lambda: rollout(apply_fn, params, cfg, union, steps, device=dev),
             lambda: rollout_batch(apply_fn, params, cfg, stacked, steps, device=dev)]
    for unit in units:
        unit()                        # built, and every one-time table placed
    torch.cuda.synchronize()
    for unit in units:
        calls, recording = [], []

        def show(message, *args, **kwargs):
            if recording and "synchroniz" in str(message):
                stack = [f"{f.filename}:{f.lineno}" for f in traceback.extract_stack()
                         if "mswe_gnn_tpu_torch" in f.filename or "torch/" in f.filename]
                calls.append((profiling.open_spans(), threading.current_thread().name,
                              stack[-4:]))

        profiling.reset_spans()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")      # warns itself once a process
            recording.append(True)
            try:
                unit()
            finally:
                recording.clear()
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        outside = [c for c in calls if not any(n.startswith(profiling.SYNC) for n in c[0])]
        assert outside == []
        counted = sum(v["count"] for k, v in profiling.span_table().items()
                      if k.startswith(profiling.SYNC))
        assert counted == len(calls)
