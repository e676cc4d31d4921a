"""The span table (``lwg_bench/spans.py``) on synthetic profiles: nested
spans' inclusive and self device time, overlapping activities counted
once, a launch from another thread inside a span's interval, idle gaps
and blocking calls by the span they began in, the readers of the
per-layer values; and ``span_split.split`` on a tiny train cell on the
CPU."""

import json

import pytest

from lwg_bench import spans, span_split, run
from lwg_bench.tests import tiny


class _Event:
    def __init__(self, name, a, b, kind, corr=0, note=False):
        self._n, self._a, self._d = name, a, b - a
        self._k, self._c, self._u = kind, corr, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._k}"

    def correlation_id(self):
        return self._c

    def is_user_annotation(self):
        return self._u


def _prof(evs):
    p = type("P", (), {})()
    p.profiler = type("K", (), {})()
    p.profiler.kineto_results = type("R", (), {"events": lambda s: evs})()
    return p


def span(name, a, b):
    return _Event(name, a, b, "CPU", note=True)


def call(name, t, corr):
    return _Event(name, t, t + 5, "CPU", corr)


def kernel(a, b, corr, name="k"):
    return _Event(name, a, b, "CUDA", corr)


# train.step [0, 1000) holds train.g_loss [100, 400) and train.g_grad
# [400, 900); the backward's launch (corr 3) comes from another thread
EVENTS = [
    _Event("bench.window", 0, 1000, "CPU", note=True),
    _Event("bench.window", 0, 1000, "CUDA", note=True),
    span("train.step", 0, 1000), span("train.g_loss", 100, 400),
    span("train.g_grad", 400, 900),
    _Event("train.g_loss", 200, 600, "CUDA", note=True),     # a mirror
    _Event("aten::conv", 110, 150, "CPU", corr=1),
    call("cudaLaunchKernel", 50, 1),      # in train.step only
    call("cudaLaunchKernel", 150, 2),     # in train.g_loss
    call("cudaLaunchKernel", 160, 4),     # in train.g_loss, overlaps 2
    call("cudaLaunchKernel", 450, 3),     # autograd's thread
    call("cudaStreamSynchronize", 420, 0),
    call("cudaMemcpyAsync", 430, 0),
    kernel(200, 300, 1), kernel(500, 700, 2), kernel(600, 750, 4),
    kernel(800, 850, 3),
]


def test_nested_spans_inclusive_and_self_time():
    rows = spans.table(_prof(EVENTS))
    assert set(rows) == {"train.step", "train.g_loss", "train.g_grad"}
    step, loss, grad = (rows[n] for n in ("train.step", "train.g_loss",
                                          "train.g_grad"))
    assert step["n"] == loss["n"] == grad["n"] == 1
    # the union: [200, 300) + [500, 750) + [800, 850)
    assert step["device_s"] == pytest.approx(400e-9)
    assert step["self_s"] == pytest.approx(100e-9)
    # [500, 700) and [600, 750) overlap: counted once
    assert loss["device_s"] == pytest.approx(250e-9)
    assert loss["self_s"] == pytest.approx(250e-9)
    # launched from another thread, inside train.g_grad's interval
    assert grad["device_s"] == pytest.approx(50e-9)
    assert step["host_s"] == pytest.approx(1000e-9)
    assert loss["under"] == {"train.step": pytest.approx(250e-9)}


def test_idle_gaps_and_blocking_calls_by_the_span_they_began_in():
    rows = spans.table(_prof(EVENTS))
    # gaps of the window [0, 1000): [0, 200) [300, 500) [750, 800)
    # [850, 1000); train.g_loss holds 300, train.g_grad 750 and 850
    assert rows["train.step"]["idle_s"] == pytest.approx(600e-9)
    assert rows["train.g_loss"]["idle_s"] == pytest.approx(200e-9)
    assert rows["train.g_grad"]["idle_s"] == pytest.approx(200e-9)
    # the synchronise at 420 blocks; the async copy does not
    assert rows["train.step"]["syncs"] == 1
    assert rows["train.g_grad"]["syncs"] == 1
    assert rows["train.g_loss"]["syncs"] == 0
    assert spans.blocking("cudaMemcpy") and spans.blocking("cudaMemcpy2D")
    assert not spans.blocking("cudaMemcpyAsync")


def test_mirrors_are_no_activity_and_unlinked_activity_no_span():
    ranges, calls, dev, window = spans.events(_prof(EVENTS))
    assert window == (0, 1000)
    assert [d[0] for d in dev] == ["k"] * 4
    assert [c[0] for c in calls] == ["cudaLaunchKernel"] * 4 + [
        "cudaStreamSynchronize", "cudaMemcpyAsync"]
    att = spans.Attribution(ranges, calls,
                            dev + [("k", 950, 990, 99)], window)
    assert att.dev[-1][2] == ()             # no launch: no span
    assert att.union_s(["train.g_loss", "train.g_grad"]) == \
        pytest.approx(300e-9)


def test_readers_per_batch_and_per_step():
    rows = {"imitate.batch": {"n": 4, "device_s": 0.08,
                              "under": {"imitate.batch": 0.08}},
            "warp": {"n": 24, "device_s": 0.03,
                     "under": {"imitate.batch": 0.02,
                               "personalize": 0.01}},
            "imitate.generator": {"n": 4, "device_s": 0.04,
                                  "under": {"imitate.batch": 0.04}},
            "hmr": {"n": 1, "device_s": 0.004,
                    "under": {"personalize": 0.004}}}
    rec = {"spans": rows}
    assert spans.metric(rec, "warp_ms") == pytest.approx(5.0)
    assert spans.metric(rec, "generator_ms") == pytest.approx(10.0)
    # HMR ran, but never inside a batch
    assert spans.metric(rec, "hmr_batch_ms") is None
    assert spans.metric({"spans": {**rows, "imitate.generator": {
        "n": 4, "device_s": 0.0123456, "under": {}}}},
        "generator_ms") == 3.086
    assert spans.rounded({"a": {"b": 0.123456789}}) == {"a": {"b": 0.1235}}


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_readers_give_nothing_without_spans(name):
    assert spans.metric({}, name) is None
    assert spans.metric({"spans": {}}, name) is None
    assert spans.metric({"spans": {"imitate.batch": {
        "n": 1, "device_s": 1.0, "under": {}}}}, name) is None


def test_split_of_a_tiny_train_cell_on_the_cpu():
    _, cfg, mix = run.cell_of(run.spec(), "train-b16")
    cfg.update(tiny.TINY_TRAIN)
    mix.update(tiny.TINY_TRAIN_MIX)
    out = span_split.split(cfg, mix, 2 ** 31 + 3, "cpu", 2, cost_n=200)
    json.dumps(out)
    assert out["same_device_ops"] and out["span_names_in_device_ops"] == []
    rows = out["spans"]
    assert rows["train.step"]["n"] == 2
    for name in span_split.TRAIN_CHILDREN:
        assert rows[name]["n"] == 2
    assert out["span_cost_us"]["off"] > 0
