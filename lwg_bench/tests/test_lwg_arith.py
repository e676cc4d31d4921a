"""The benchmark's arithmetic on synthetic records: device time as a
union of intervals, idle gaps and the breakdown, the rates and the tail
over the whole window, the roofline and mfu shares, and the z-buffer's
counted work."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from lwg_bench import trace
from lwg_bench.reference import geometry as G

BENCH = Path(__file__).resolve().parents[1]


def read(name, rec):
    sp = importlib.util.spec_from_file_location(
        f"t_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read(rec)


def test_union_counts_overlapping_streams_once():
    # two streams: [0, 10) and [5, 12) overlap; [20, 25) stands alone
    spans = [(0, 10), (5, 12), (20, 25), (21, 22)]
    assert trace.union_s(spans) == pytest.approx(17e-9)
    assert trace.gaps(spans, 0, 30) == [(12, 20), (25, 30)]
    assert trace.gaps([], 3, 9) == [(3, 9)]


class _Event:
    def __init__(self, name, a, b, kind, note=False):
        self._n, self._a, self._d, self._k, self._u = name, a, b - a, kind, note

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._k}"

    def is_user_annotation(self):
        return self._u


class _Prof:
    def __init__(self, evs):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("K", (), {"events": lambda s: evs})()


def test_reduce_profile_breakdown():
    evs = [
        _Event("bench.window", 0, 1000, "CPU"),
        _Event("bench.window", 0, 1000, "CUDA", note=True),
        _Event("aten::conv", 0, 300, "CPU"),
        _Event("cudaMemcpyAsync", 500, 700, "CPU"),
        _Event("conv_kernel", 100, 400, "CUDA"),
        _Event("norm_kernel", 350, 450, "CUDA"),     # side stream overlap
        _Event("conv_kernel", 800, 900, "CUDA"),
    ]
    red = trace.device_summary(_Prof(evs), 1e-6)
    assert red["busy_s"] == pytest.approx(450e-9)
    assert red["window_s"] == pytest.approx(1e-6)
    assert red["launches"] == {"conv_kernel": 2, "norm_kernel": 1}
    assert red["top_ops"][0] == ["conv_kernel", pytest.approx(400e-9)]
    idle = dict(map(tuple, trace.idle_by_host(_Prof(evs))))
    # [0,100) under aten::conv; [450,800) and [900,1000) begin with no op
    # running, in the harness's range
    assert idle["aten::conv"] == pytest.approx(100e-9)
    assert idle["bench.window (python)"] == pytest.approx(450e-9)
    assert read("device_idle.imitate", {"profile": red}) == \
        pytest.approx(55.0)


def test_rates_and_tail_over_the_whole_window():
    # (index, frames, start, end): a stall in job 2 must show in both
    jobs = [(0, 32, 0.0, 0.1), (1, 96, 0.1, 0.4), (2, 64, 0.4, 1.9),
            (3, 40, 1.9, 2.0)]
    rec = {"jobs": jobs, "window_s": 2.0, "setup_s": 7.5}
    assert read("frames_per_s", rec) == pytest.approx(232 / 2.0)
    lat = [100.0, 300.0, 1500.0, 100.0]
    assert read("job_p95_ms", rec) == pytest.approx(np.percentile(lat, 95))
    assert read("setup_s", rec) == 7.5
    assert read("frames_per_s", {"jobs": [], "window_s": 1.0}) is None


def test_roofline_and_mfu_shares():
    prof = {"device_ops": {"void zbuffer_bucket_kernel<true, 16>(x)": 2e-3,
                           "void zbuffer_bucket_kernel<false, 16>(x)": 9.0,
                           "other": 1.0},
            "launches": {"void zbuffer_bucket_kernel<true, 16>(x)": 4,
                         "void zbuffer_bucket_kernel<false, 16>(x)": 1,
                         "other": 3}}
    rec = {"profile": prof, "flow_least_s": 5e-4,
           "info": {"flow_launches_counted": 4}}
    assert read("zbuffer_flow_roofline", rec) == pytest.approx(25.0)
    rec["info"]["flow_launches_counted"] = 5      # launches disagree
    assert read("zbuffer_flow_roofline", rec) is None
    flops = {"bfloat16": 989e12 * 0.5, "float32": 67e12 * 0.25}
    rec = {"useful_flops": flops, "peak": trace.PEAK, "window_s": 7.5}
    assert read("mfu.imitate", rec) == pytest.approx(10.0)
    assert trace.bound_s(67e9, 1.0) == pytest.approx(1e-3)
    assert trace.bound_s(1.0, 3.35e9) == pytest.approx(1e-3)


def _brute_counts(fv, s):
    """Pairs of pixel and front-facing face with the pixel in the face's
    pixel box, and those inside, by a loop over faces."""
    box = hit = 0
    sf = float(s)
    for b in range(fv.shape[0]):
        for f in range(fv.shape[1]):
            x, y = fv[b, f, :, 0], fv[b, f, :, 1]
            if not ((y[2] - y[0]) * (x[1] - x[0])
                    >= (y[1] - y[0]) * (x[2] - x[0])):
                continue
            px, py = 0.5 * (x * sf + sf - 1), 0.5 * (y * sf + sf - 1)
            x0, x1 = max(math.ceil(px.min()), 0), min(math.floor(px.max()),
                                                      s - 1)
            y0, y1 = max(math.ceil(py.min()), 0), min(math.floor(py.max()),
                                                      s - 1)
            for yi in range(y0, y1 + 1):
                for xi in range(x0, x1 + 1):
                    box += 1
                    xp, yp = (2 * xi + 1 - sf) / sf, (2 * yi + 1 - sf) / sf
                    t = [(yp - y[k]) * (x[(k + 1) % 3] - x[k])
                         - (xp - x[k]) * (y[(k + 1) % 3] - y[k])
                         for k in range(3)]
                    hit += all(v >= 0 for v in t)
    return box, hit


def test_zbuffer_counts_and_bytes():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-0.8, 0.8, (2, 60, 1, 2)) \
        + rng.uniform(-0.15, 0.15, (2, 60, 3, 2))
    z = rng.uniform(1.5, 3.0, (2, 60, 3, 1))
    fv = torch.from_numpy(np.concatenate([xy, z], -1).astype(np.float32))
    _, _, (box, hit) = G.zbuffer(fv, 32, count=True)
    want = _brute_counts(fv.double().numpy(), 32)
    assert (box, hit) == want
    assert G.flow_bytes(16, 12880, 256) == \
        4 * (9 * 16 * 12880 + 6 * 12880) + 12 * 16 * 256 * 256


def test_zbuffer_equals_the_ports_brute_raster():
    """The reference's z-buffer (each face's pixel box, a scatter-min)
    picks the same face at every pixel as the port's brute z-buffer
    (every pixel against every face), on the benchmark's body."""
    from impersonator_tpu_torch.ops import rasterizer

    from lwg_bench.reference import body
    arrays = body.body_arrays()
    b = G.Body(arrays, "cpu")
    rng = np.random.default_rng(4)
    theta = np.zeros((2, 85), np.float32)
    theta[:, 0] = 0.9
    theta[:, 3:75] = rng.normal(0, 0.1, (2, 72))
    verts, _, cam = G.smpl(b, torch.from_numpy(theta))
    fv = G.face_verts(b, verts, cam)
    fim, wim = G.zbuffer(fv, 64)
    want_fim, want_wim = rasterizer.rasterize_fim_wim(fv, 64)
    assert torch.equal(fim, want_fim.long())
    assert (fim >= 0).any()
    assert torch.allclose(wim, want_wim, atol=1e-5)
