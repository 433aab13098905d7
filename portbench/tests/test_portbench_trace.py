"""The trace reduction and the per-layer readers on synthetic traces."""

import pytest

from portbench import harness, shapes, trace

import pb_tiny


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


EVENTS = [
    _x("user_annotation", "portbench.window", 0, 1000),
    _x("user_annotation", "portbench.call", 10, 300),
    _x("user_annotation", "portbench.process", 20, 100),
    _x("user_annotation", "portbench.update", 150, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=2),
    _x("kernel", "void b5_phased<8>", 200, 100, corr=1),
    _x("kernel", "elementwise", 400, 50, corr=2),
    _x("gpu_memcpy", "Memcpy DtoD", 460, 10, corr=3),
    _x("cpu_op", "aten::foo", 500, 400),
    _x("kernel", "after the window", 2000, 10, corr=4),
]


def test_reduce_ties_ops_to_spans_and_finds_the_gaps():
    tr = trace.reduce(EVENTS)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx(160e-6)
    assert tr.device_s("portbench.process") == pytest.approx(100e-6)
    assert tr.device_s("portbench.update") == pytest.approx(50e-6)
    assert tr.device_s(match=lambda n: "b5_" in n) == pytest.approx(100e-6)
    assert tr.count() == 2 and tr.count(kernels_only=False) == 3
    assert tr.device_ops[0] == ["void b5_phased<8>", pytest.approx(100e-6)]
    assert tr.idle_gaps[0] == ["aten::foo", pytest.approx(530e-6)]
    assert [g[1] for g in tr.idle_gaps] == sorted((g[1] for g in tr.idle_gaps), reverse=True)


def test_device_only_trace_takes_every_op_and_the_host_window():
    dev = [e for e in EVENTS if e["cat"] in trace.DEVICE_CATS][:-1]
    tr = trace.reduce(dev, window_s=0.002)
    assert tr.window_s == pytest.approx(0.002)
    assert tr.device_s() == pytest.approx(160e-6)
    assert tr.count() == 2
    # with no spans to filter by, a span filter would take every op unseen
    with pytest.raises(ValueError):
        tr.device_s(("portbench.process", "portbench.reset"))
    with pytest.raises(ValueError):
        tr.count("portbench.process")
    with pytest.raises(RuntimeError):
        trace.reduce(dev)


def _ctx(events, config, traffic, calls=1):
    return harness.Context(trace.reduce(events), calls, config, traffic,
                           shapes.two_stage(config), 2 * 256 // 16, config["voices"], None, [])


def test_readers_return_nothing_where_there_is_nothing_to_read():
    farm = pb_tiny.config("reverb_farm")
    ctx = _ctx(EVENTS[:6], farm, pb_tiny.traffic("dev8"))
    for name in ("b5_roofline_pct", "b6_roofline_pct", "farm_glue_ms", "update_ms.morph",
                 "device_idle_pct.farm", "farm_call_roofline_pct"):
        assert harness.load_module("metrics", name).read(ctx) is None, name


def test_readers_read_the_trace():
    farm = pb_tiny.config("reverb_farm")
    ctx = _ctx(EVENTS, farm, pb_tiny.traffic("morph8"), calls=2)
    read = {n: harness.load_module("metrics", n).read(ctx)
            for n in ("farm_glue_ms", "update_ms.morph", "device_idle_pct.farm",
                      "b5_roofline_pct")}
    assert read["farm_glue_ms"] == pytest.approx(0.0)  # the process span ran only B5
    assert read["update_ms.morph"] == pytest.approx(50e-6 / 2 * 1e3)
    assert read["device_idle_pct.farm"] == pytest.approx(84.0)
    assert read["b5_roofline_pct"] is None  # no peaks off the card


def test_render_readers_read_a_trace_of_the_device_alone():
    hall = pb_tiny.config("two_stage")
    dev = [e for e in EVENTS if e["cat"] in trace.DEVICE_CATS][:-1]
    ctx = harness.Context(trace.reduce(dev, window_s=0.002), 2, hall, pb_tiny.traffic("render"),
                          shapes.two_stage(hall), 64 * 16, 1, None, [])
    assert harness.load_module("metrics", "kernels_per_track.render").read(ctx) == 1.0
    # every op of the window counts; no peaks off the card, so no share
    assert harness.load_module("metrics", "stream_roofline_pct.render").read(ctx) is None
    assert harness.load_module("metrics", "device_idle_pct.render").read(ctx) == \
        pytest.approx(100.0 * (1 - 160e-6 / 0.002))
