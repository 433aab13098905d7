"""The program's spans in a synthetic trace: each device operation put down
to its stage, the idle intervals inside a span, the cudaMalloc calls, the
farm call's split, and that the harness's own reduction and readers read
the same with the program's spans in the events as without them."""

import pytest

from portbench import harness, shapes, stages, trace

import pb_tiny


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 2, corr=corr)


# One farm call and one update in a 1000 µs window.  The card runs 100-410
# (the call) and 600-670 (the update's table and rows); it idles 0-100,
# 410-600 and 670-1000.
PROGRAM = [
    _x("user_annotation", "fftconv.farm.process", 22, 468),
    _x("user_annotation", "fftconv.farm.tail_fwd", 25, 15),
    _x("user_annotation", "fftconv.farm.tail_fwd", 45, 15),
    _x("user_annotation", "fftconv.farm.tail_inv", 70, 20),
    _x("user_annotation", "fftconv.farm.suppress", 101, 25),
    _x("user_annotation", "fftconv.farm.update", 501, 78),
    _x("user_annotation", "fftconv.farm.update.table", 525, 35),
]
HARNESS = [
    _x("user_annotation", "portbench.window", 0, 1000),
    _x("user_annotation", "portbench.call", 10, 590),
    _x("user_annotation", "portbench.process", 20, 480),
    _x("user_annotation", "portbench.update", 500, 80),
    _launch(30, 1), _launch(50, 2), _launch(65, 3), _launch(75, 4), _launch(80, 5),
    _launch(110, 6), _launch(130, 7), _launch(135, 8), _launch(530, 9), _launch(570, 10),
    _x("cuda_runtime", "cudaMalloc", 112, 10),   # in the suppress pass
    _x("cuda_runtime", "cudaMalloc", 562, 5),    # in the update, after its table
    _x("cuda_runtime", "cudaMalloc", 700, 5),    # in the harness, outside the farm
    _x("kernel", "elementwise_kernel (the tail's rows)", 100, 10, corr=1),
    _x("kernel", "vector_fft_r2c_65536", 110, 30, corr=2),
    _x("kernel", "void b5_phased<8>", 140, 160, corr=3),
    _x("kernel", "vector_fft_c2r_65536", 300, 20, corr=4),
    _x("kernel", "CatArrayBatchedCopy", 320, 10, corr=5),
    _x("kernel", "elementwise_kernel (suppress)", 330, 5, corr=6),
    _x("kernel", "void b6_columns<10>", 335, 65, corr=7),
    _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 400, 10, corr=8),
    _x("kernel", "vector_fft_r2c_65536", 600, 50, corr=9),
    _x("kernel", "index_put", 650, 20, corr=10),
    _x("cpu_op", "aten::copy_", 800, 100),
    _x("gpu_user_annotation", "fftconv.farm.process", 100, 310),
]
EVENTS = HARNESS + PROGRAM


def test_ops_go_to_the_innermost_program_span_around_their_launch():
    st = stages.reduce(EVENTS)
    by = {o.name: o.stage for o in st.ops}
    assert by["elementwise_kernel (the tail's rows)"] == "fftconv.farm.tail_fwd"
    assert by["vector_fft_c2r_65536"] == "fftconv.farm.tail_inv"
    assert by["void b5_phased<8>"] == by["void b6_columns<10>"] == "fftconv.farm.process"
    assert by["elementwise_kernel (suppress)"] == "fftconv.farm.suppress"
    assert by["index_put"] == "fftconv.farm.update"
    assert [o.stage for o in st.ops if o.name == "vector_fft_r2c_65536"] == [
        "fftconv.farm.tail_fwd", "fftconv.farm.update.table"]
    assert {o.span for o in st.ops} == {"portbench.process", "portbench.update"}
    assert st.spans["fftconv.farm.tail_fwd"] == [(25, 40), (45, 60)]
    assert st.gaps == [(0, 100), (410, 600), (670, 1000)]
    assert st.mallocs == [(112, 10, "fftconv.farm.suppress"), (562, 5, "fftconv.farm.update"),
                          (700, 5, "")]
    assert st.farm_mallocs() == 2


def test_idle_inside_a_span_is_the_intersection_of_the_intervals():
    st = stages.reduce(EVENTS)
    # process 22-490 against the gaps 0-100 and 410-600; update 501-579 in 410-600
    assert st.idle_ms("fftconv.farm.process") == pytest.approx((78 + 80) / 1e3)
    assert st.idle_ms("fftconv.farm.update") == pytest.approx(78 / 1e3)
    assert st.idle_ms("fftconv.farm.suppress") == 0.0
    assert st.idle_ms("fftconv.no.such.span") == 0.0


def test_split_reads_the_farm_call_by_stage_and_adds_up():
    got = stages.split(stages.reduce(EVENTS), calls=2)
    want = {"tail_fwd_ms": 40, "tail_inv_ms": 30, "suppress_ms": 5, "update_table_ms": 50,
            "process_idle_ms": 158, "update_idle_ms": 78, "glue_rest_ms": 10,
            "process_ms": 310, "update_ms": 70, "portbench_process_ms": 310,
            "portbench_update_ms": 70, "farm_glue_ms": 85, "stages_glue_ms": 85}
    for k, us in want.items():
        assert got[k] == pytest.approx(us / 1e3 / 2), k
    assert got["cuda_mallocs_per_call"] == 1.0
    assert set(got) == set(want) | {"cuda_mallocs_per_call", "idle_ms_by_span",
                                    "idle_ms_by_host_event"}


def test_idle_is_put_down_to_what_the_host_was_in():
    """Every idle microsecond goes to the innermost span the host was in
    (none: ""); inside the farm's spans, to the innermost host event too."""
    st = stages.reduce(EVENTS)
    by_span = st.idle_by(spans_only=True)
    assert sum(by_span.values()) == pytest.approx(100 + 190 + 330)
    assert by_span[""] == pytest.approx(10 + 330)  # before the call, after the update
    farm = {k: v for k, v in by_span.items() if k.startswith("fftconv.farm.")}
    assert sum(v for k, v in farm.items() if "update" not in k) == pytest.approx(158)
    assert farm["fftconv.farm.update"] + farm["fftconv.farm.update.table"] == pytest.approx(78)
    by_event = st.idle_by(spans_only=False)
    assert sum(by_event.values()) == pytest.approx(158 + 78)
    assert by_event["fftconv.farm.update > cudaMalloc"] == pytest.approx(5)
    assert by_event["fftconv.farm.tail_fwd > cudaLaunchKernel"] == pytest.approx(4)
    got = stages.split(st, calls=2)
    assert got["idle_ms_by_span"]["fftconv.farm.update.table"] == pytest.approx(35 / 1e3 / 2)
    assert len(got["idle_ms_by_host_event"]) == 10


def test_split_is_none_where_the_program_opens_no_span():
    got = stages.split(stages.reduce(HARNESS), calls=1)
    assert {k for k, v in got.items() if v is not None} == {
        "portbench_process_ms", "portbench_update_ms", "farm_glue_ms", "idle_ms_by_span",
        "idle_ms_by_host_event"}
    assert got["idle_ms_by_host_event"] == {}
    assert not any(k.startswith("fftconv.") for k in got["idle_ms_by_span"])
    # a span that ran and launched nothing reads 0, not None
    quiet = EVENTS + [_x("user_annotation", "fftconv.farm.suppress", 140, 5)]
    quiet = [e for e in quiet if e.get("args", {}).get("correlation") != 6]
    assert stages.split(stages.reduce(quiet), calls=1)["suppress_ms"] == 0.0
    with pytest.raises(RuntimeError):
        stages.reduce(PROGRAM)


def _ctx(tr, engine):
    cfg = pb_tiny.config(engine)
    traffic = pb_tiny.traffic("morph8" if engine == "reverb_farm" else "render")
    return harness.Context(tr, 2, cfg, traffic, shapes.two_stage(cfg), 2 * 256 // 16,
                           cfg["voices"], None, [0.001, 0.002])


READERS = {"reverb_farm": ("b5_roofline_pct", "b6_roofline_pct", "farm_call_roofline_pct",
                           "farm_glue_ms", "update_ms.morph", "device_idle_pct.farm"),
           "two_stage": ("enqueue_ms.render", "device_idle_pct.render")}


def test_the_harness_reads_the_same_with_the_program_spans_as_without():
    """Every field of the harness's reduction, and every reader of the
    farm's cells, is the same with the program's spans in the events; only
    the names of the idle gaps may now be a program span, the innermost host
    event there."""
    with_spans, without = trace.reduce(EVENTS), trace.reduce(HARNESS)
    for field in ("ops", "spans", "window_s", "busy_s", "device_ops"):
        assert getattr(with_spans, field) == getattr(without, field), field
    assert [g[1] for g in with_spans.idle_gaps] == [g[1] for g in without.idle_gaps]
    renamed = [(a[0], b[0]) for a, b in zip(with_spans.idle_gaps, without.idle_gaps)
               if a[0] != b[0]]
    assert renamed and all(a.startswith("fftconv.farm.") for a, _ in renamed)
    for engine, names in READERS.items():
        for name in names:
            read = harness.load_module("metrics", name).read
            assert read(_ctx(with_spans, engine)) == read(_ctx(without, engine)), name
