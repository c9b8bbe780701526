"""The port's spans (``pycusdr_tpu_torch/obs/profiling.py``): nothing
recorded while no ``torch.profiler`` session runs; nesting, parents, call
ids, self time, the store's bounds and ``summary()`` under a CPU-only
profiler; the block graph's spans on the CPU; the benchmark's four readers
of them; and, on the card (marked ``cuda``), the graph's device events
against a profiler trace of the same calls and ``device_trace``'s
attribution of the kernels. Run the card's with
``python -m pytest --noconftest tests/test_torch_tracing.py -m cuda``."""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.obs import profiling

CPU_ONLY = [torch.profiler.ProfilerActivity.CPU]
READERS = ["graph_host_ms_p50", "launch_host_ms_per_call", "graph_stream_ms_p50",
           "download_wait_ms_p50"]
STAGES = {"tiny": ["graph.fft", "graph.doppler", "graph.mask_bank", "graph.timing",
                   "graph.centres"],
          "tiny_stx": ["graph.clip", "graph.fft", "graph.mask_bank", "graph.timing",
                       "graph.centres"]}


@pytest.fixture(autouse=True)
def fresh_store():
    profiling.reset()
    yield
    profiling.reset()


def _spec(name):
    if name == "tiny":
        return configs.tiny_spec()
    conf = configs._conf(blockSize=9, overlap=7, spsym=8, doppSteps=1, windowWidth=3)
    conf["Radios"]["Rx"][configs.RADIO].update(radioBackend="STX",
                                               disablePeakThresholding=False)
    conf["GPU"]["UHF"]["peakThresholdScale"] = 4.5
    return configs._spec(conf)


def _blocks(spec, B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, spec.Nfft)) + 1j * rng.standard_normal((B, spec.Nfft))
    return torch.from_numpy(x.astype(np.complex64))


def test_off_records_nothing_and_shares_one_object():
    assert not profiling.recording()
    a, b = profiling.span("graph"), profiling.span("launch", device=True)
    assert a is b
    with a:
        with profiling.span("graph.fft"):
            pass
    assert profiling.records() == [] and profiling.summary() == {}


def test_nesting_parent_call_id_and_self_time():
    with torch.profiler.profile(activities=CPU_ONLY):
        assert profiling.recording()
        for _ in range(2):
            with profiling.span("graph"):
                time.sleep(0.002)
                with profiling.span("graph.fft"):
                    with profiling.span("launch"):
                        time.sleep(0.003)
                with profiling.span("launch"):
                    pass
        with profiling.span("download.wait"):
            pass
    assert not profiling.recording()
    rec = profiling.records()
    assert [s.name for s in rec] == ["launch", "graph.fft", "launch", "graph"] * 2 + \
        ["download.wait"]
    first = rec[:4]
    graph = first[3]
    assert graph.parent is None and first[1].parent == first[2].parent == graph.id
    assert first[0].parent == first[1].id
    assert {s.call for s in first} == {graph.call}
    assert len({graph.call, rec[7].call, rec[8].call}) == 3
    children = (first[1].t1 - first[1].t0) + (first[2].t1 - first[2].t0)
    assert graph.self_ns == graph.t1 - graph.t0 - children
    assert graph.self_ns >= 2e6 and first[1].self_ns < first[1].t1 - first[1].t0
    assert graph.launch_ns == (first[0].t1 - first[0].t0) + (first[2].t1 - first[2].t0)
    assert all(s.t0 <= c.t0 and c.t1 <= s.t1 for s in rec for c in rec if c.parent == s.id)


def test_summary_medians():
    waits = [0.001, 0.004, 0.002]
    with torch.profiler.profile(activities=CPU_ONLY):
        for w in waits:
            with profiling.span("graph"):
                with profiling.span("launch"):
                    time.sleep(w)
    s = profiling.summary()
    rec = profiling.records()
    graphs = [r for r in rec if r.name == "graph"]
    assert s["graph"]["count"] == 3 and s["launch"]["count"] == 3
    assert s["graph"]["host_ms_p50"] == pytest.approx(
        np.median([(g.t1 - g.t0) / 1e6 for g in graphs]), abs=1e-9)
    assert s["graph"]["self_ms_p50"] == pytest.approx(
        np.median([g.self_ns / 1e6 for g in graphs]), abs=1e-9)
    assert s["graph"]["launch_ms_per_call_p50"] == pytest.approx(
        np.median([g.launch_ns / 1e6 for g in graphs]), abs=1e-9)
    assert s["graph"]["launch_ms_per_call_p50"] >= 2.0  # the middle sleep, 2 ms
    assert "device_ms_p50" not in s["graph"]


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    monkeypatch.setattr(profiling, "PER_NAME", 5)
    profiling.reset()
    with torch.profiler.profile(activities=CPU_ONLY):
        for _ in range(30):
            with profiling.span("graph"):
                with profiling.span("launch"):
                    pass
    rec = profiling.records()
    assert len(rec) == 8 and rec[-1].name == "graph"
    assert profiling.summary()["graph"]["count"] == 30
    n = profiling._store.per["graph"]
    assert len(n.host) == len(n.own) == 5
    assert len(profiling._store.launch) == 5


def test_traced_decorator_and_the_decoder_span():
    from pycusdr_tpu_torch.decode.rs import RSCodec

    rs = RSCodec()
    cw = rs.encode(np.arange(rs.k, dtype=np.uint8) % 251)
    rs.decode(cw)
    assert profiling.summary() == {}
    with torch.profiler.profile(activities=CPU_ONLY):
        msg, n = rs.decode(cw)
    assert n == 0 and profiling.summary()["decode.rs"]["count"] == 1
    assert RSCodec.decode.__name__ == "decode"


@pytest.mark.parametrize("name", sorted(STAGES))
def test_cpu_block_graph_records_its_stages_and_no_launch(name):
    spec = _spec(name)
    process = build_process_batch(spec, device="cpu", packed=True)
    x = _blocks(spec, 2)
    want = process(x)
    assert profiling.summary() == {}
    with torch.profiler.profile(activities=CPU_ONLY):
        got = process(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    rec = profiling.records()
    assert [s.name for s in rec] == STAGES[name] + ["graph"]
    graph = rec[-1]
    assert all(s.parent == graph.id and s.call == graph.call for s in rec[:-1])
    assert graph.launch_ns == 0 and graph.device_ms is None and graph.events == 0
    s = profiling.summary()
    assert "launch" not in s and s["graph"]["launch_ms_per_call_p50"] == 0.0


def test_recording_grows_nothing_the_garbage_collector_tracks():
    """A recorded call of the graph leaves no more objects for the garbage
    collector than an unrecorded one: recording triggers no collection in
    the calls it records."""
    import gc

    spec = _spec("tiny")
    process = build_process_batch(spec, device="cpu", packed=True)
    x = _blocks(spec, 2)

    def growth(calls=100):
        for _ in range(3):
            process(x)
        gc.collect()
        gc.disable()
        try:
            c0 = gc.get_count()[0]
            for _ in range(calls):
                process(x)
            return gc.get_count()[0] - c0
        finally:
            gc.enable()

    plain = growth()
    with torch.profiler.profile(activities=CPU_ONLY):
        recorded = growth()
    assert profiling.summary()["graph"]["count"] == 103
    assert recorded <= plain + 5, (recorded, plain)


class _Event:
    """A stand-in timing event: the device has passed it at once, and an
    interval between two of them reads 0.5 ms."""

    made = 0

    def __init__(self, enable_timing=True):
        _Event.made += 1

    def record(self, stream=None):
        pass

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.5


def test_device_spans_recycle_their_events(monkeypatch):
    """With stand-in events: six on one call in ``DEVICE_EVERY`` (the
    graph's start and five stages' ends), read when the next such call
    closes and recorded again, so the calls
    make no new events and leave (almost) nothing for the garbage collector
    (a leak of the graph's span would leave ten objects a call); the
    graph's interval is the sum of its stages'."""
    import gc

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: object())
    _Event.made = 0
    stages = STAGES["tiny"]

    def call():
        with profiling.span("graph", device=True):
            for name in stages:
                with profiling.span(name, device=True):
                    with profiling.span("launch"):
                        pass

    with torch.profiler.profile(activities=CPU_ONLY):
        for _ in range(5):
            call()
        made = _Event.made
        gc.collect()
        gc.disable()
        try:
            c0 = gc.get_count()[0]
            for _ in range(200):
                call()
            grown = gc.get_count()[0] - c0
        finally:
            gc.enable()
    assert made <= 12 and _Event.made == made and grown <= 20, (made, _Event.made, grown)
    rec = profiling.records()
    graphs = [r for r in rec if r.name == "graph"]
    every = profiling.DEVICE_EVERY
    timed = {g.call for i, g in enumerate(graphs) if i % every == 0}
    assert len(graphs) == 205 and len(timed) == -(-205 // every)
    for g in graphs:
        assert (g.events, g.device_ms) == ((6, 2.5) if g.call in timed else (0, None))
    assert all(r.device_ms == (0.5 if r.call in timed else None)
               for r in rec if r.name in stages)
    s = profiling.summary()
    assert s["graph"]["device_ms_p50"] == 2.5 and s["graph.fft"]["device_ms_p50"] == 0.5
    assert "device_ms_p50" not in s["launch"]


def test_device_trace_on_the_cpu_places_the_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # the host's trace
    spec = _spec("tiny")
    process = build_process_batch(spec, device="cpu", packed=True)
    x = _blocks(spec, 2)
    with profiling.device_trace(str(tmp_path)):
        process(x)
    trace = json.loads((tmp_path / "trace.json").read_text())
    mine = [e for e in trace["traceEvents"] if e.get("cat") == "program_span"]
    assert sorted(e["name"] for e in mine) == sorted(STAGES["tiny"] + ["graph"])
    # on the trace's clock: the FFT stage's span holds the profiler's own
    # record of the FFT (to 10 us; a wrong clock would be off by far more)
    (stage,) = [e for e in mine if e["name"] == "graph.fft"]
    (fft,) = [e for e in trace["traceEvents"] if e.get("ph") == "X"
              and e.get("cat") == "cpu_op" and e.get("name") == "aten::fft_fft"]
    assert stage["ts"] - 10 <= fft["ts"] and fft["ts"] + fft["dur"] <= stage["ts"] + \
        stage["dur"] + 10, (stage, fft)
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans["spans"]["graph"]["count"] == 1 and spans["kernels"] == 0
    assert spans["kernel_ms"] == 0.0 and spans["idle_gaps"]
    assert sum(ms for _, ms in spans["idle_gaps"]) == pytest.approx(spans["window_ms"], rel=1e-6)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_with_nothing_recorded(name):
    from portbench.harness import cells

    assert cells.reader(name)(types.SimpleNamespace()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_for_a_program_without_summary(name, monkeypatch):
    from portbench.harness import cells

    with torch.profiler.profile(activities=CPU_ONLY):
        with profiling.span("graph"):
            with profiling.span("launch"):
                pass
        with profiling.span("download.wait"):
            pass
    stub = types.ModuleType("pycusdr_tpu_torch.obs.profiling")
    monkeypatch.setitem(sys.modules, "pycusdr_tpu_torch.obs.profiling", stub)
    monkeypatch.setattr(sys.modules["pycusdr_tpu_torch.obs"], "profiling", stub)
    assert cells.reader(name)(types.SimpleNamespace()) is None


def test_readers_read_the_summary():
    from portbench.harness import cells

    with torch.profiler.profile(activities=CPU_ONLY):
        with profiling.span("graph"):
            with profiling.span("launch"):
                time.sleep(0.001)
        with profiling.span("download.wait"):
            pass
    s = profiling.summary()
    r = types.SimpleNamespace()
    assert cells.reader("graph_host_ms_p50")(r) == s["graph"]["host_ms_p50"]
    assert cells.reader("launch_host_ms_per_call")(r) == s["graph"]["launch_ms_per_call_p50"]
    assert cells.reader("download_wait_ms_p50")(r) == s["download.wait"]["host_ms_p50"]
    assert cells.reader("graph_stream_ms_p50")(r) is None  # no device events on the CPU


# ---------------------------------------------------------------- on the card


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graph's device events and kernels run there")
    return torch.device("cuda")


def _c64(cuda):
    """The flagship graph (the benchmark's uhf_gfsk) at 64 blocks a call."""
    spec = configs.flagship_spec()
    return spec, build_process_batch(spec, packed=True), _blocks(spec, 64).to(cuda)


@pytest.mark.cuda
def test_graph_device_events_match_the_kernels_of_a_trace(cuda):
    spec, process, x = _c64(cuda)
    for _ in range(3):
        process(x)
    torch.cuda.synchronize()
    profiling.reset()
    calls = 80
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            process(x)
        torch.cuda.synchronize()
    rec = profiling.records()
    every = profiling.DEVICE_EVERY
    graphs = [s for s in rec if s.name == "graph"][::every]  # the calls timed on the device
    assert len(graphs) == -(-calls // every) and all(g.events == 6 for g in graphs)
    timed = {g.call for g in graphs}
    stages = [s for s in rec if s.name.startswith("graph.") and s.call in timed]
    assert {s.name for s in stages} == set(STAGES["tiny"]) and len(stages) == 5 * len(timed)
    assert all(s.device_ms is not None and s.device_ms >= 0 for s in stages + graphs)
    assert all(s.device_ms is None for s in rec if s.call not in timed)
    for g in graphs:
        mine = sum(s.device_ms for s in stages if s.call == g.call)
        assert mine == pytest.approx(g.device_ms, rel=1e-3, abs=2e-3)
    kernel_us = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_time_total and not e.key.startswith("Mem"))
    per_call = kernel_us / 1e3 / calls
    median = profiling.summary()["graph"]["device_ms_p50"]
    assert median == pytest.approx(per_call, rel=0.10), (median, per_call)
    s = profiling.summary()
    assert s["launch"]["count"] == 5 * calls
    assert 0 < s["graph"]["launch_ms_per_call_p50"] < s["graph"]["host_ms_p50"]


@pytest.mark.cuda
def test_device_trace_gives_the_kernels_to_program_spans(cuda, tmp_path):
    from pycusdr_tpu_torch.models.demodulator import finish_download, start_download

    spec, process, x = _c64(cuda)
    for _ in range(3):
        finish_download(start_download(process(x)))
    torch.cuda.synchronize()
    with profiling.device_trace(str(tmp_path)):
        for _ in range(20):
            finish_download(start_download(process(x)))
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans["kernels"] > 0 and spans["kernel_ms"] > 0
    assert spans["kernel_ms_in_spans"] >= 0.95 * spans["kernel_ms"], spans
    per = spans["spans"]
    assert per["graph"]["count"] == 20 and per["download.wait"]["count"] == 20
    assert per["graph"]["kernel_ms_incl"] >= 0.95 * spans["kernel_ms"]
    assert per["launch"]["kernel_ms"] > 0 and per["graph.doppler"]["kernel_ms_incl"] > 0
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert sum(e.get("cat") == "program_span" for e in trace["traceEvents"]) == len(
        [1 for p in per.values() for _ in range(p["count"])])
