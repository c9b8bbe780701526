"""The port's real-time streaming harness (``pycusdr_tpu_torch/bench/streaming_rt.py``)
end to end on the CPU (``device="cpu"``): the spawned CC11xx station, the
port's software front end pacing CC11xx bursts at 0.95 Msps, and the
packet accounting (``tests/test_streaming_rt.py`` is the model). Its
station config equals JAX's harness's, and its RSS sampler reads the
orchestrator cap's figure. Ports 19530-19533 and 19630-19634; every wait is
bounded."""

import os

from pycusdr_tpu.bench import streaming_rt as jax_streaming_rt
from pycusdr_tpu_torch.bench import streaming_rt
from pycusdr_tpu_torch.runtime import orchestrator


def test_build_conf_equals_jax():
    for args in ((19530, 2), (19530, 3, 4, 900)):
        assert streaming_rt._build_conf(*args) == jax_streaming_rt._build_conf(*args)


def test_rss_sampler_reads_the_caps_figure(monkeypatch):
    reads = []
    monkeypatch.setattr(orchestrator, "rss_mb", lambda pid: reads.append(pid) or 42.0)
    s = streaming_rt._RssSampler({"me": os.getpid()}, period=0.05)
    s.start()
    s._halt.wait(0.3)
    s.stop()
    s.join(5)
    assert reads and set(reads) == {os.getpid()}
    assert s.samples and all(row == {"me": 42.0} for _, row in s.samples)
    assert "RssAnon" in streaming_rt.RSS_FIGURE


def test_streaming_rt_cpu_point():
    # max_batch=4 keeps the CPU child's batches small (the shipped config's
    # 16 is sized for the card)
    row = streaming_rt.run_point(1.0, 12.0, basePort=19530, pipelineDepth=2, drain_s=10.0,
                                 verbose=False, ready_timeout=90.0, max_batch=4, device="cpu")
    # 4 bursts scheduled (t=1,4,7,10); allow one boundary/seam miss
    assert row["packets_scheduled"] == 4
    assert row["packets_bit_exact"] >= 3, row
    # every decoded payload matched its seeded expectation
    assert row["packets_decoded"] == row["packets_bit_exact"], row
    assert row["packets_duplicate"] == 0, row
    assert row["devices"] == ["cpu"] and row["blocks"] > 0, row
