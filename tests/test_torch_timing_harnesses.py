"""The port's timing harnesses (``pycusdr_tpu_torch/bench/``: profile_stages,
subsystems, capture_probe, scaling, hw_leak_probe) on the CPU at tiny sizes,
against JAX's where JAX computes the same figure:

- ``subsystems.channelizer_bench`` at (M=8, K=4, 1024 samples): JAX's
  ``tone_purity`` within 1e-4;
- ``subsystems.tracking_bench`` at ``tiny_spec`` over 20 blocks, a track grid
  of 8 bins over 16: JAX's first lock, lock fraction, grid sizes and swing,
  the median error within 1 Hz;
- ``profile_stages``: the stages run in order give the packed graph's rows
  bit for bit; ``run_profile`` returns every stage row in both modes; the
  stage split of a trace; ``bounds`` gives PERF.md's bound column (the work
  model moved out of ``chip_smoke.py``);
- ``capture_probe``, ``scaling`` (a gloo world of two processes, ports
  19900-19949, below the kernel's ephemeral range) and ``hw_leak_probe`` run
  on the CPU and report JAX's keys and probe names with finite figures."""

import json
import math

import pytest
import torch

import __graft_entry__ as g
from pycusdr_tpu.bench.subsystems import channelizer_bench as jax_channelizer_bench
from pycusdr_tpu.bench.subsystems import tracking_bench as jax_tracking_bench
from pycusdr_tpu_torch.bench import capture_probe, hw_leak_probe, scaling, subsystems
from pycusdr_tpu_torch.bench import profile_stages as ps
from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.configs import RADIO, flagship_spec, stx_spec, tiny_spec
from pycusdr_tpu_torch.dsp.block import build_process_batch
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.protocol import loadProtocol

torch.set_num_threads(2)

#: the rendezvous of scaling's world of two (SCALING_PORT + 1)
SCALING_PORT = 19900
#: the keys of a row of JAX's ``run_scaling`` (``pycusdr_tpu/bench/scaling.py:149-152``)
JAX_SCALING_KEYS = {"devices", "Msamples_per_s", "efficiency", "vote_overhead_pct"}


def test_channelizer_purity_matches_jax():
    ours = subsystems.channelizer_bench(M=8, taps_per_branch=4, n_samples=1024, batches=(1, 2),
                                        T=2, device="cpu")
    jax = jax_channelizer_bench(M=8, taps_per_branch=4, n_samples=1024, batches=(1,), T=3)
    assert abs(ours["tone_purity"] - jax["tone_purity"]) <= 1e-4
    assert ours["card"] is None and ours["device"] == "cpu"
    for row in ours["throughput"].values():
        assert row["wideband_msps"] > 0 and row["device_us_per_call"] is None


def test_tracking_matches_jax():
    """The pass, its lock and its error equal JAX's (JAX rounds its figures:
    the lock fraction to 3 places, the swing to 1); the graphs timed."""
    ours = subsystems.tracking_bench(tiny_spec(), n_blocks=20, track_bins=8, track_span_bins=16,
                                     T=2, device="cpu")
    jax = jax_tracking_bench(g.tiny_spec(), n_blocks=20, track_bins=8, track_span_bins=16,
                             time_graphs=False)
    for k in ("first_lock_block", "acquire_bins", "track_bins"):
        assert ours[k] == jax[k], k
    assert round(ours["lock_fraction_after_first"], 3) == jax["lock_fraction_after_first"]
    assert round(ours["doppler_swing_hz"], 1) == jax["doppler_swing_hz"]
    bin_hz = tiny_spec().sampleRate / tiny_spec().Nfft
    assert abs(ours["median_err_bins"] - jax["median_err_bins"]) <= 1.0 / bin_hz + 5e-4
    assert math.isfinite(ours["track_speedup"]) and ours["acquire_us_per_block"] > 0


def _bpsk_spec():
    conf = load_modular_json("pycusdr_tpu_torch/config/configs/benchmark/bench_BPSK.json")
    conf["GPU"][conf["Radios"]["Rx"][RADIO]["CUDA_settings"]]["blockSize"] = 12
    return build_spec(conf, loadProtocol("bench_BPSK")(conf=conf), RADIO)


@pytest.mark.parametrize("name", ["tiny", "stx", "bpsk"])
def test_stages_in_order_give_the_graph_row(name):
    """``graph_stages`` run in order write the packed rows of the graph's
    kernel path, bit for bit: the flagship's stages at the tiny size, STX's
    (the clip, the fixed tail) and the NRZ-S form of bench_BPSK's."""
    spec = {"tiny": tiny_spec, "stx": stx_spec, "bpsk": _bpsk_spec}[name]()
    x = ps.graph_input(spec, 3)
    stages, v = ps.graph_stages(spec, x)
    assert list(stages) == ps.graph_stage_names(spec)
    for fn in stages.values():
        fn()
    want = build_process_batch(spec, device="cpu", packed=True)(x)
    assert torch.equal(v["row"], want)
    stages["mask_bank"]()  # a stage again: the same intermediates, the same outputs
    stages["centres"]()
    assert torch.equal(v["row"], want)


STAGE_ROWS = {"stages": ["fft_fwd", "dopp_energy", "dopp_est", "mask_bank", "timing", "centres",
                         "full"],
              "prefix": ["pre_fft", "pre_dopp", "pre_est", "pre_bank", "pre_timing",
                         "pre_centres", "full"]}


@pytest.mark.parametrize("mode", ["stages", "prefix"])
def test_run_profile_rows(mode):
    r = ps.run_profile((1, 2), 1, spec=tiny_spec(), mode=mode, device="cpu", roof_n=64,
                       roof_mb=1)
    assert r["device"] == "cpu" and r["card"] is None and r["mode"] == mode
    assert set(r["batches"]) == {"B1", "B2"}
    for rows in r["batches"].values():
        assert list(rows) == STAGE_ROWS[mode]
        for name, row in rows.items():
            assert row["device_us_per_block"] is None, name
            for k in ("us_per_block", "bound_us", "mbytes_min", "gflops_per_block"):
                assert math.isfinite(row[k]) and row[k] > 0, (name, k)
        assert rows["full"]["msps"] > 0
    if mode == "stages":  # the whole graph's work is its stages'
        rows = r["batches"]["B2"]
        for k in ("mbytes_min", "gflops_per_block"):
            assert rows["full"][k] == pytest.approx(sum(rows[s][k] for s in STAGE_ROWS[mode][:-1]))
    for k in ("launch_floor_ms", "dispatch_rtt_ms", "memory_roof_gbps"):
        assert r[k] > 0


def test_stage_split_follows_the_trace():
    """An event counts in the stage of the last stage function before it:
    the FFT's elementwise |S|^2 in fft_fwd, STX's tail fill after its
    transform too, and the clip before the transform in clip."""
    ev = [("void regular_fft_factor<64>", 1.0), ("elementwise_kernel<mul>", 2.0),
          ("doppler_energy_k<4, 2>", 4.0), ("doppler_estimate", 8.0), ("mf_pass1", 16.0),
          ("mf_pass2", 32.0), ("band_partial", 64.0), ("band_argmax", 128.0),
          ("symbol_detect<1, true, 4, false>", 256.0)]
    assert ps.stage_split(flagship_spec(), ev) == {
        "fft_fwd": 3.0, "dopp_energy": 4.0, "dopp_est": 8.0, "mask_bank": 48.0, "timing": 192.0,
        "centres": 256.0}
    ev = [("thr_cluster", 1.0), ("vector_fft_c2c", 2.0), ("copy_kernel", 4.0),
          ("mf_pass1", 8.0), ("band_partial", 16.0), ("symbol_detect", 32.0)]
    assert ps.stage_split(stx_spec(), ev) == {
        "clip": 1.0, "fft_fwd": 6.0, "mask_bank": 8.0, "timing": 16.0, "centres": 32.0}


#: PERF.md section 6's bound column (ms, by) at B = 1 / 16 / 64: the
#: flagship's K1-K5 (K5 at the SNR band bins of that run: 318, 5062 and 20254)
#: and STX's K6, K2, K3, K4
PERF_BOUNDS = {
    ("flagship", "doppler_energy"): [(0.000705, "bytes"), (0.006323, "operations"),
                                     (0.024352, "operations")],
    ("flagship", "mf_bank_colreduce"): [(0.001643, "bytes"), (0.011143, "operations"),
                                        (0.044572, "operations")],
    ("flagship", "timing_band"): [(7.826e-05, "bytes"), (0.001252, "bytes"), (0.005008, "bytes")],
    ("flagship", "symbol_detect"): [(6.328e-05, "bytes"), (0.001012, "bytes"),
                                    (0.004050, "bytes")],
    ("flagship", "doppler_estimate"): [(1.84e-06, "bytes"), (2.597e-05, "bytes"),
                                       (0.0001032, "bytes")],
    ("stx", "threshold_input"): [(0.0006309, "bytes"), (0.010095, "bytes"), (0.040378, "bytes")],
    ("stx", "mf_bank_colreduce"): [(0.003287, "bytes"), (0.023538, "operations"),
                                   (0.094153, "operations")],
    ("stx", "timing_band"): [(0.0001565, "bytes"), (0.002504, "bytes"), (0.010016, "bytes")],
    ("stx", "symbol_detect"): [(8.742e-05, "bytes"), (0.001399, "bytes"), (0.005595, "bytes")],
}
BAND_BINS = {1: 318, 16: 5062, 64: 20254}


@pytest.mark.parametrize("B", [1, 16, 64])
def test_bounds_match_perf(B):
    specs = {"flagship": flagship_spec(), "stx": stx_spec()}
    got = {p: ps.bounds(s, B, BAND_BINS[B] if s.doppler_search else 0) for p, s in specs.items()}
    assert set(got["flagship"]) == set(ps.GRAPH_KERNELS[True])
    assert set(got["stx"]) == set(ps.GRAPH_KERNELS[False])
    for (p, k), want in PERF_BOUNDS.items():
        ms, by = got[p][k]
        assert by == want[[1, 16, 64].index(B)][1], (p, k)
        assert ms == pytest.approx(want[[1, 16, 64].index(B)][0], rel=1e-3), (p, k)


def test_capture_probe_on_the_cpu():
    res = capture_probe.run_probe(K=4, T=1, spec=tiny_spec(), device="cpu", repeats=1)
    assert {"metric", "K", "capture_msps", "scan_msps"} <= set(res)
    assert res["metric"] == "whole_capture_reprocessing" and res["K"] == 4
    assert res["capture_msps"] > 0 and res["scan_msps"] > 0 and res["decisions_equal"]
    for route in ("capture", "scan"):
        assert capture_probe.capture_msps(route, K=2, T=1, repeats=1, spec=tiny_spec(),
                                          device="cpu") > 0


def test_scaling_worlds_on_the_cpu():
    """``run_scaling((1, 2))`` over a gloo world of two spawned processes at
    ``tiny_spec``: JAX's row keys, the second row marked as contention."""
    rows = scaling.run_scaling((1, 2), tiny_spec(), device="cpu", port=SCALING_PORT)
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert JAX_SCALING_KEYS <= set(r)
        assert all(math.isfinite(r[k]) for k in JAX_SCALING_KEYS)
        assert r["Msamples_per_s"] > 0 and r["card"] is None
    assert rows[0]["efficiency"] == 1.0 and "efficiency_measures" in rows[1]


@pytest.mark.parametrize("generic", [False, True])
def test_sharded_per_chip_msps_on_the_cpu(generic):
    msps = scaling.sharded_per_chip_msps(tiny_spec(), n_channels=4, T=2, repeats=2,
                                         force_generic=generic, device="cpu")
    assert math.isfinite(msps) and msps > 0


def test_hw_leak_probe_on_the_cpu(capsys):
    hw_leak_probe.main(["--cpu", "--iters", "5"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines[0] == {"device": "cpu", "card": None}
    assert [x["probe"] for x in lines[1:]] == ["np_input", "reused_device_input",
                                               "deleted_device_input", "tiny_jit", "kept_rows"]
    assert all(math.isfinite(x["kb_per_iter"]) for x in lines[1:])


@pytest.mark.parametrize("argv", [
    ["--cpu", "--spec", "tiny", "--batches", "1", "--T", "1", "--roof-n", "64", "--roof-mb", "1"],
    ["--cpu", "--spec", "tiny", "--batches", "1", "--T", "1", "--roof-n", "64", "--roof-mb", "1",
     "--mode", "prefix"],
])
def test_profile_stages_main_on_the_cpu(argv, capsys):
    ps.main(argv)
    res = json.loads(capsys.readouterr().out)
    assert res["device"] == "cpu" and list(res["batches"]) == ["B1"]
