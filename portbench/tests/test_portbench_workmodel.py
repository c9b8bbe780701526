"""The frozen work model against the program's (``bench/profile_stages.py``),
at the flagship and STX shapes, and the peaks its bounds divide by."""

import math

import pytest

from conftest import ROOT
from portbench.harness import cells, workmodel


def _spec(name):
    from portbench.harness.entries import program_spec

    return program_spec(cells.load(name).conf)


@pytest.mark.parametrize("cell,B", [("uhf_gfsk.c64", 1), ("uhf_gfsk.c64", 16),
                                    ("uhf_gfsk.c64", 64), ("stx.c64", 64)])
def test_stage_work_equals_the_programs(cell, B):
    from pycusdr_tpu_torch.bench.profile_stages import kernel_work

    spec = _spec(cell)
    kw = kernel_work(spec, B)
    N, D, M = spec.Nfft, spec.D, spec.num_masks
    assert workmodel.mask_bank(B, N, M) == kw["mf_bank_colreduce"]
    if spec.doppler_search:
        k1, k5 = kw["doppler_energy"], kw["doppler_estimate"]
        assert workmodel.doppler(B, N, D, M) == (k1[0] + k5[0], k1[1] + k5[1])
    else:
        assert workmodel.clip(B, N) == kw["threshold_input"]


def test_bounds_at_the_flagship():
    """K2 at B=64: 83.9 MB at 3.35 TB/s (25.0 us) beats 2.98 GFLOP at 495
    TFLOP/s (6.0 us); at the f32 rate of the program's model the operations
    bound it (44.6 us, PERF.md's kernel table)."""
    nbytes, ops = workmodel.mask_bank(64, 2 ** 16, 8)
    t, by = workmodel.bound(nbytes, ops)
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)
    assert ops / 67e12 * 1e3 == pytest.approx(0.044572, rel=1e-4)
    t, by = workmodel.bound(*workmodel.doppler(64, 2 ** 16, 64, 8))
    assert by == "bytes"


def test_channelizer_work():
    nbytes, ops = workmodel.channelize(64, 2 ** 16, 8)
    assert nbytes == 2 * 8 * 64 * 2 ** 16 + 4 * 8 * 64 + 16 * 7 * 64
    assert ops == 8 * 8 * 64 * 2 ** 16 + 5 * 64 * 2 ** 16 * math.log2(64)
    assert workmodel.bound(nbytes, ops)[1] == "bytes"


def test_root_is_the_checkout():
    assert (ROOT / "BENCHMARK.json").is_file() and cells.ROOT == ROOT
