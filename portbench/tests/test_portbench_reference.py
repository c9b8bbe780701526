"""The reference against the program's numpy golden and its plain path.

The reference (``portbench/reference``) is a frozen, torch and batched
transliteration of the golden; at the CPU tests' size it must take every
decision the golden and the program's plain block graph take, and match
their values to float32's rounding. Its constants, worked out again from
the configuration, must be the program's. The TF32 control must read far
off.
"""

import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench.harness import compare
from portbench.reference import demod as rdemod
from portbench.reference import spec as rspec


def _conf(root, name):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (c,) = [c for c in bench["configs"] if c["name"] == name]
    return json.loads((root / c["file"]).read_text())


def _program_spec(conf):
    from portbench.harness.entries import program_spec

    return program_spec(conf)


@pytest.mark.parametrize("name", ["uhf_gfsk", "stx"])
@pytest.mark.parametrize("size", ["cell", "tiny"])
def test_spec_equals_the_programs(name, size, tiny_root):
    conf = _conf(ROOT if size == "cell" else tiny_root, name)
    rs, ps = rspec.build(conf), _program_spec(conf)
    assert (rs.Nfft, rs.sigOverlap, rs.numSymMax, rs.code_idx_lo, rs.code_idx_hi, rs.spsymMin,
            rs.windowWidth, rs.dopp_offset_idx, rs.D, rs.M) == \
        (ps.Nfft, ps.sigOverlap, ps.numSymMax, ps.code_idx_lo, ps.code_idx_hi, ps.spsymMin,
         ps.windowWidth, ps.dopp_offset_idx, ps.D, ps.num_masks)
    assert np.array_equal(rs.dopp_shifts, ps.dopp_shifts)
    np.testing.assert_allclose(rs.dopp_hz_lut, ps.dopp_hz_lut, rtol=1e-12)
    np.testing.assert_allclose(rs.masks_f, ps.masks_f, atol=2e-6 * np.abs(rs.masks_f).max())
    assert np.array_equal(rs.bitLUT, np.asarray(ps.bitLUT))
    assert (rs.doppler_search, rs.clipping, rs.sum_all_masks, rs.peak_threshold_scale) == \
        (ps.doppler_search, not ps.disable_peak_thresholding, ps.sum_all_masks,
         ps.peak_threshold_scale)


def _blocks(conf, B=6, seed=5):
    from portbench.harness import traffic

    t = {"entry": "batch", "channels": B, "snr_db": [0.0, 12.0],
         "range_rate_mps": [-7500.0, 7500.0], "pool_bytes": 1,
         "bursts": None if rspec.build(conf).doppler_search else
         {"per_hop": 1, "length": 4, "amplitude": 100.0}}
    return traffic.make_pool(conf, t, seed, "cpu", n_batches=1).batches[0]


@pytest.mark.parametrize("name", ["uhf_gfsk", "stx"])
def test_reference_equals_the_golden(name, tiny_root):
    from pycusdr_tpu_torch.dsp.reference import demod_block_numpy

    conf = _conf(tiny_root, name)
    rs, ps = rspec.build(conf), _program_spec(conf)
    x = _blocks(conf)
    ref = rdemod.demod(x, rs)
    clipped = 0
    for b in range(x.shape[0]):
        g = demod_block_numpy(ps, x[b].numpy())
        n = len(g["symbols"])
        assert int(ref["nSym"][b]) == n
        for k in ("symbols", "centres", "bits", "trust"):
            assert np.array_equal(ref[k][b, :n].numpy(), np.asarray(g[k])[:n]), k
        assert int(ref["shift"][b]) == int(g["shift"])
        np.testing.assert_allclose(ref["mags"][b, :n].numpy(), g["mags"],
                                   atol=1e-5 * g["mags"].max())
        for k in ("spSym", "codeOffset", "code_val", "dopp_idx", "doppler_hz", "snr_db"):
            np.testing.assert_allclose(float(ref[k][b]), float(g[k]), rtol=1e-5, atol=1e-4)
        if g["E"] is not None:
            np.testing.assert_allclose(ref["E"][b].numpy(), g["E"], atol=1e-5 * g["E"].max())
        clipped += len(g["clipped_idx"]) > 0
        assert bool(ref["clipped_any"][b]) == (len(g["clipped_idx"]) > 0)
    assert clipped or rs.doppler_search  # the STX blocks clip


@pytest.mark.parametrize("name", ["uhf_gfsk", "stx"])
def test_reference_equals_the_plain_path(name, tiny_root):
    """The program's plain block graph on the CPU (f32) reads within float32
    rounding of the reference and takes its decisions."""
    from pycusdr_tpu_torch.dsp.block import build_process_batch

    from portbench.harness import layout

    conf = _conf(tiny_root, name)
    rs, ps = rspec.build(conf), _program_spec(conf)
    x = _blocks(conf)
    rows = build_process_batch(ps, device="cpu", packed=True, plain=True)(x).numpy()
    t = compare.Tally()
    prog = layout.unpack(rows, rs.numSymMax, rs.D, rs.M)
    if not rs.doppler_search:
        prog.pop("E")
    compare.add_blocks(t, prog, rdemod.demod(x, rs), rs.Nfft,
                       float(np.diff(rs.dopp_hz_lut[:2])[0]) if rs.D > 1 else 1.0,
                       rs.doppler_search)
    n = t.numbers()
    assert n["decisions"] == 0.0 and n["analog"] < 1e-5, (n, t.gaps)


def test_control_reads_far_off(tiny_root):
    conf = _conf(tiny_root, "uhf_gfsk")
    rs = rspec.build(conf)
    x = _blocks(conf)
    ref, ctl = rdemod.demod(x, rs), rdemod.demod(x, rs, "tf32")
    t = compare.Tally()
    compare.add_blocks(t, {k: v.numpy() for k, v in ctl.items()}, ref, rs.Nfft,
                       float(np.diff(rs.dopp_hz_lut[:2])[0]), True)
    assert t.numbers()["analog"] > 1e-4


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12, 3.0e-3])
    y = rdemod._tf32(x)
    assert y.tolist()[:3] == [1.0, 1.0, 1.0 + 4 * 2 ** -11]  # ties to even
    assert y[3].item() == -1.0
    assert abs(y[4].item() - 3.0e-3) <= 3.0e-3 * 2 ** -11
    z = rdemod._tf32(torch.complex(x, -x))
    assert torch.equal(z.real, y) and torch.equal(z.imag, -y)


def test_channelizer_equals_the_programs():
    from pycusdr_tpu_torch.parallel.channelizer import channelize_numpy

    g = torch.Generator().manual_seed(3)
    x = torch.complex(torch.randn(8 * 64, generator=g), torch.randn(8 * 64, generator=g))
    y, carry = rdemod.channelize(x, 8, 4, 9.0)
    np.testing.assert_allclose(y.numpy(), channelize_numpy(x.numpy(), 8, 4, 9.0), atol=1e-12)
    assert torch.equal(carry, x.to(torch.complex128).reshape(-1, 8)[-3:])
    y2, _ = rdemod.channelize(x[256:], 8, 4, 9.0, state=rdemod.channelize(x[:256], 8, 4, 9.0)[1])
    np.testing.assert_allclose(y2.numpy(), y[:, 32:].numpy(), atol=1e-12)


def test_a_tie_is_held_to_either_side(tiny_root, monkeypatch):
    """A block whose program took the other side of a tie (here the Doppler
    bin the reference ranks third as its second) matches the reference's
    alternative for that block, and differs from its first answer."""
    conf = _conf(tiny_root, "uhf_gfsk")
    rs = rspec.build(conf)
    x = _blocks(conf)
    ref = rdemod.demod(x, rs)
    B = x.shape[0]
    third = torch.argsort(ref["E"].sum(-1), dim=1, descending=True)[:, 2]
    other = rdemod.demod(x, rs, force_i1=third)
    prog = {k: v.numpy() for k, v in other.items()}
    hz = float(np.diff(rs.dopp_hz_lut[:2])[0])
    plain, held = compare.Tally(), compare.Tally()
    compare.add_blocks(plain, prog, ref, rs.Nfft, hz, True)
    alts = {b: {k: v[b:b + 1] for k, v in other.items()} for b in range(B)}
    compare.add_blocks(held, prog, ref, rs.Nfft, hz, True, alts)
    assert plain.differ > 0 and held.differ == 0 and held.numbers()["analog"] == 0.0
    monkeypatch.setattr(rdemod, "DOPP_TIE", 1.0)  # every block on a tie
    assert sorted(rdemod.alternatives(x, rs, rdemod.demod(x, rs))) == list(range(B))
