"""The PyTorch port's spec: the JAX package's DemodSpec carried across
with ``convert.spec_from_numpy`` equals the one the port builds itself
(masks_f bit for bit), so both packages compute from identical
constants."""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import DeviceConsts, spec_from_numpy
from pycusdr_tpu_torch.dsp.spec import build_spec
from pycusdr_tpu_torch.protocol import loadProtocol

torch.set_num_threads(2)


def spec_fields(spec) -> dict:
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def assert_same_spec(a, b):
    fa, fb = spec_fields(a), spec_fields(b)
    assert set(fa) == set(fb)
    for name, va in fa.items():
        vb = fb[name]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, name
            assert np.array_equal(va, vb), name
        else:
            assert va == vb, name


@pytest.mark.parametrize("proto", ["bench_FSK", "bench_GFSK"])
def test_carried_spec_equals_own_build(bench_conf, proto):
    jspec = jax_build_spec(bench_conf, jax_loadProtocol(proto)(conf=bench_conf), "UHF-H")
    own = build_spec(bench_conf, loadProtocol(proto)(conf=bench_conf), "UHF-H")
    assert_same_spec(spec_from_numpy(spec_fields(jspec)), own)
    assert own.masks_f.tobytes() == jspec.masks_f.tobytes()


@pytest.mark.parametrize("which", ["tiny", "flagship"])
def test_configs_match_graft_entry(which):
    jspec = getattr(graft, f"{which}_spec")()
    own = getattr(configs, f"{which}_spec")()
    assert_same_spec(spec_from_numpy(spec_fields(jspec)), own)


def test_spec_from_numpy_rejects_unknown_fields():
    fields = spec_fields(configs.tiny_spec())
    with pytest.raises(ValueError):
        spec_from_numpy({**fields, "not_a_field": 1})
    fields.pop("masks_f")
    with pytest.raises(ValueError):
        spec_from_numpy(fields)


def test_device_consts():
    spec = configs.tiny_spec()
    c = DeviceConsts.from_spec(spec, "cpu")
    N = spec.Nfft
    assert np.array_equal(c.masks_f.numpy(), spec.masks_f)
    np.testing.assert_array_equal(
        c.Q.numpy(), (np.abs(spec.masks_f.astype(np.complex128)) ** 2).astype(np.float32))
    sh = c.shifts_signed.numpy()
    assert np.all((sh >= -N // 2) & (sh < N // 2))
    assert np.array_equal(np.mod(sh, N), spec.dopp_shifts)
    tw = c.tw.numpy()
    j = np.arange(N)
    np.testing.assert_allclose(tw[:, 0] + 1j * tw[:, 1], np.exp(2j * np.pi * j / N), atol=1e-7)
    assert c.n1 * (N // c.n1) == N and c.n1 <= 512 and N // c.n1 <= 512
    assert c.trust_normal == 2


@pytest.mark.parametrize("name", ["nope", "Bench_QPSK", ""])
def test_unknown_protocol_raises_value_error_as_jax(name):
    with pytest.raises(ValueError) as jerr:
        jax_loadProtocol(name)
    with pytest.raises(ValueError) as err:
        loadProtocol(name)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("name", ["CC11xx", "ax25", "bench_GMSK", "bench"])
def test_protocols_jax_knows_but_the_port_lacks(name):
    """The names the port once lacked now resolve, to classes named as
    JAX's."""
    assert loadProtocol(name).__name__ == jax_loadProtocol(name).__name__
