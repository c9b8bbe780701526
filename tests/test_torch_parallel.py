"""The port's one-card forms of ``pycusdr_tpu/parallel`` on the CPU
against the JAX package on its 8-device CPU mesh: the channel-parallel
step at C=4 for bench_GFSK and bench_BPSK (``tests/test_parallel.py:
41-66,134-178``: bits, trust, symbols and the voted pair equal), K8's
plain version against ``vote_n_device`` at every ``master_idx`` (the
wrong-master case of ``:181-199`` included), the time-sharded stream
against JAX's on ``make_mesh({"time": 8})`` with ``carry_out`` equal, and
the layouts the port refuses (ranks the world does not have, a bank that
does not divide over ``dopp``, a hop shorter than the overlap). The
generic step is ``tests/test_torch_generic.py``, the forms across
processes ``tests/test_torch_multihost.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from pycusdr_tpu.dsp.signal_gen import modulate_bpsk
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.parallel import build_sharded_demod_step as jax_step
from pycusdr_tpu.parallel import build_time_sharded_stream as jax_stream
from pycusdr_tpu.parallel import make_mesh as jax_make_mesh
from pycusdr_tpu.parallel.vote import vote_n_device
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, SCALAR
from pycusdr_tpu_torch.parallel import (
    Mesh,
    build_sharded_demod_step,
    build_time_sharded_stream,
    choose_mesh,
    make_mesh,
)
from pycusdr_tpu_torch.parallel.vote import vote_n_device_plain, vote_rows, vote_rows_plain

from conftest import make_fsk_signal

torch.set_num_threads(2)


def _cpu_mesh(**axes):
    return make_mesh(axes, devices=["cpu"])


def _specs(protocol):
    if protocol == "bench_BPSK":  # NRZ-S LUTs for maskLen 4/5
        conf = configs._conf(blockSize=9, overlap=7, spsym=8, doppSteps=16, windowWidth=5,
                             maskSize=4)
        conf["Main"]["protocols"] = {"UHF": "bench_BPSK"}
    else:
        conf = configs.tiny_conf()
    jspec = jax_build_spec(conf, jax_loadProtocol(protocol)(conf=conf), configs.RADIO)
    return jspec, spec_from_numpy({f.name: getattr(jspec, f.name)
                                   for f in dataclasses.fields(jspec)})


def _blocks(spec, protocol, n_chan=4, seed=3):
    """C channels of one packet with independent noise (test_parallel's)."""
    rng = np.random.RandomState(seed)
    nbits = spec.Nfft // int(spec.spsym)
    bits = rng.randint(0, 2, nbits)
    offset = spec.centreFreqOffset / spec.sampleRate
    if protocol == "bench_GFSK":
        return np.stack([make_fsk_signal(bits, int(spec.spsym), offset, seed=seed + c,
                                         noise_std=0.1) for c in range(n_chan)])
    nb = modulate_bpsk(bits, int(spec.spsym))
    base = nb * np.exp(2j * np.pi * offset * np.arange(len(nb)))
    return np.stack([(base + 0.02 * (np.random.RandomState(20 + c).randn(len(base))
                                     + 1j * np.random.RandomState(40 + c).randn(len(base))))
                     [:spec.Nfft] for c in range(n_chan)]).astype(np.complex64)


@pytest.mark.parametrize("vote", [True, False])
@pytest.mark.parametrize("protocol", ["bench_GFSK", "bench_BPSK"])
def test_channel_parallel_step_matches_jax(protocol, vote):
    jspec, spec = _specs(protocol)
    blocks = _blocks(spec, protocol)
    ref = {k: np.asarray(v) for k, v in
           jax_step(jspec, jax_make_mesh({"channel": 4, "dopp": 1}), vote=vote)(
               c2ri(blocks)).items()}
    step = build_sharded_demod_step(spec, _cpu_mesh(channel=1, dopp=1), vote=vote)
    res = {k: v.numpy() for k, v in step(blocks).items()}
    assert set(res) == set(ref)
    for k in ("bits", "trust", "symbols", "nSym", "nBits", "shift"):
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
        assert res[k].dtype == ref[k].dtype, k
    assert np.abs(res["centres"] - ref["centres"]).max() <= spec.windowWidth
    for k, tol in (("spSym", 1e-3), ("doppler_hz", 1.0), ("freq_offset_hz", 1.0),
                   ("snr_db", 0.5)):
        assert np.abs(res[k] - ref[k]).max() <= tol, k
    if vote:
        np.testing.assert_array_equal(res["bits_voted"], ref["bits_voted"])
        np.testing.assert_array_equal(res["trust_voted"], ref["trust_voted"])
        n = int(res["nBits"][0])
        np.testing.assert_array_equal(res["bits_voted"][:n], res["bits"][0, :n])
    plain = build_sharded_demod_step(spec, _cpu_mesh(channel=1, dopp=1), vote=vote, plain=True)
    for k, v in plain(blocks).items():
        np.testing.assert_array_equal(v.numpy(), res[k], err_msg=f"plain {k}")


VOTE_CASES = {
    "random_C5": (np.random.RandomState(2).randint(0, 2, (5, 300)).astype(np.int8),
                  np.random.RandomState(3).choice([-2, -1, 0, 1, 2, 3, 5, 10], (5, 300))
                  .astype(np.int8)),
    # tests/test_parallel.py:181-199: two agreeing channels against a wrong master
    "wrong_master": (np.stack([np.zeros(8, np.int8), np.ones(8, np.int8), np.ones(8, np.int8)]),
                     np.full((3, 8), 2, np.int8)),
    # a master trust of 5 weighs 5 * 1.2f = 6.0: it ties two voters of 3
    "tie": (np.stack([np.ones(16, np.int8), np.zeros(16, np.int8), np.zeros(16, np.int8)]),
            np.stack([np.arange(16), np.full(16, 3), np.full(16, 3)]).astype(np.int8)),
}


@pytest.mark.parametrize("name", sorted(VOTE_CASES))
def test_vote_plain_matches_jax_at_every_master(name):
    bits, trust = VOTE_CASES[name]
    C = bits.shape[0]
    for master in range(-C, C):
        jv, jt = vote_n_device(bits, trust, master)
        v, t = vote_n_device_plain(torch.from_numpy(bits), torch.from_numpy(trust), master)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv), err_msg=f"master {master}")
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt), err_msg=f"master {master}")
    if name == "wrong_master":  # the majority wins wherever the master sits
        for master in range(C):
            v, t = vote_n_device_plain(torch.from_numpy(bits), torch.from_numpy(trust), master)
            np.testing.assert_array_equal(v.numpy(), np.ones(8, np.int8))
            np.testing.assert_allclose(t.numpy(), 2.3)


@pytest.mark.parametrize("master", [0, 1, 4, -1])
def test_vote_rows_master_idx(master):
    """K8's wrapper on CPU rows with another master: the pad mask, then the
    vote of JAX's ``vote_n_device`` with that master."""
    C, S = 5, 40
    rng = np.random.RandomState(11)
    bits = rng.randint(0, 2, (C, S)).astype(np.int8)
    trust = rng.choice(np.array([-1, 0, 1, 2, 3, 5], np.int8), (C, S))
    nbits = np.array([40, 33, 38, 40, 20])
    rows = torch.zeros((C, len(PACK_ARRAYS) * S + 12 + 2))
    rows[:, :S], rows[:, S:2 * S] = torch.from_numpy(bits).float(), torch.from_numpy(trust).float()
    rows[:, len(PACK_ARRAYS) * S + SCALAR["nBits"]] = torch.from_numpy(nbits).float()
    out = vote_rows(rows, S, 1.2, master_idx=master)
    masked = np.where(np.arange(S)[None] < nbits[:, None], trust, -1).astype(np.int8)
    jv, jt = vote_n_device(bits, masked, master)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jt))
    assert torch.equal(vote_rows_plain(rows.clone(), S, 1.2, torch.empty((2, S)), master), out)
    with pytest.raises(ValueError, match="master_idx"):
        vote_rows(rows, S, 1.2, master_idx=C)


def test_time_sharded_stream_matches_jax():
    """T=8 hops in one call against JAX's stream on the 8-device ``time``
    mesh: every block's bits, trust and decisions equal, carry_out equal."""
    jspec, spec = _specs("bench_GFSK")
    T, N, ov = 8, spec.Nfft, spec.sigOverlap
    hop = N - ov
    rng = np.random.RandomState(7)
    bits = rng.randint(0, 2, (ov + hop * T) // int(spec.spsym) + 8)
    sig = make_fsk_signal(bits, int(spec.spsym), spec.centreFreqOffset / spec.sampleRate,
                          seed=9, noise_std=0.05)
    carry, new = sig[:ov], sig[ov:ov + hop * T].reshape(T, hop)
    jres, jcarry = jax_stream(jspec, jax_make_mesh({"time": 8}))(
        c2ri(new), c2ri(carry))
    stream = build_time_sharded_stream(spec, _cpu_mesh(time=1))
    res, carry_out = stream(new, carry)
    np.testing.assert_array_equal(c2ri(carry_out.numpy()), np.asarray(jcarry))
    assert set(res) == {k for k in jres}
    for k in ("bits", "trust", "symbols", "nSym", "nBits", "shift", "clipped_any"):
        np.testing.assert_array_equal(res[k].numpy(), np.asarray(jres[k]), err_msg=k)
    assert np.abs(res["doppler_hz"].numpy() - np.asarray(jres["doppler_hz"])).max() < 1.0
    # the next call continues from carry_out: its first block is sig[T hop:]
    res2, _ = stream(np.zeros((1, hop), np.complex64), carry_out)
    head = build_time_sharded_stream(spec, _cpu_mesh(time=1))(
        np.zeros((1, hop), np.complex64), sig[T * hop:T * hop + ov])[0]
    assert torch.equal(res2["bits"], head["bits"])


@pytest.mark.parametrize("case", ["channel4", "dopp2", "time8", "choose4", "masks3", "hop"])
def test_multi_device_layouts_raise(case):
    """What the multi-device forms still refuse: a mesh whose ranks the
    world does not have (here: no world at all) is never run on one device
    in its place; a mask bank that does not divide over ``dopp``; a hop
    shorter than the overlap (JAX refuses it too)."""
    _, spec = _specs("bench_GFSK")
    axes = {"channel4": {"channel": 4, "dopp": 1}, "dopp2": {"channel": 1, "dopp": 2},
            "time8": {"time": 8}}
    if case in axes:
        with pytest.raises(ValueError, match="ranks"):
            make_mesh(axes[case], devices=["cpu"] * 8)
    elif case == "choose4":
        with pytest.raises(ValueError, match="ranks"):
            choose_mesh(4, devices=["cpu"] * 4)
        mesh = choose_mesh(1, devices=["cpu"])
        assert mesh.shape == {"channel": 1, "dopp": 1} and mesh.device == torch.device("cpu")
    elif case == "masks3":
        mesh = Mesh({"channel": 1, "dopp": 3}, (torch.device("cpu"),), {"channel": 0, "dopp": 0})
        with pytest.raises(ValueError, match="divide"):
            build_sharded_demod_step(spec, mesh)
    else:
        short = dataclasses.replace(spec, sigOverlap=spec.Nfft // 2 + 8)
        with pytest.raises(ValueError, match="hop"):
            build_time_sharded_stream(short, _cpu_mesh(time=1))
