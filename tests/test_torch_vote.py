"""The channel group's vote in the port against the JAX package:
``vote_n_device_plain`` (K8's plain version) against ``vote_n_device``,
K8's wrapper on CPU rows, and ``build_group_graph`` against the JAX
``ChannelGroup_process._group_graph`` (called with a namespace for
``self``) at a tiny spec with three channels."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from pycusdr_tpu.dsp.block import build_process_block as jax_build_process_block
from pycusdr_tpu.dsp.block import packed_len as jax_packed_len
from pycusdr_tpu.dsp.signal_gen import modulate_fsk
from pycusdr_tpu.dsp.spec import build_spec as jax_build_spec
from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.parallel.vote import vote_n_device
from pycusdr_tpu.protocol import loadProtocol as jax_loadProtocol
from pycusdr_tpu.runtime.channel_group_process import ChannelGroup_process
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.convert import spec_from_numpy
from pycusdr_tpu_torch.dsp.block import packed_len
from pycusdr_tpu_torch.ops.layout import PACK_ARRAYS, SCALAR
from pycusdr_tpu_torch.parallel.vote import vote_n_device_plain, vote_rows, vote_rows_plain
from pycusdr_tpu_torch.runtime.channel_group_process import build_group_graph

torch.set_num_threads(2)

TRUSTS = np.array([-2, -1, 0, 1, 2, 3, 5, 10, 127], np.int8)


def _cases():
    """name -> (bits, trust) int8 (C, S)."""
    rng = np.random.RandomState(4)
    out = {}
    for C in (1, 2, 3, 8):
        out[f"random_C{C}"] = (rng.randint(0, 2, (C, 600)).astype(np.int8),
                               rng.choice(TRUSTS, (C, 600)))
    # tests/test_parallel.py:181-199: two agreeing channels against a
    # wrong master win; all disqualified gives trust -1
    truth, master = np.ones(8, np.int8), np.zeros(8, np.int8)
    out["wrong_master"] = (np.stack([master, truth, truth]), np.full((3, 8), 2, np.int8))
    out["all_disqualified"] = (np.stack([master, truth, truth]), np.full((3, 8), -1, np.int8))
    # zero-trust voters count toward the quorum with weight 0
    out["zero_trust"] = (np.stack([master, truth, truth]),
                         np.stack([np.full(8, 3), np.zeros(8), np.zeros(8)]).astype(np.int8))
    # ties under master weight 1.2: 5 * 1.2f rounds to 6.0 exactly, against
    # 2 + 2 + 2 (C = 4) or one 6 (C = 2); and 3 * 1.2f = 3.6000001 against 3
    # + 0.6-free integers, at every master trust
    for C, others in ((2, [6]), (4, [2, 2, 2]), (3, [3, 1])):
        t = np.array([[5] + others] * 16, np.int8).T
        t[0] = np.arange(16)  # master trust 0..15, so 5 ties exactly
        b = np.zeros((C, 16), np.int8)
        b[0] = 1
        out[f"tie_C{C}"] = (b, t)
    return out


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_vote_plain_matches_jax(name):
    bits, trust = CASES[name]
    jv, jt = vote_n_device(bits, trust)
    v, t = vote_n_device_plain(torch.from_numpy(bits), torch.from_numpy(trust))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    if name == "wrong_master":
        np.testing.assert_array_equal(v.numpy(), np.ones(8, np.int8))
        np.testing.assert_allclose(t.numpy(), 2.3)
    if name == "all_disqualified":
        np.testing.assert_array_equal(t.numpy(), -1.0)
    if name == "tie_C2":
        assert int(v[5]) == 0 and int(v[6]) == 1  # 6.0 - 6 is no majority


@pytest.mark.parametrize("master_weight", [1.0, 1.2, 2.5])
def test_vote_rows_cpu_masks_pads_then_votes(master_weight):
    """K8's wrapper on CPU rows: the slots at or beyond each row's nBits
    get trust -1 in the rows, then the vote equals JAX's on the masked
    trust."""
    C, S = 5, 40
    rng = np.random.RandomState(9)
    bits = rng.randint(0, 2, (C, S)).astype(np.int8)
    trust = rng.choice(TRUSTS, (C, S))
    nbits = np.array([40, 35, 39, 12, 0])
    L = len(PACK_ARRAYS) * S + 12 + 3
    rows = torch.zeros((C, L))
    rows[:, :S], rows[:, S:2 * S] = torch.from_numpy(bits).float(), torch.from_numpy(trust).float()
    rows[:, len(PACK_ARRAYS) * S + SCALAR["nBits"]] = torch.from_numpy(nbits).float()
    out = vote_rows(rows, S, master_weight)
    masked = np.where(np.arange(S)[None] < nbits[:, None], trust, -1).astype(np.int8)
    np.testing.assert_array_equal(rows[:, S:2 * S].numpy(), masked)
    jv, jt = vote_n_device(bits, masked, master_weight=master_weight)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(jt))
    again = rows.clone()
    assert torch.equal(vote_rows_plain(again, S, master_weight, torch.empty((2, S))), out)
    assert torch.equal(again, rows)  # the mask is idempotent


@pytest.fixture(scope="module")
def group_case():
    conf = configs.tiny_conf()
    jspec = jax_build_spec(conf, jax_loadProtocol("bench_GFSK")(conf=conf), configs.RADIO)
    spec = spec_from_numpy({f.name: getattr(jspec, f.name) for f in dataclasses.fields(jspec)})
    N, sps = spec.Nfft, int(spec.spsym)
    rng = np.random.RandomState(21)
    bits = rng.randint(0, 2, N // sps + 4)
    f = spec.centreFreqOffset / spec.sampleRate
    base = modulate_fsk(bits, sps)[sps // 2:sps // 2 + N] * np.exp(2j * np.pi * f * np.arange(N))
    blocks = np.stack([base + 0.6 * (rng.randn(N) + 1j * rng.randn(N)) for _ in range(3)])
    return jspec, spec, blocks.astype(np.complex64)


@pytest.mark.parametrize("master_weight", [1.2, 1.0])
@pytest.mark.parametrize("plain", [False, True])
def test_group_graph_matches_jax(group_case, master_weight, plain):
    """The C = 3 group vector: the same length and layout as JAX's; bits,
    trust (pad slots -1), symbols, nSym and nBits of every row and the
    voted pair exact; the rest of the rows within the golden tolerances."""
    jspec, spec, blocks = group_case
    C, S = 3, spec.numSymMax
    ns = types.SimpleNamespace(masterVoteWeight=master_weight, _pack_spec=jspec)
    core = jax_build_process_block(jspec, jit=False)
    jvec = np.asarray(jax.jit(lambda b: ChannelGroup_process._group_graph(
        ns, b, core, vote_n_device))(jax.numpy.stack([c2ri(x) for x in blocks])))
    vec = build_group_graph(spec, C, master_weight, device="cpu", plain=plain)(blocks).numpy()
    L = packed_len(spec)
    assert L == jax_packed_len(jspec) and vec.shape == jvec.shape == (C * L + 2 * S,)
    np.testing.assert_array_equal(vec[C * L:], jvec[C * L:])
    tail = len(PACK_ARRAYS) * S
    for c in range(C):
        r, jr = vec[c * L:(c + 1) * L], jvec[c * L:(c + 1) * L]
        np.testing.assert_array_equal(r[:3 * S], jr[:3 * S])  # bits, trust, symbols
        for k in ("nSym", "nBits", "shift"):
            assert r[tail + SCALAR[k]] == jr[tail + SCALAR[k]], k
        nb = int(r[tail + SCALAR["nBits"]])
        assert (r[S + nb:2 * S] == -1).all()
        assert np.abs(r[3 * S:4 * S][:nb] - jr[3 * S:4 * S][:nb]).max() <= spec.windowWidth
        for k, tol in (("spSym", 1e-3), ("codeOffset", 0.05), ("dopp_idx", 0.01),
                       ("doppler_hz", 1.0), ("snr_db", 0.5)):
            assert abs(r[tail + SCALAR[k]] - jr[tail + SCALAR[k]]) <= tol, k
    nb0 = int(vec[tail + SCALAR["nBits"]])
    assert (vec[C * L + S:C * L + S + nb0] >= 1.0).mean() > 0.9, "the vote must be quorate"
