"""The port's multi-device forms across real processes on the CPU: each
rank one process of a gloo ``torch.distributed`` world on localhost, as
``tests/test_multihost.py`` runs JAX's across two processes.

- the collectives on the subgroups of a 2 x 2 mesh (all-gather tiled and
  stacked, the sum, the ``ppermute`` ring), and their identity on an axis
  of one;
- the generic step on ``{"channel": 2, "dopp": 2}`` in four processes
  against JAX's ``{"channel": 4, "dopp": 2}`` step on the same four
  channels (the golden table; the voted pair equal on every rank and to
  JAX's);
- the ``time`` stream in two processes against JAX's on
  ``make_mesh({"time": 8})``, ``carry_out`` equal on both ranks;
- ``init_distributed``, ``make_global_mesh`` and ``local_channel_slice``
  in one process.

The workers import only the port. Their ports lie in 16500-16999, below
the kernel's ephemeral range (Linux's default, 32768-60999) and apart
from the ports of ``tests/test_torch_runtime.py`` (16000-16499) and the
JAX package's tests (20003-37560); every wait is bounded at 60 s, and
each test ends its processes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pycusdr_tpu.ops.cfft import c2ri
from pycusdr_tpu.parallel import build_sharded_demod_step as jax_step
from pycusdr_tpu.parallel import build_time_sharded_stream as jax_stream
from pycusdr_tpu.parallel import make_mesh as jax_make_mesh
from pycusdr_tpu_torch.parallel import (
    all_gather,
    all_reduce,
    init_distributed,
    local_channel_slice,
    make_global_mesh,
    make_mesh,
    ppermute,
)

from conftest import make_fsk_signal
from test_torch_generic import _assert_golden
from test_torch_parallel import _blocks, _specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 60

HEAD = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, port, n, out = int(sys.argv[1]), sys.argv[2], int(sys.argv[3]), sys.argv[4]
from pycusdr_tpu_torch.parallel import init_distributed, make_mesh
assert init_distributed("127.0.0.1:" + port, n, rank, backend="gloo", timeout_s=60)
'''
TAIL = r'''
dist.destroy_process_group()
print("WORKER_OK", rank, flush=True)
'''

COLLECTIVES = r'''
from pycusdr_tpu_torch.parallel import all_gather, all_reduce, ppermute
mesh = make_mesh({"a": 2, "b": 2}, devices=["cpu"] * 4)
assert mesh.coords == {"a": rank // 2, "b": rank % 2}, mesh.coords
x = torch.full((2, 3), float(rank)) + torch.arange(3.0)
np.savez(out + "/coll_%d.npz" % rank,
         ga=all_gather(x, mesh, "a").numpy(), gb=all_gather(x, mesh, "b", dim=1).numpy(),
         sb=all_gather(x, mesh, "b", tiled=False).numpy(), ra=all_reduce(x, mesh, "a").numpy(),
         pb=ppermute(x, mesh, "b", [(0, 1), (1, 0)]).numpy(),
         p1=ppermute(x, mesh, "a", [(0, 1)]).numpy())
'''

STEP = r'''
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.parallel import build_sharded_demod_step, local_channel_slice
mesh = make_mesh({"channel": 2, "dopp": 2}, devices=["cpu"] * 4)
blocks = np.load(out + "/blocks.npy")
res = build_sharded_demod_step(configs.tiny_spec(), mesh)(
    blocks[local_channel_slice(mesh, len(blocks))])
np.savez(out + "/step_%d.npz" % rank, **{k: v.numpy() for k, v in res.items()})
'''

STREAM = r'''
from pycusdr_tpu_torch import configs
from pycusdr_tpu_torch.parallel import build_time_sharded_stream
mesh = make_mesh({"time": 2}, devices=["cpu"] * 2)
z = np.load(out + "/stream_in.npz")
Tl = len(z["new"]) // 2
res, carry = build_time_sharded_stream(configs.tiny_spec(), mesh)(
    z["new"][rank * Tl:(rank + 1) * Tl], z["carry"])
np.savez(out + "/stream_%d.npz" % rank, carry=carry.numpy(),
         **{k: v.numpy() for k, v in res.items()})
'''


def _run(tmp_path, body, n, port):
    """Run ``body`` in n gloo ranks on localhost; every wait bounded, every
    process ended."""
    script = tmp_path / "worker.py"
    script.write_text(HEAD + body + TAIL)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(n),
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=WAIT_S)
    for r, text in enumerate(outs):
        assert f"WORKER_OK {r}" in text, f"rank {r} failed:\n{text[-3000:]}"


def test_collectives_across_four_processes(tmp_path):
    _run(tmp_path, COLLECTIVES, 4, 16511)
    x = {r: np.full((2, 3), float(r), np.float32) + np.arange(3.0, dtype=np.float32)
         for r in range(4)}
    for r in range(4):
        z = np.load(tmp_path / f"coll_{r}.npz")
        a, b = divmod(r, 2)
        col = [x[i * 2 + b] for i in range(2)]  # the ranks of my "a" line
        row = [x[a * 2 + j] for j in range(2)]  # the ranks of my "b" line
        np.testing.assert_array_equal(z["ga"], np.concatenate(col, 0))
        np.testing.assert_array_equal(z["gb"], np.concatenate(row, 1))
        np.testing.assert_array_equal(z["sb"], np.stack(row))
        np.testing.assert_array_equal(z["ra"], col[0] + col[1])
        np.testing.assert_array_equal(z["pb"], row[1 - b])
        np.testing.assert_array_equal(z["p1"], col[0] if a == 1 else np.zeros_like(x[r]))


def test_collectives_on_an_axis_of_one():
    mesh = make_mesh({"channel": 1, "dopp": 1}, devices=["cpu"])
    x = torch.arange(6.0).reshape(2, 3)
    assert all_gather(x, mesh, "dopp") is x
    assert torch.equal(all_gather(x, mesh, "dopp", tiled=False), x[None])
    assert all_reduce(x, mesh, "dopp") is x
    assert ppermute(x, mesh, "dopp", [(0, 0)]) is x


def test_generic_step_across_four_processes_matches_jax(tmp_path):
    jspec, spec = _specs("bench_GFSK")
    blocks = _blocks(spec, "bench_GFSK", n_chan=4, seed=5)
    np.save(tmp_path / "blocks.npy", blocks)
    _run(tmp_path, STEP, 4, 16523)
    ref = {k: np.asarray(v) for k, v in
           jax_step(jspec, jax_make_mesh({"channel": 4, "dopp": 2}))(c2ri(blocks)).items()}
    for r in range(4):
        res = dict(np.load(tmp_path / f"step_{r}.npz"))
        rows = slice(2 * (r // 2), 2 * (r // 2) + 2)
        _assert_golden(res, {k: v[rows] if v.ndim and len(v) == 4 else v
                             for k, v in ref.items()}, spec.windowWidth)
        np.testing.assert_array_equal(res["bits_voted"], ref["bits_voted"])
        np.testing.assert_array_equal(res["trust_voted"], ref["trust_voted"])


def test_time_stream_across_two_processes_matches_jax(tmp_path):
    jspec, spec = _specs("bench_GFSK")
    T, N, ov = 8, spec.Nfft, spec.sigOverlap
    hop = N - ov
    rng = np.random.RandomState(17)
    bits = rng.randint(0, 2, (ov + hop * T) // int(spec.spsym) + 8)
    sig = make_fsk_signal(bits, int(spec.spsym), spec.centreFreqOffset / spec.sampleRate,
                          seed=19, noise_std=0.05)
    carry, new = sig[:ov], sig[ov:ov + hop * T].reshape(T, hop)
    np.savez(tmp_path / "stream_in.npz", new=new, carry=carry)
    _run(tmp_path, STREAM, 2, 16537)
    jres, jcarry = jax_stream(jspec, jax_make_mesh({"time": 8}))(c2ri(new), c2ri(carry))
    for r in range(2):
        z = dict(np.load(tmp_path / f"stream_{r}.npz"))
        np.testing.assert_array_equal(c2ri(z.pop("carry")), np.asarray(jcarry))
        own = slice(4 * r, 4 * r + 4)
        for k in ("bits", "trust", "symbols", "nSym", "nBits", "shift", "clipped_any"):
            np.testing.assert_array_equal(z[k], np.asarray(jres[k])[own], err_msg=f"{k} rank {r}")
        assert np.abs(z["doppler_hz"] - np.asarray(jres["doppler_hz"])[own]).max() < 1.0


def test_single_process_world(monkeypatch):
    """No world: ``init_distributed`` is a no-op, the global mesh is one
    device, and this process feeds every channel."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_distributed() is False
    assert init_distributed("127.0.0.1:16599", 1, 0) is False
    mesh = make_global_mesh(dopp=1, devices=["cpu"])
    assert mesh.shape == {"channel": 1, "dopp": 1} and mesh.device == torch.device("cpu")
    assert local_channel_slice(mesh, 8) == slice(0, 8)
    with pytest.raises(ValueError, match="dopp=2"):
        make_global_mesh(dopp=2, devices=["cpu"])
