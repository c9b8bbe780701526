"""The port's native host runtime (``pycusdr_tpu_torch/native/``) on the CPU:
each binding against the JAX package's (``pycusdr_tpu/native/``, in
whichever form its library gave it) and against its own numpy form on
seeded inputs, exactly; the C++ ring against the numpy ``RingBuffer`` on
the cases of ``tests/test_native.py``; the frame finder's decisions the
same whichever form correlated, and equal to JAX's; the counters; and six
processes importing the module at once over an empty build directory,
each getting the library (one compile) and equal outputs."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pycusdr_tpu_torch import native
from pycusdr_tpu_torch.runtime.sigfifo import RingBuffer

REPO = Path(__file__).resolve().parent.parent
CC11XX_JSON = REPO / "pycusdr_tpu_torch" / "config" / "configs" / "CC11xx.json"
SEEDS = (0, 1)
BINDINGS = ("c2ri", "bit_correlate", "pn9_xor", "crc16")


@pytest.fixture(scope="module", autouse=True)
def require_native():
    assert native.AVAILABLE, "the port's native library failed to build (g++ is there)"


def _inputs(name, seed):
    rng = np.random.RandomState(seed)
    if name == "c2ri":
        n = 4097 + seed
        return ((rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64),)
    if name == "bit_correlate":
        return (rng.randint(0, 2, 5000 + seed).astype(np.int8),
                (rng.randint(0, 2, 64) * 2 - 1).astype(np.int8))
    if name == "pn9_xor":
        return (rng.randint(0, 256, 300 + seed).astype(np.uint8),)
    return (rng.randint(0, 256, 255 - seed).astype(np.uint8),)


def _call(mod, name, args):
    fn = {"c2ri": "c2ri_native"}.get(name, name)
    return getattr(mod, fn)(*args)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", BINDINGS)
def test_binding_matches_jax(name, seed):
    """The native form against the JAX package's binding (int32 scores
    from its native form, float64 from its numpy one: equal values)."""
    import pycusdr_tpu.native as jax_native

    args = _inputs(name, seed)
    before = native.call_counts()[name]["native"]
    got, want = _call(native, name, args), _call(jax_native, name, args)
    assert native.call_counts()[name]["native"] == before + 1
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if name == "bit_correlate":
        assert got.dtype == np.float64


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", BINDINGS)
def test_native_form_matches_numpy_form(name, seed, monkeypatch):
    args = _inputs(name, seed)
    got = _call(native, name, args)
    with monkeypatch.context() as m:
        m.setattr(native, "_lib", None)
        m.setattr(native, "_tried", True)
        before = native.call_counts()[name]["numpy"]
        plain = _call(native, name, args)
        assert native.call_counts()[name]["numpy"] == before + 1
    np.testing.assert_array_equal(np.asarray(got), np.asarray(plain))
    assert np.asarray(got).dtype == np.asarray(plain).dtype


def test_bit_correlate_takes_numpy_form_off_its_domain():
    """Bits outside {0, 1} or a mask outside ±1: the native form would
    truncate them, so the numpy form runs (counted) and convolves the
    values as given."""
    rng = np.random.RandomState(4)
    bits, mask = rng.rand(300), rng.randint(0, 2, 16) * 2 - 1.0
    for b, m in ((bits, mask), ((bits > 0.5) * 1.0, mask * 0.5)):
        before = native.call_counts()["bit_correlate"]["numpy"]
        np.testing.assert_array_equal(native.bit_correlate(b, m), np.convolve(b, m))
        assert native.call_counts()["bit_correlate"]["numpy"] == before + 1


def _ring_ops(case):
    """(outLen, bufLen, ops) of each case of tests/test_native.py: ("i",
    data) inserts, ("p", n) pops n."""
    if case == "matches_python_semantics":
        rng = np.random.RandomState(0)
        ops = []
        for _ in range(50):
            n = rng.randint(1, 150)
            ops += [("i", (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)), ("p", 100)]
        return 100, 1000, ops
    if case == "wraparound":
        return 64, 100, [op for s in range(0, 640, 64)
                         for op in (("i", np.arange(s, s + 64).astype(np.complex64)), ("p", 64))]
    if case == "overflow_flush":
        return 10, 20, [("i", np.zeros(15, np.complex64)), ("i", np.ones(15, np.complex64)),
                        ("p", 10)]
    return 10, 20, [("i", np.arange(50).astype(np.complex64)), ("p", 10)]


@pytest.mark.parametrize("case", ["matches_python_semantics", "wraparound", "overflow_flush",
                                  "oversize_chunk_keeps_tail"])
def test_native_ring_matches_numpy_ring(case):
    outLen, bufLen, ops = _ring_ops(case)
    rings = (native.NativeRingBuffer(outLen, bufLen=bufLen), RingBuffer(outLen, bufLen=bufLen))
    counts = native.call_counts()["ring"]
    for op, arg in ops:
        if op == "i":
            assert rings[0].insert(arg) == rings[1].insert(arg)
        else:
            a, b = (r.popBlock(arg) for r in rings)
            assert (len(a) == 0) == (len(b) == 0)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert rings[0].currentBufSize == rings[1].currentBufSize
    n_ins = sum(op == "i" for op, _ in ops)
    assert native.call_counts()["ring"] == {"native": counts["native"] + n_ins,
                                            "numpy": counts["numpy"] + n_ins}


def test_sigfifo_takes_the_native_ring():
    from pycusdr_tpu_torch.runtime.sigfifo import SigFIFO

    f = SigFIFO("tcp://127.0.0.1:19290", 100, timeOut_ms=50)
    try:
        assert isinstance(f.buf, native.NativeRingBuffer)
    finally:
        f.close()


def _cc11xx_stream(seed, n_packets=6):
    """CC11xx frames (the port's framer on CC11xx.json) of mixed lengths
    between random bits, cut into ragged blocks; and the payloads."""
    from pycusdr_tpu_torch.config.loader import load_modular_json
    from pycusdr_tpu_torch.protocol import loadProtocol
    from pycusdr_tpu_torch.tx.encoders import CC11xxEncoder

    conf = load_modular_json(str(CC11XX_JSON))
    rng = np.random.RandomState(seed)
    enc = CC11xxEncoder(loadProtocol("CC11xx")(conf=conf), {})
    payloads = [rng.randint(0, 256, n).astype(np.uint8) for n in rng.randint(2, 254, n_packets)]
    parts = [rng.randint(0, 2, 700)]
    for p in payloads:
        parts += [np.asarray(enc.encodeAndFrame(p)), rng.randint(0, 2, int(rng.randint(50, 900)))]
    parts.append(rng.randint(0, 2, 2400))
    bits = np.concatenate(parts).astype(np.uint8)
    cuts = np.sort(rng.choice(np.arange(1, len(bits)), 20, replace=False))
    return conf, np.split(bits, cuts), payloads


def _frames(decoder, blocks):
    out = []
    for b in blocks:
        pkts, _, n_sync = decoder.findFrames(b, 0)
        out.append(n_sync)
        for p in pkts:
            data, err, _ = p.getBinaryData()
            out.append((np.asarray(data).tolist(), int(err)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_frame_finder_decisions_equal_either_form_and_jax(seed, monkeypatch):
    """The frame finder on CC11xx frames: the packets and sync counts are
    the same with the native correlation, with the numpy one, and from the
    JAX package's frame finder; every payload comes out CRC-clean."""
    from pycusdr_tpu.decode import Decoder as JDecoder
    from pycusdr_tpu.protocol import loadProtocol as jload
    from pycusdr_tpu_torch.decode import Decoder
    from pycusdr_tpu_torch.protocol import loadProtocol

    conf, blocks, payloads = _cc11xx_stream(seed)
    dconf = conf.get("decoder", {})
    before = native.call_counts()["bit_correlate"]
    got = _frames(Decoder(dconf, loadProtocol("CC11xx")(conf=conf)), blocks)
    after = native.call_counts()["bit_correlate"]
    assert after["native"] - before["native"] == 2 * len(blocks)
    assert after["numpy"] == before["numpy"]
    want = _frames(JDecoder(dconf, jload("CC11xx")(conf=conf)), blocks)
    with monkeypatch.context() as m:
        m.setattr(native, "_lib", None)
        m.setattr(native, "_tried", True)
        plain = _frames(Decoder(dconf, loadProtocol("CC11xx")(conf=conf)), blocks)
    assert got == plain == want
    clean = [bytes(d) for d, err in (x for x in got if isinstance(x, tuple)) if err >= 0]
    assert clean == [bytes(p) for p in payloads]


def test_library_is_built_under_build_not_beside_the_source():
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().exists()
    assert not list(native.SRC.parent.glob("*.so"))


IMPORTER = r"""
import json, sys, hashlib
from pathlib import Path
import numpy as np
from pycusdr_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
ok = native.AVAILABLE
rng = np.random.RandomState(7)
x = (rng.randn(999) + 1j * rng.randn(999)).astype(np.complex64)
b, m = rng.randint(0, 2, 3000).astype(np.int8), (rng.randint(0, 2, 64) * 2 - 1).astype(np.int8)
d = rng.randint(0, 256, 200).astype(np.uint8)
ring = native.NativeRingBuffer(100, bufLen=400)
ring.insert(x[:250])
outs = [native.c2ri_native(x), native.bit_correlate(b, m), native.pn9_xor(d),
        np.array(native.crc16(d)), ring.popBlock(100)]
print(json.dumps({"available": ok, "counts": native.call_counts(),
                  "digest": hashlib.sha256(b"".join(o.tobytes() for o in outs)).hexdigest()}))
"""

GXX = r"""#!{python}
import os, sys
with open({calls!r}, "a") as f:
    f.write(" ".join(sys.argv[1:]) + "\n")
os.execv({gxx!r}, [{gxx!r}] + sys.argv[1:])
"""


def test_six_processes_build_one_library(tmp_path):
    """Six processes read ``AVAILABLE`` at once over an empty build
    directory: every one gets the library and the same outputs, g++ runs
    once, and no temporary file is left."""
    calls, bindir, build = tmp_path / "calls.txt", tmp_path / "bin", tmp_path / "build"
    bindir.mkdir()
    (bindir / "g++").write_text(GXX.format(python=sys.executable, calls=str(calls),
                                           gxx=shutil.which("g++")))
    (bindir / "g++").chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH=f"{bindir}:{os.environ['PATH']}")
    procs = [subprocess.Popen([sys.executable, "-c", IMPORTER, str(build)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert all(r["available"] for r in results), results
    assert len({r["digest"] for r in results}) == 1
    assert all(r["counts"]["bit_correlate"] == {"native": 1, "numpy": 0} for r in results)
    assert len(calls.read_text().splitlines()) == 1, calls.read_text()
    libs = sorted(p.name for p in build.iterdir() if not p.name.endswith(".lock"))
    assert libs == [native.library_path().name], libs
