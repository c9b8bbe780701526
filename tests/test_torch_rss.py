"""What the RSS cap of the port's orchestrator reads (``Main.maxWorkerRssMb``,
``pycusdr_tpu_torch/runtime/orchestrator.py``): a child's anonymous resident
set, ``RssAnon + RssShmem``, not statm's ``resident``, which counts every
file page the child maps (about 4.6 GB of torch's CUDA libraries in any
child that imports torch, on an H100 80GB HBM3 machine).

The orchestrator here is a real ``PyCuSDR`` (bench_FSK on the CPU, never
started as a station) whose task list holds small children of this file:
each maps and reads a file, or grows anonymous memory when told to. The
maintenance thread checks them every ``RSS_CHECK_S`` (patched to 0.3 s):

- a child whose mapped file lifts its statm resident over the cap is left
  alone;
- a child that grows anonymous memory past the cap is restarted once, and
  its replacement, which does not grow, stays;
- the storm guard still turns the cap off when a child's warm anonymous set
  is above it, and a file-heavy child ahead of it in the task list is not
  the one restarted.

Each of these fails where the cap reads statm's resident. The smaps form of
the reader (what gVisor gives) is held against the status form. A station
started as the CLI starts it (a ``-c`` main, which spawned children do not
re-import) loads torch in its Rx child alone: the decoder imports it only
for a protocol with device work, the Tx child never. That test binds ports
19300-19304 and 19400-19404; every wait is bounded."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pycusdr_tpu_torch.config.loader import load_modular_json
from pycusdr_tpu_torch.runtime import orchestrator
from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

CONF = os.path.join(os.path.dirname(__file__), "..", "pycusdr_tpu_torch", "config", "configs",
                    "benchmark", "bench_FSK.json")
WAIT_S = 30.0
CAP_MB = 60
FILE_MB = 96
GROW_MB = 100
CHECK_S = 0.3

#: a child: maps and reads ``argv[1]`` (unless "-"), allocates ``argv[2]``
#: MB at once, says "ready", then allocates ``argv[4]`` MB once the file
#: ``argv[3]`` exists (unless "-")
CHILD = r"""
import mmap, os, sys, time
path, now_mb, flag, grow_mb = sys.argv[1], int(sys.argv[2]), sys.argv[3], int(sys.argv[4])
keep = []
def grab(mb):
    b = bytearray(mb * 1000000)
    for i in range(0, len(b), 4096):
        b[i] = 1
    keep.append(b)
if path != "-":
    with open(path, "rb") as f:
        m = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)
    sum(m[i] for i in range(0, len(m), 4096))
    keep.append(m)
if now_mb:
    grab(now_mb)
print("ready", flush=True)
while True:
    if flag != "-" and os.path.exists(flag):
        grab(grow_mb)
        flag = "-"
        print("grown", flush=True)
    time.sleep(0.05)
"""


class _Child:
    """A task of the orchestrator's list, as the runtime's processes are
    (``start``, ``stop``, ``is_alive``, ``terminate``, ``join``, ``kill``,
    ``pid``, ``name``): a ``CHILD`` interpreter. ``start`` returns once it
    has mapped and allocated what it starts with."""

    def __init__(self, name, path="-", now_mb=0, flag="-"):
        self.name, self.args, self.p = name, [path, str(now_mb), flag, str(GROW_MB)], None

    @property
    def pid(self):
        return self.p.pid if self.p is not None else None

    def start(self):
        self.p = subprocess.Popen([sys.executable, "-c", CHILD, *self.args],
                                  stdout=subprocess.PIPE, text=True)
        assert self.p.stdout.readline().strip() == "ready", f"{self.name} did not start"

    def stop(self):
        self.p.terminate()

    def is_alive(self):
        return self.p is not None and self.p.poll() is None

    def terminate(self):
        self.p.terminate()

    def join(self, timeout=None):
        try:
            self.p.wait(timeout)
        except subprocess.TimeoutExpired:
            pass

    def kill(self):
        self.p.kill()


@pytest.fixture
def big_file(tmp_path):
    path = tmp_path / "mapped.bin"
    with open(path, "wb") as f:
        f.write(os.urandom(FILE_MB * 1000000))
    return str(path)


def _station(monkeypatch, factories):
    """A ``PyCuSDR`` with the cap at CAP_MB whose tasks are ``factories``'
    first children; returns (sdr, made: per task, the children its factory
    made after the first, reads: the pids the cap read)."""
    monkeypatch.setenv("PYCUSDR_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(orchestrator, "RSS_CHECK_S", CHECK_S)
    monkeypatch.setattr(orchestrator, "MAINT_PERIOD_S", 0.1)
    reads, real = [], orchestrator.rss_mb

    def counted(pid):
        reads.append(pid)
        return real(pid)

    monkeypatch.setattr(orchestrator, "rss_mb", counted)
    conf = load_modular_json(CONF)
    conf["Main"].update(maxWorkerRssMb=CAP_MB, PacketLen=1000)
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    conf["RPC"] = {"enabled": False}
    sdr = PyCuSDR(conf, args=None)
    made = [[] for _ in factories]

    def recording(i):
        def make():
            child = factories[i](len(made[i]) + 1)
            made[i].append(child)
            return child
        return make

    sdr.tasks = [f(0) for f in factories]
    sdr._task_factories = [recording(i) for i in range(len(factories))]
    return sdr, made, reads


def _wait(cond, what):
    deadline = time.time() + WAIT_S
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} not within {WAIT_S} s")


def _checks(reads, pid, n):
    """Wait until the cap has read ``pid`` n more times."""
    k = reads.count(pid) + n
    _wait(lambda: reads.count(pid) >= k, f"{n} RSS checks of {pid}")


def _stop(sdr, made):
    sdr._running = False
    if sdr._maint_thread is not None:
        sdr._maint_thread.join(timeout=WAIT_S)
    for t in sdr.tasks + [c for m in made for c in m]:
        if t.is_alive():
            t.kill()
            t.join(10)


def test_mapped_file_pages_stay_under_the_cap(monkeypatch, big_file):
    sdr, made, reads = _station(monkeypatch, [lambda g: _Child(f"file{g}", big_file)])
    sdr.start()
    try:
        child = sdr.tasks[0]
        split = orchestrator.memory_split(child.pid)
        assert split["resident"] > CAP_MB + 20, f"the file is not resident: {split}"
        assert orchestrator.rss_mb(child.pid) < CAP_MB / 2, split
        _checks(reads, child.pid, 4)
        assert made == [[]], "a child of mapped file pages was restarted"
        assert sdr.tasks[0] is child and child.is_alive() and sdr._max_rss_mb == CAP_MB
    finally:
        _stop(sdr, made)


def test_growing_anonymous_memory_restarts_once(monkeypatch, big_file, tmp_path):
    flags = [str(tmp_path / f"grow{g}") for g in range(3)]
    sdr, made, reads = _station(monkeypatch,
                                [lambda g: _Child(f"leak{g}", big_file, flag=flags[g])])
    sdr.start()
    try:
        old = sdr.tasks[0]
        _checks(reads, old.pid, 3)
        assert made == [[]], "restarted before it grew: its mapped file was read as RSS"
        open(flags[0], "w").close()
        assert old.p.stdout.readline().strip() == "grown"
        _wait(lambda: made[0] and sdr.tasks[0] is made[0][0], "the planned restart")
        new = made[0][0]
        assert not old.is_alive() and new.is_alive()
        _checks(reads, new.pid, 4)
        assert len(made[0]) == 1 and sdr.tasks[0] is new, "restarted more than once"
        assert sdr._max_rss_mb == CAP_MB and list(sdr._rss_restart_at) == [0]
    finally:
        _stop(sdr, made)


def test_storm_guard_turns_off_a_cap_below_the_warm_anonymous_set(monkeypatch, big_file):
    sdr, made, reads = _station(monkeypatch, [lambda g: _Child(f"file{g}", big_file),
                                              lambda g: _Child(f"heavy{g}", now_mb=GROW_MB)])
    file_child = None
    sdr.start()
    try:
        file_child = sdr.tasks[0]
        _wait(lambda: sdr._max_rss_mb == 0, "the storm guard")
        assert made[0] == [] and sdr.tasks[0] is file_child and file_child.is_alive(), \
            "the file-heavy child was restarted"
        assert len(made[1]) == 1 and sdr.tasks[1] is made[1][0]
        assert list(sdr._rss_restart_at) == [1]
    finally:
        _stop(sdr, made)


def test_smaps_reader_matches_status():
    """``smaps_anon_mb`` (the reader where the status lacks ``RssAnon``, as
    gVisor's does) equals ``RssAnon + RssShmem`` on a child with 30 MB of
    heap and 16 MB of POSIX shared memory."""
    code = ("import time; from multiprocessing import shared_memory as s; "
            "b = bytearray(30_000_000); m = s.SharedMemory(create=True, size=16_000_000); "
            "m.buf[:] = b'x' * len(m.buf); print(1, flush=True); time.sleep(30)")
    p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
    try:
        p.stdout.readline()
        split = orchestrator.memory_split(p.pid)
        assert split["RssShmem"] > 15, split
        assert abs(split["smaps_anon"] - (split["RssAnon"] + split["RssShmem"])) < 1.0, split
        assert split["rss_mb"] == split["RssAnon"] + split["RssShmem"] > 46
    finally:
        p.kill()
        p.wait(timeout=10)


STATION = r"""
import json, os, sys, time
os.environ["PYCUSDR_TORCH_DEVICE"] = "cpu"
from pycusdr_tpu_torch.bench.streaming_rt import _build_conf
from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

def torch_mapped(pid):
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line for line in f)

sdr = PyCuSDR(_build_conf(19300, 1))
sdr.start()
try:
    deadline = time.time() + 90
    flags = [sdr.dec.boundFlag, sdr.modulators[0].boundFlag, sdr.demodulators[0].warmedFlag]
    while time.time() < deadline and not all(f.is_set() for f in flags):
        time.sleep(0.2)
    out = {"ready": all(f.is_set() for f in flags),
           "torch": {who: torch_mapped(t.pid) for who, t in
                     (("decoder", sdr.dec), ("Tx", sdr.modulators[0]),
                      ("Rx", sdr.demodulators[0]))}}
finally:
    sdr.terminate()
print(json.dumps(out))
"""


def test_decoder_and_tx_children_load_no_torch():
    """CC11xx.json's station (Tx and Rx radios) on the CPU, its parent a
    fresh ``python -c`` interpreter: only the Rx child maps a torch library."""
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    out = subprocess.run([sys.executable, "-c", STATION], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"ready": True, "torch": {"decoder": False, "Tx": False, "Rx": True}}, res
