"""``ops._lib.build`` is safe across processes: the station's Rx children
each build the kernels at their first launch, so two processes that build
at once into one ``BUILD_DIR`` must get one library, with each source
compiled once. ``nvcc`` is a stub script here (there is none on the CPU):
it logs every call and writes each object in two halves a pause apart, so
a second compiler writing the same object, or a link reading a
half-written one, would show."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

STUB = r"""#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({calls!r}, "a") as f:
    f.write(" ".join(a for a in args if a.endswith(".cu") or a == "-shared") + "\n")
if "-shared" in args:
    objs = [a for a in args if a.endswith(".o")]
    body = b"".join(open(o, "rb").read() for o in objs)
    open(out, "wb").write(body)
else:
    src = next(a for a in args if a.endswith(".cu"))
    with open(out, "wb") as f:
        f.write(b"obj:" + os.path.basename(src).encode())
        f.flush()
        time.sleep(0.3)
        f.write(b":end\n")
"""

BUILDER = r"""
import json, sys
from pathlib import Path
from pycusdr_tpu_torch.ops import _lib
_lib._nvcc = lambda: sys.argv[1]
_lib.BUILD_DIR = Path(sys.argv[2])
out = _lib.build()
print(json.dumps({"path": str(out), "cached": _lib.build_info["cached"],
                  "body": out.read_bytes().decode()}))
"""


def test_two_processes_build_one_library(tmp_path):
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, calls=str(calls)))
    stub.chmod(0o755)
    build_dir = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(stub), str(build_dir)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = []
    deadline = time.time() + 120
    for p in procs:
        out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))

    sources = sorted(s.name for s in (REPO / "pycusdr_tpu_torch" / "csrc").glob("*.cu"))
    lines = calls.read_text().splitlines()
    compiled = sorted(Path(line).name for line in lines if line != "-shared")
    assert compiled == sources, "each source must be compiled exactly once"
    assert lines.count("-shared") == 1, "one link"
    assert results[0]["path"] == results[1]["path"]
    assert sorted(r["cached"] for r in results) == [False, True]
    # the library holds every object whole
    body = results[0]["body"]
    assert body == results[1]["body"]
    assert body == "".join(f"obj:{s}:end\n" for s in sources)
    assert not list(build_dir.glob("*.tmp"))
