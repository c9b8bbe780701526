"""A whole run of each cell on the CPU at the tests' size, past the look for
a card, with the timed path broken underneath: ``correct`` must come out
false under the cell's own limits. The faults a cell can have:

- ``stale``: the call returns the previous call's outputs (its state left
  unchanged);
- ``half``: the graph runs on half of the batch and its rows stand in for
  the rest;
- ``altered``: one block's bits inverted where the graph writes them;
- ``carry`` (the wideband entry): the channelizer's carry left out.

There is no exchange between chips to leave out: every cell is on one chip.
The control (the reference in TF32 in the program's place) fails the same
limits, and a sound run of each cell passes them.
"""

import pytest
import torch

from portbench import run
from portbench.harness import cells, entries


class _Faulty:
    def __init__(self, fault):
        self.fault = fault
        self.prev = None

    def stale(self, pending):
        prev, self.prev = (self.prev if self.prev is not None else pending), pending
        return prev


def _batch(fault):
    class Entry(entries.BatchEntry, _Faulty):
        def __init__(self, conf, device):
            entries.BatchEntry.__init__(self, conf, device)
            _Faulty.__init__(self, fault)

        def dispatch(self, batch):
            x = batch.to(self.device)
            if self.fault == "stale":
                return self.stale(self._start(self.process(x)))
            if self.fault == "half":
                rows = self.process(x[:x.shape[0] // 2].contiguous())
                return self._start(torch.cat([rows, rows]))
            rows = self.process(x)
            S = self.spec.numSymMax
            rows[0, :S] = 1 - rows[0, :S]
            return self._start(rows)

    return Entry


def _wideband(fault):
    class Entry(entries.WidebandEntry, _Faulty):
        def __init__(self, conf, device):
            entries.WidebandEntry.__init__(self, conf, device)
            _Faulty.__init__(self, fault)

        def dispatch(self, hop):
            x = hop.to(self.device)
            if self.fault == "carry":
                self.channelizer.state = self.channelizer.init_state()
            y = self.channelizer.process(x)
            if self.fault == "half":
                out = self.step(y[:y.shape[0] // 2].contiguous())
                out = {k: torch.cat([v, v]) for k, v in out.items()}
            else:
                out = self.step(y)
            if self.fault == "altered":
                out["bits"][0] = 1 - out["bits"][0]
            pending = {k: self._start(v) for k, v in out.items()}
            return self.stale(pending) if self.fault == "stale" else pending

    return Entry


FAULTS = [(c, f) for c in ("uhf_gfsk.c64", "stx.c64")
          for f in ("stale", "half", "altered")] + \
         [("uhf_gfsk.wb64", f) for f in ("stale", "half", "altered", "carry")]


def _run(cell, factory):
    return run.run(cell, 2 ** 31 + 12345, 0.4, False, device="cpu", entry_factory=factory,
                   n_batches=4)


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_broken_path_is_not_correct(name, fault, tiny_root):
    cell = cells.load(name, tiny_root)
    make = _wideband if cell.traffic["entry"] == "wideband" else _batch
    res = _run(cell, lambda traffic, conf, device: make(fault)(conf, device))
    assert res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", ["uhf_gfsk.c64", "stx.c64", "uhf_gfsk.wb64"])
def test_the_control_is_not_correct(name, tiny_root):
    """The reference in TF32 in the program's place, on calls of a pool of
    the tests' size, fails the cell's own limits."""
    from portbench.harness import check, traffic

    cell = cells.load(name, tiny_root)
    pool = traffic.make_pool(cell.conf, cell.traffic, 2 ** 31 + 3, "cpu", n_batches=4)
    numbers = check.tally(cell, pool, {6: None, 7: None}, "cpu", control=True).numbers()
    assert not check.verdict(numbers, cell.limits), numbers


@pytest.mark.parametrize("name", ["uhf_gfsk.c64", "stx.c64", "uhf_gfsk.wb64"])
def test_a_sound_run_is_correct(name, tiny_root):
    cell = cells.load(name, tiny_root)
    res = _run(cell, entries.build)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"msps", "call_p95_ms", "setup_s"}
