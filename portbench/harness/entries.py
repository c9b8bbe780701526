"""The entries into the measured program that the window drives, one call a
batch, each through the program's own functions:

- "batch": the pinned batch is handed to the card (``.to(device,
  non_blocking=True)``, the copy ``Demodulator._upload`` makes after its own
  pageable-to-pinned copy, which the benchmark does not make), the packed
  block graph runs (``dsp.block.build_process_batch(spec, packed=True)``) and
  ``models.demodulator.start_download`` brings the (C, L) rows back to pinned
  host memory; ``finish`` waits for them (``finish_download``).
- "wideband": the pinned hop is handed to the card, the channelizer
  (``parallel.channelizer.Channelizer.process``, its carry from call to call)
  splits it into M channels and the channel-parallel step
  (``parallel.sharded_demod.build_sharded_demod_step``, ``vote=False``, on
  the one-device mesh) demodulates them; each of the step's outputs comes
  back through ``start_download``.

``enqueue_s`` sums the host time of the calls into the program's graph
functions (the benchmark's own span around them).
"""

import time

import torch

from portbench.harness.traffic import radio


def program_spec(conf: dict):
    """The program's spec of ``conf``'s radio, as its demodulator builds it."""
    from pycusdr_tpu_torch.dsp.spec import build_spec
    from pycusdr_tpu_torch.protocol import loadProtocol

    name, rx, _ = radio(conf)
    protocol = loadProtocol(conf["Main"]["protocols"][rx["Protocol"]])(conf=conf)
    return build_spec(conf, protocol, name)


class BatchEntry:
    kind = "batch"

    def __init__(self, conf: dict, device):
        from pycusdr_tpu_torch.dsp.block import build_process_batch
        from pycusdr_tpu_torch.models.demodulator import finish_download, start_download

        self.spec = program_spec(conf)
        self.process = build_process_batch(self.spec, device=device, packed=True)
        self.device = self.process.device
        self._start, self._finish = start_download, finish_download
        self.enqueue_s = 0.0

    def dispatch(self, batch: torch.Tensor):
        x = batch.to(self.device, non_blocking=True)
        t0 = time.perf_counter()
        rows = self.process(x)
        self.enqueue_s += time.perf_counter() - t0
        return self._start(rows)

    def finish(self, pending):
        """The (C, L) packed rows in host memory."""
        return self._finish(pending)


class WidebandEntry:
    kind = "wideband"

    def __init__(self, conf: dict, device):
        from pycusdr_tpu_torch.models.demodulator import finish_download, start_download
        from pycusdr_tpu_torch.parallel.channelizer import Channelizer
        from pycusdr_tpu_torch.parallel.mesh import make_mesh
        from pycusdr_tpu_torch.parallel.sharded_demod import build_sharded_demod_step

        wb = conf["Wideband"]
        self.spec = program_spec(conf)
        self.channelizer = Channelizer(int(wb["M"]), int(wb["taps_per_branch"]),
                                       float(wb["beta"]), device=device)
        self.device = self.channelizer.device
        mesh = make_mesh({"channel": 1}, devices=None if device is None else [device])
        self.step = build_sharded_demod_step(self.spec, mesh, vote=False)
        self._start, self._finish = start_download, finish_download
        self.enqueue_s = 0.0

    def dispatch(self, hop: torch.Tensor):
        x = hop.to(self.device, non_blocking=True)
        t0 = time.perf_counter()
        out = self.step(self.channelizer.process(x))
        self.enqueue_s += time.perf_counter() - t0
        return {k: self._start(v) for k, v in out.items()}

    def finish(self, pending):
        """The step's outputs, each (M, ...) in host memory."""
        return {k: self._finish(v) for k, v in pending.items()}


ENTRIES = {"batch": BatchEntry, "wideband": WidebandEntry}


def build(traffic: dict, conf: dict, device=None):
    return ENTRIES[traffic["entry"]](conf, device)
