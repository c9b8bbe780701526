"""LEO Doppler search-and-track loop.

The port of ``pycusdr_tpu/models/tracking.py`` (BASELINE config #3). For
a LEO pass the Doppler is a smooth ramp, so after acquisition a narrow
grid recentred on a linear-ramp prediction is enough, while a quality
watchdog falls back to the wide acquisition grid when the track is lost.

Both modes are the packed single-block graph (``dsp/block.py``) with
different grids; the track grid's position is the runtime
``centre_shift`` that K1 and K5 take, so tracking builds nothing per
block. The ramp fit (``np.polyfit``), the thresholds and the state
machine are JAX's.
"""

import logging

import numpy as np

from pycusdr_tpu_torch.dsp.block import build_process_block, unpack_block_outputs
from pycusdr_tpu_torch.dsp.spec import DemodSpec, build_spec, narrow_spec

log = logging.getLogger(__name__)

ACQUIRING = "acquiring"
TRACKING = "tracking"


class DopplerTracker:
    """Wraps the block graph in an acquire -> track -> reacquire loop.

    ``device``: None means the card (raises without one), "cpu" the plain
    versions on the CPU. ``plain``: both graphs run every kernel's plain
    version (the reference tracker the kernels are held against)."""

    def __init__(self, conf=None, protocol=None, radioName=None, *,
                 spec: DemodSpec = None, track_bins: int = 16,
                 track_span_bins: int = 32, history: int = 8,
                 snr_threshold_db: float = 3.0, lost_limit: int = 5,
                 device=None, plain: bool = False):
        self.spec = spec if spec is not None else build_spec(conf, protocol, radioName)
        self.track_spec = narrow_spec(self.spec, track_bins, track_span_bins)

        # one block per call, one device-to-host copy of its packed row
        self._acquire = build_process_block(self.spec, device=device, packed=True, plain=plain)
        self._track = build_process_block(self.track_spec, device=device, packed=True,
                                          plain=plain)

        self.history = history
        self.snr_threshold_db = snr_threshold_db
        self.lost_limit = lost_limit

        self.state = ACQUIRING
        self._t = []  # block index history
        self._hz = []  # doppler history (Hz)
        self._lost = 0
        self._blocks = 0

        self.bin_hz = self.spec.sampleRate / self.spec.Nfft

    # ---------------- ramp model ----------------

    def predict_hz(self, t: float) -> float:
        """Linear ramp fit over the recent history (least squares)."""
        if len(self._hz) == 0:
            return 0.0
        if len(self._hz) == 1:
            return self._hz[-1]
        tt = np.asarray(self._t, dtype=np.float64)
        hh = np.asarray(self._hz, dtype=np.float64)
        slope, icept = np.polyfit(tt, hh, 1)
        return float(slope * t + icept)

    def _push(self, t, hz):
        self._t.append(t)
        self._hz.append(hz)
        if len(self._t) > self.history:
            self._t.pop(0)
            self._hz.pop(0)

    # ---------------- main entry ----------------

    def process(self, samples) -> dict:
        """Run one (Nfft,) complex64 block; returns the block result dict
        plus ``mode``/``predicted_hz`` telemetry."""
        t = self._blocks
        self._blocks += 1

        if self.state == ACQUIRING:
            res = unpack_block_outputs(self._acquire(samples).cpu().numpy(), self.spec)
            res["mode"] = ACQUIRING
            res["predicted_hz"] = None
            q = float(res["snr_db"])
            # a confident acquisition (healthy SNR) switches to tracking
            if q > self.snr_threshold_db:
                self._push(t, float(res["doppler_hz"]))
                if len(self._hz) >= 2:
                    self.state = TRACKING
                    self._lost = 0
                    log.info("acquired at %+.0f Hz (SNR %.1f dB) -- tracking",
                             res["doppler_hz"], q)
            return res

        # TRACKING: recentre the narrow grid on the ramp prediction
        pred_hz = self.predict_hz(t)
        centre = int(round(pred_hz / self.bin_hz)) - self.track_spec.dopp_offset_idx
        res = unpack_block_outputs(self._track(samples, centre).cpu().numpy(), self.track_spec)
        res["mode"] = TRACKING
        res["predicted_hz"] = pred_hz

        q = float(res["snr_db"])
        if q > self.snr_threshold_db:
            self._lost = 0
            self._push(t, float(res["doppler_hz"]))
        else:
            self._lost += 1
            if self._lost >= self.lost_limit:
                log.info("track lost (%d weak blocks) -- reacquiring", self._lost)
                self.state = ACQUIRING
                self._t.clear()
                self._hz.clear()
                self._lost = 0
        return res
