"""Host-side demodulator frontend: owns the device block graph, the
overlap-save streaming state and the cross-block bit alignment.

Same public API as ``pycusdr_tpu/models/demodulator.py:108-371``:
``warmup``, ``dispatch``/``collect``, ``uploadAndFindCarrier`` then
``demodulate``, ``process``, ``processMany`` and ``processCapture``.

Per block, ``dispatch`` queues one host-to-device copy (from pinned
memory) and the graph on the current stream and returns at once; it
makes no host sync, since device scalars reach the kernels by pointer.
``collect`` makes exactly one device-to-host copy of the packed result
vector, into pinned memory, and waits for it.
"""

import logging

import numpy as np
import torch

from pycusdr_tpu_torch.dsp.block import (
    build_process_batch,
    frame_blocks,
    unpack_block_outputs,
)
from pycusdr_tpu_torch.dsp.spec import DemodSpec, build_spec
from pycusdr_tpu_torch.models.healing import BlockHealer

log = logging.getLogger(__name__)

# symbol-overlap healing defaults (reference demodulator_base.py:20-22)
SYMBOL_CHECK_OVERLAP_OFFSET = 20
SYMBOL_CHECK_ERROR_THRESHOLD = 1000
SYMBOL_CHECK_MATCH_NUM_ERRORS_ALLOWED = 10


def start_download(vec: torch.Tensor):
    """Queue ONE device-to-host copy of a packed result into pinned memory
    (nothing to do for a CPU tensor); ``finish_download`` waits for it."""
    if vec.device.type != "cuda":
        return vec, None
    out = torch.empty(vec.shape, dtype=vec.dtype, pin_memory=True)
    out.copy_(vec, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return out, done


def finish_download(pending) -> np.ndarray:
    out, done = pending
    if done is not None:
        done.synchronize()
    return out.numpy()


class Demodulator:
    """One Rx channel: streaming state + device block graph.

    ``device``: None means the card (raises without one); "cpu" runs
    the plain PyTorch path.
    """

    def __init__(self, conf, protocol, radioName, spec: DemodSpec = None, device=None):
        self.protocol = protocol
        self.radioName = radioName
        self.conf = conf
        self.spec = spec if spec is not None else build_spec(conf, protocol, radioName)

        confRadio = conf["Radios"]["Rx"][radioName]
        confGPU = conf["GPU"][confRadio["CUDA_settings"]]
        self.overlapOffset = confGPU.get("symbol_check_overlap_offset", SYMBOL_CHECK_OVERLAP_OFFSET)
        self.symbol_check_error_threshold = confGPU.get(
            "symbol_check_error_threshold", SYMBOL_CHECK_ERROR_THRESHOLD
        )
        self.symbol_check_match_threshold = self.overlapOffset - confGPU.get(
            "symbol_check_match_num_errors_allowed", SYMBOL_CHECK_MATCH_NUM_ERRORS_ALLOWED
        )

        self.Nfft = self.spec.Nfft
        self.sigOverlap = self.spec.sigOverlap
        self.sigOverlapWin = self.spec.sigOverlap // 2
        self.voteWeight = self.spec.voteWeight

        self._process_batch = build_process_batch(self.spec, device=device, packed=True)
        self.device = self._process_batch.device
        self._cuda = self.device.type == "cuda"
        self.healer = BlockHealer(
            self.Nfft, self.sigOverlap,
            overlapOffset=self.overlapOffset,
            error_threshold=self.symbol_check_error_threshold,
            match_num_errors_allowed=self.overlapOffset - self.symbol_check_match_threshold,
        )
        self._signal_buffer = np.zeros(self.Nfft, dtype=np.complex64)
        self._last = None  # host results of the current block

        self.dopplerIdxlast = 0
        self.clippedPeakIPure = np.array([], dtype=np.int64)

        # debug full-state dumps (reference STORE_BITS_IN_FILE,
        # demodulator_base.py:224-241): one npz per block
        from pycusdr_tpu_torch.globals import STORE_BITS_IN_FILE

        self._store_bits = STORE_BITS_IN_FILE
        self._dump_count = 0

        log.info(
            "[%s]: demodulator ready on %s: Nfft=%d overlap=%d masks=%d dopplers=%d "
            "sum_all_masks=%s", radioName, self.device, self.Nfft, self.sigOverlap,
            self.spec.num_masks, self.spec.num_dopplers, self.spec.sum_all_masks,
        )

    # ---------------- host <-> device ----------------

    def _upload(self, host: np.ndarray, staging: torch.Tensor = None) -> torch.Tensor:
        """ONE host-to-device copy. On the card the samples are staged in
        pinned memory, so the caller may reuse its buffer at once (on the
        CPU the graph has run before dispatch returns). ``staging``: a 1-D
        pinned buffer of at least ``host.size`` samples to stage in (the
        caller makes sure its previous copy has left it); None allocates one."""
        t = torch.from_numpy(np.ascontiguousarray(host, dtype=np.complex64))
        if not self._cuda:
            return t
        if staging is None:
            staging = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        else:
            staging = staging[:t.numel()].view(t.shape)
        staging.copy_(t)
        return staging.to(self.device, non_blocking=True)

    # ---------------- reference-parity public API ----------------

    def get_signalBufferHostPointer(self):
        """Host staging buffer for the overlap-save block (the runtime fills
        it before each process call)."""
        return self._signal_buffer

    def warmup(self):
        """Run the graph once on a zeros block without touching any
        streaming state (healer, staging buffer, Doppler memory): builds
        the kernels and fills the allocator caches before samples flow."""
        vec = self._process_batch(self._upload(np.zeros((1, self.Nfft), np.complex64)))
        finish_download(start_download(vec))

    def dispatch(self, samples=None):
        """Queue one block's device graph; return a handle for ``collect``.

        Returns as soon as the copy and the graph are queued. Handles MUST
        be collected in dispatch order: the block-boundary healer is
        sequential host state."""
        if samples is None:
            samples = self._signal_buffer
        return self._process_batch(self._upload(np.asarray(samples)[None]))[0]

    def collect(self, handle):
        """Fetch a ``dispatch`` handle's results (one D2H copy) and run the
        host-side phase (overlap-window selection + block healing). Returns
        the same dict as ``process``."""
        freqOffset, sdev, _clipped, snr = self._fetch(handle)
        bits, centres, trust, spSym = self.demodulate()
        return {
            "bits": bits,
            "trust": trust,
            "centres": centres,
            "spSymEst": spSym,
            "doppler": freqOffset,
            "doppler_std": sdev,
            "SNR": snr,
        }

    def uploadAndFindCarrier(self, samples=None):
        """Run the device graph; return (freqOffset_Hz, sdev_Hz, clippedPeaks, SNR)."""
        return self._fetch(self.dispatch(samples))

    def _fetch(self, handle):
        self._last = unpack_block_outputs(
            finish_download(start_download(handle)), self.spec)
        return self._carrier_stats(self._last)

    def _carrier_stats(self, r):
        if not self.spec.doppler_search:
            # fixed-offset mode: nothing is estimated, and the Doppler
            # memory stays as it is (pycusdr_tpu/models/demodulator.py:173-175)
            self.clippedPeakIPure = np.array([], dtype=np.int64)
            return 0.0, 0.0, self.clippedPeakIPure, 0.0
        freqOffset = float(r["freq_offset_hz"])
        # the reference's second slot carries the match quality scaled to Hz
        sdev_hz = float(r["quality_db"]) / self.Nfft * self.spec.sampleRate
        snr = float(r["snr_db"])
        self.dopplerIdxlast = int(r["shift"])
        return freqOffset, sdev_hz, self.clippedPeakIPure, snr

    def demodulate(self):
        """Return (dataBits, centres, trust, spSymEst) for the non-overlap window."""
        r = self._last
        if r is None:
            raise RuntimeError("call uploadAndFindCarrier first")

        nBits = int(r["nBits"])
        bits = r["bits"][:nBits]
        trust = r["trust"][:nBits]
        centres = r["centres"][:nBits]
        spSym = float(r["spSym"])

        noError = int(np.sum(trust == -1))
        centresWin, bitsWin, trustWin, _ = self.checkSymbolOverlap(
            noError, centres, r["symbols"][:nBits], bits, trust, spSym
        )
        if self._store_bits:
            import os

            os.makedirs("debug_dumps", exist_ok=True)
            np.savez(
                f"debug_dumps/{self.radioName}_block{self._dump_count:06d}.npz",
                bits=bits, trust=trust, centres=centres, spSym=spSym,
                doppler_hz=r["doppler_hz"], snr_db=r["snr_db"], E=r["E"],
            )
            self._dump_count += 1
        return bitsWin.astype(np.uint8), centresWin, trustWin.astype(np.int8), spSym

    def processMany(self, hops):
        """Batched streaming: demodulate K consecutive hops in ONE dispatch
        (one H2D copy, the batched graph, one D2H copy), then apply the
        sequential host-side block healing per block.

        ``hops``: (K, Nfft - sigOverlap) complex64 of NEW samples. The
        overlap-save history is taken from (and left in) the staging
        buffer, so interleaving processMany with the per-block API is
        safe. Returns a list of K result dicts like ``process``.
        """
        hops = np.ascontiguousarray(hops, dtype=np.complex64)
        K, hop = hops.shape
        if hop != self.Nfft - self.sigOverlap:
            raise ValueError(f"hop must be {self.Nfft - self.sigOverlap}, got {hop}")

        # block i = [tail(i-1), hop_i]; at rest the staging buffer's FIRST
        # sigOverlap samples hold the previous tail
        blocks = np.empty((K, self.Nfft), np.complex64)
        tail = self._signal_buffer[: self.sigOverlap].copy()
        for i in range(K):
            blocks[i, : self.sigOverlap] = tail
            blocks[i, self.sigOverlap :] = hops[i]
            tail = blocks[i, -self.sigOverlap :]
        self._signal_buffer[: self.sigOverlap] = tail

        res = finish_download(start_download(
            self._process_batch(self._upload(blocks))))
        return [self._emit_packed_row(res[i]) for i in range(K)]

    def _emit_packed_row(self, vec_row):
        """One packed result row -> the healed per-block result dict (shared
        by processMany / processCapture so the paths cannot diverge)."""
        self._last = unpack_block_outputs(vec_row, self.spec)
        freqOffset, sdev, _clipped, snr = self._carrier_stats(self._last)
        bits, centres, trust, spSym = self.demodulate()
        return {
            "bits": bits, "trust": trust, "centres": centres,
            "spSymEst": spSym, "doppler": freqOffset,
            "doppler_std": sdev, "SNR": snr,
        }

    def process(self, samples=None):
        """Single-call convenience API: both phases + the stats bundle."""
        return self.collect(self.dispatch(samples))

    def processCapture(self, capture, max_hops_per_dispatch=64):
        """Offline pass reprocessing: demodulate a whole recorded capture at
        batch throughput, in dispatches of at most ``max_hops_per_dispatch``
        hops. Each dispatch uploads only its own hops, through one pinned
        staging buffer of that many hops, and frames its blocks on the
        device behind the ``sigOverlap``-sample tail the previous dispatch
        left there (the overlap-save carry of JAX's ``processCapture``), as
        one contiguous (n, Nfft) batch like ``processMany``'s (``dsp.block.
        frame_blocks``, as ``build_process_capture`` frames). Dispatch k+1
        is queued before dispatch k's results are fetched; host-side healing
        runs per block exactly as in streaming.

        ``capture``: 1-D complex64 array of ANY length, padded with zeros
        to whole hops. The overlap-save history enters from (and is left
        in) the staging buffer. Returns a list of per-block result dicts.
        """
        capture = np.ascontiguousarray(capture, dtype=np.complex64).reshape(-1)
        ov = self.sigOverlap
        hop = self.Nfft - ov
        K_total = -(-len(capture) // hop)
        if K_total == 0:
            return []
        P = max(1, int(max_hops_per_dispatch))
        staging = (torch.empty(P * hop, dtype=torch.complex64, pin_memory=True)
                   if self._cuda else None)
        staged = None  # the event after the last copy out of ``staging``
        head = self._upload(self._signal_buffer[:ov])  # the carry, on the device
        out, pending = [], None
        for pos in range(0, K_total, P):
            n = min(P, K_total - pos)
            seg = capture[pos * hop:(pos + n) * hop]
            if len(seg) < n * hop:  # the last hop, zero-padded
                seg = np.concatenate([seg, np.zeros(n * hop - len(seg), np.complex64)])
            if staged is not None:
                staged.synchronize()
            new = self._upload(seg, staging)
            if self._cuda:
                staged = torch.cuda.Event()
                staged.record()
            blocks, head = frame_blocks(head, new, self.Nfft)  # (n, Nfft), (ov,)
            nxt = (start_download(self._process_batch(blocks)), n)
            if pending is not None:
                res = finish_download(pending[0])
                out.extend(self._emit_packed_row(res[i]) for i in range(pending[1]))
            pending = nxt
        res = finish_download(pending[0])
        out.extend(self._emit_packed_row(res[i]) for i in range(pending[1]))
        # leave the overlap-save history where live streaming expects it:
        # the last ov samples of [history, capture, zero padding]
        pad = np.zeros(K_total * hop - len(capture), np.complex64)
        self._signal_buffer[:ov] = np.concatenate(
            [self._signal_buffer[:ov], capture[-ov:], pad])[-ov:]
        return out

    # ---------------- block-boundary healing ----------------

    def checkSymbolOverlap(self, noError, centres, idxSymbol, dataBits, trustSymbol,
                           spSym=None):
        """±1-symbol block-boundary alignment; see models/healing.py
        (port of reference demodulator_base.py:863-988)."""
        return self.healer.heal(noError, centres, idxSymbol, dataBits, trustSymbol, spSym)
