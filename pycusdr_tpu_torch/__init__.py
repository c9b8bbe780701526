"""pycusdr_tpu_torch — the PyTorch / CUDA port of pycusdr_tpu for NVIDIA
Hopper (H100).

It stands beside the JAX package, which stays the reference, and imports
nothing of it (nor ``jax``): it keeps its own copy of each host module it
needs. It runs the modem as a ground station starts it,
``python -m pycusdr_tpu_torch -c config.json``: the orchestrator spawns
one demodulator child per Rx radio, or one lockstep channel-group child
that demodulates clock-shared antennas in one dispatch and votes on the
card, and a decoder child, wired by ZMQ. Inside them: the per-block
demodulation in two modes, UHF with the Doppler search
(``models.uhf.Demodulator``) and STX with spike clipping at a fixed
offset (``models.stx.Demodulator``), for centre-bit and NRZ-S (BPSK)
protocols; the concatenated CCSDS downlink's Tx chain (``tx.Modulator``)
and decoder (``decode.Decoder``: streaming Viterbi, frame sync, RS). The
device ops are hand-written CUDA kernels for sm_90a (``csrc/``, built at
first use), each with a plain PyTorch version beside it.

=========  ====================================================
subpkg     role
=========  ====================================================
runtime    orchestrator (planned restarts under an RSS cap),
           demodulator / channel-group / modulator / decoder
           processes, sample ingest, the CLI
ops        kernel wrappers, plain versions, the kernel build,
           the convolutional code and streaming Viterbi
parallel   the vote (K8), the channelizer (K9), the channel x
           dopp and time-sharded steps, meshes over a
           ``torch.distributed`` world
csrc       CUDA C++ sources of the kernels
dsp        spec, the per-block device graph, the numpy golden,
           test signals, AWGN
models     Demodulator frontend, block healing, the LEO tracker
decode     frame finder, RS(255,223), packet de-duplication
tx         framers, LUT modulators, Modulator (host numpy)
protocol   CC11xx, AX.25 (FSK, GMSK), GFSK2, the benchmark
           FSK/GFSK/GMSK/BPSK protocols and CCSDS
combine    the softCombiner: per-channel buffers, alignment,
           the trust vote (host numpy)
control    the XML-RPC server, the rigctld server and the
           hamlib daemon that boots a modem per connection
native     the C++ host runtime (ring buffer, bit correlator,
           PN9, CRC-16), built with g++ at first use
bench      station harnesses: hw_selfcheck, ber, ber_delta,
           diversity, streaming_rt
frontend   the software front end (sim_frontend)
config     the modular JSON loader and the shipped configs
obs        per-worker stats and post-pass analytics
utils      filters, NRZ-S, CRC-16, shift registers, logging
=========  ====================================================

Entry points take ``device=None``, meaning the card; they raise when no
card is present unless the caller passes ``device="cpu"``. The runtime
reads its device from ``PYCUSDR_TORCH_DEVICE`` (unset: the card) or the
CLI's ``--device``.
"""

__version__ = "0.1.0"
