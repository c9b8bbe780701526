"""pycusdr_tpu_torch — the PyTorch / CUDA port of pycusdr_tpu for NVIDIA
Hopper (H100).

It stands beside the JAX package, which stays the reference, and imports
nothing of it (nor ``jax``): it keeps its own copy of each host module it
needs. It runs one Rx channel's per-block demodulation end to end in two
modes: UHF with the Doppler search (``models.uhf.Demodulator``) and STX
with spike clipping at a fixed offset (``models.stx.Demodulator``). The
device ops of both paths are hand-written CUDA kernels for sm_90a
(``csrc/``, built at first use), each with a plain PyTorch version
beside it.

=========  ====================================================
subpkg     role
=========  ====================================================
ops        kernel wrappers, plain versions, the kernel build
csrc       CUDA C++ sources of the kernels
dsp        spec, the per-block device graph, test signals
models     Demodulator frontend and block healing
protocol   the benchmark FSK/GFSK protocols
=========  ====================================================

Entry points take ``device=None``, meaning the card; they raise when no
card is present unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
