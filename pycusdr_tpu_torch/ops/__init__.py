"""Device ops of the demodulation path and the hand-written kernels
behind them (K1 ``doppler_energy``, K2 ``mf_bank_colreduce``, K3
``timing_band``, K4 ``symbol_detect``, K5 ``doppler_estimate``, K6
``threshold_input``)."""


def kernel_wrappers() -> dict:
    """name -> wrapper of every hand-written kernel; each wrapper counts
    its kernel launches in ``.launches``."""
    from pycusdr_tpu_torch.ops.demod_kernels import (
        mf_bank_colreduce,
        symbol_detect,
        threshold_input,
        timing_band,
    )
    from pycusdr_tpu_torch.ops.doppler_search import doppler_energy, doppler_estimate

    return {"doppler_energy": doppler_energy, "mf_bank_colreduce": mf_bank_colreduce,
            "timing_band": timing_band, "symbol_detect": symbol_detect,
            "doppler_estimate": doppler_estimate, "threshold_input": threshold_input}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
