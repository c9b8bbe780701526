"""Device ops of the port and the hand-written kernels behind them: the
demodulation path (K1 ``doppler_energy``, K2 ``mf_bank_colreduce``, K3
``timing_band``, K4 ``symbol_detect`` (with K4n in the same launch,
``symbol_detect_nrzs``, on the NRZ-S block graph), K5
``doppler_estimate``, K6 ``threshold_input``), the generic channel x
dopp step's split detector (K4l ``symbol_detect_local``, K4s
``shard_select``, with K4n in the same launch, ``shard_select_nrzs``, on
an NRZ-S protocol), the decoder's Viterbi
trellis (K7 ``viterbi``), the channel group's vote (K8 ``vote``,
``parallel/vote.py``) and the wideband channelizer (K9 ``channelize``,
``parallel/channelizer.py``)."""


def kernel_wrappers() -> dict:
    """name -> wrapper of every hand-written kernel; each wrapper counts
    its kernel launches in ``.launches``."""
    from pycusdr_tpu_torch.ops.demod_kernels import (
        mf_bank_colreduce,
        shard_select,
        shard_select_nrzs,
        symbol_detect,
        symbol_detect_local,
        symbol_detect_nrzs,
        threshold_input,
        timing_band,
    )
    from pycusdr_tpu_torch.ops.doppler_search import doppler_energy, doppler_estimate
    from pycusdr_tpu_torch.ops.viterbi import viterbi_sweep
    from pycusdr_tpu_torch.parallel.channelizer import channelize, channelize_wide
    from pycusdr_tpu_torch.parallel.vote import vote_rows

    return {"doppler_energy": doppler_energy, "mf_bank_colreduce": mf_bank_colreduce,
            "timing_band": timing_band, "symbol_detect": symbol_detect,
            "symbol_detect_nrzs": symbol_detect_nrzs,
            "doppler_estimate": doppler_estimate, "threshold_input": threshold_input,
            "viterbi": viterbi_sweep, "vote": vote_rows,
            "channelize": channelize, "channelize_wide": channelize_wide,
            "symbol_detect_local": symbol_detect_local,
            "shard_select": shard_select, "shard_select_nrzs": shard_select_nrzs}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
