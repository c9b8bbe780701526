"""Post-pass analytics: pickle dump + per-worker PDF plots + npz export
(a copy of ``pycusdr_tpu/obs/stats.py``).

Capability parity with ``pyCuSDR/stats.py:30-198``: one pickle of all
worker stats, then per worker a 3-panel PDF (rangerate colored by vote
count, sync-signals/s + packet outcomes, SNR) and an npz with the raw
series. Written at shutdown from the decoder's VisualizerData dicts.
"""

import logging
import os
import pickle
import time

import numpy as np
import scipy.constants

log = logging.getLogger(__name__)


def safeGet(key, dataCont):
    if key in dataCont:
        return np.array(dataCont[key])
    log.warning("Key %s not found for worker %s", key, dataCont.get("workerId"))
    return np.array([])


def processData(conf, data, startTime=0, log_folder=None):
    """Dump everything + plot each worker. Returns list of save paths."""
    if log_folder is None:
        log_folder = conf.get("Main", {}).get("statsFolder", "stats_out")
    os.makedirs(log_folder, exist_ok=True)
    stamp = time.strftime("%Y_%m_%d_%H_%M_", time.gmtime(startTime))

    dataName = os.path.join(log_folder, f"{stamp}stat_data.dat")
    with open(dataName, "wb") as f:
        pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)

    saveMsg = [dataName]
    for d in data:
        saveMsg.append(processWorkerData(conf, d, startTime, log_folder))
    return saveMsg


def _radio_conf_for(conf, workerId):
    for key, radioConf in conf["Radios"]["Rx"].items():
        if key.split("-")[0] in str(workerId) or radioConf.get("name", "") in str(workerId):
            return radioConf
    return None


def processWorkerData(conf, dataCont, startTime=0, log_folder="stats_out"):
    workerId = dataCont.get("workerId", "unknown")
    doppler = safeGet("doppler", dataCont)
    timestamp = safeGet("timestamp", dataCont)
    spSymEst = safeGet("spSymEst", dataCont)
    SNR = safeGet("SNR", dataCont)
    numSyncSig = safeGet("numSyncSig", dataCont)
    packetSuc = safeGet("packetSuc", dataCont)
    packetFail = safeGet("packetFail", dataCont)
    numSlaves = safeGet("numSlaves", dataCont).astype(int) if len(
        safeGet("numSlaves", dataCont)) else np.array([], int)

    radioConf = _radio_conf_for(conf, workerId)
    Fc = radioConf["frequency_Hz"] if radioConf else 1e8
    if radioConf is None:
        log.warning("No Rx frequency found for %s -- using %s", workerId, Fc)

    rangerate = -doppler / Fc * scipy.constants.speed_of_light if len(doppler) else doppler
    t = timestamp - timestamp[0] if len(timestamp) else timestamp

    stamp = time.strftime("%Y_%m_%d_%H_%M_", time.gmtime(startTime))
    base = os.path.join(log_folder, f"{stamp}{workerId}")

    np.savez(
        base + "_stats.npz",
        timestamp=timestamp, doppler=doppler, rangerate=rangerate,
        spSymEst=spSymEst, SNR=SNR, numSyncSig=numSyncSig,
        packetSuc=packetSuc, packetFail=packetFail, numSlaves=numSlaves,
    )

    try:
        import matplotlib

        matplotlib.use("pdf")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 1, figsize=(10, 10), sharex=True)
        if len(t):
            if len(numSlaves) == len(t):
                sc = axes[0].scatter(t, rangerate, c=numSlaves, s=8, cmap="viridis")
                fig.colorbar(sc, ax=axes[0], label="votes")
            else:
                axes[0].plot(t, rangerate, ".", ms=3)
            axes[0].set_ylabel("rangerate [m/s]")

            axes[1].plot(t, numSyncSig, ".", ms=3, label="sync sigs/s")
            if len(packetSuc) == len(t):
                axes[1].plot(t, packetSuc, "g^", ms=4, label="packets ok")
            if len(packetFail) == len(t):
                axes[1].plot(t, packetFail, "rv", ms=4, label="packets failed")
            axes[1].legend(loc="best")
            axes[1].set_ylabel("sync / packets")

            axes[2].plot(t, SNR, ".", ms=3)
            axes[2].set_ylabel("SNR [dB]")
            axes[2].set_xlabel("time [s]")
        fig.suptitle(f"pass stats: {workerId}")
        fig.savefig(base + "_stats.pdf", bbox_inches="tight", format="pdf")
        plt.close(fig)
    except Exception as e:
        log.error("plotting failed for %s: %s", workerId, e)

    return base
