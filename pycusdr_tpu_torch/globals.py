"""Global constants and small config helpers (the port's own copy of the
parts of ``pycusdr_tpu/globals.py`` the demodulation, Tx and runtime paths
need, the CC11xx protocol's ``json_str_list_to_int_list`` among them),
and ``torch_device``, the port's counterpart of
``apply_platform_override``.

Trust semantics (int8):
  normal bit        : +2 * voteWeight
  symbol error      : -1
  clipped RFI burst : -2
"""

import logging
import os

import numpy as np

LOG_NAME = "pycusdr_tpu_torch"
log = logging.getLogger(__name__)

#: environment variable naming the device the runtime's processes use:
#: unset means the card ("cuda"); "cpu" runs the plain PyTorch path
DEVICE_ENV = "PYCUSDR_TORCH_DEVICE"

SAVETX_DATA = False  # Tx: snapshot the last modulated waveform to .npy
STORE_BITS_IN_FILE = False  # Rx: dump demodulated bits (slow, debug only)

TRUSTTYPE = np.int8
DATATYPE = np.int8
MODULATORDTYPE = np.complex64

TRUST_NORMAL_SCALE = 2
TRUST_SYMBOL_ERROR = -1
TRUST_CLIPPED = -2


def printBytesAsHex(data) -> str:
    """'DE AD BE EF' style hex dump of an iterable of byte values."""
    return " ".join("{:02X}".format(int(b) & 0xFF) for b in data)


def attr_in_config(cfg: dict, attr: str, defaultVal, warningOnFail: bool = True):
    """Return ``cfg[attr]`` or ``defaultVal`` with an optional warning."""
    if attr in cfg:
        return cfg[attr]
    if warningOnFail:
        log.warning("'%s' not specified in config. Using default value of %s", attr, defaultVal)
    return defaultVal


def json_str_list_to_int_list(json_list, base: int = 16):
    """Convert a list of numeric strings (hex by default) to ints."""
    return [int(k, base) for k in json_list]


def torch_device():
    """The device the runtime runs on, from ``PYCUSDR_TORCH_DEVICE``: unset
    means the card, and raises when there is none; "cpu" must be asked
    for. Spawned children inherit the variable, so they read the same."""
    from pycusdr_tpu_torch.ops._lib import resolve_device

    return resolve_device(os.environ.get(DEVICE_ENV) or None)
