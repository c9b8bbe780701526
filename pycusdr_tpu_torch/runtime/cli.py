"""Command-line entry point of the port, as the JAX package's
(``pycusdr_tpu/runtime/cli.py``; reference ``pyCuSDR/pyCuSDR.py:349-388``):

    python -m pycusdr_tpu_torch -c config.json [-v[vv]] [--device cpu]

The modem runs on the card; ``--device cpu`` (or
``PYCUSDR_TORCH_DEVICE=cpu``) asks for the plain PyTorch path on the CPU.
"""

import argparse
import os
import sys

from pycusdr_tpu_torch import __version__
from pycusdr_tpu_torch.globals import DEVICE_ENV


def build_argparser():
    p = argparse.ArgumentParser(
        prog="pycusdr_tpu_torch",
        description="Software-defined-radio modem for satellite ground stations "
                    "(PyTorch / CUDA)",
    )
    p.add_argument("-c", "--configFile", required=True, help="modular JSON config file")
    p.add_argument("-v", action="count", default=0, dest="v",
                   help="increase verbosity (-v, -vv, -vvv)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help=f"where to run (default: ${DEVICE_ENV}, else cuda)")
    p.add_argument("-V", "--version", action="version", version=__version__)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.device is not None:
        os.environ[DEVICE_ENV] = args.device  # inherited by the spawned children
    from pycusdr_tpu_torch.runtime.orchestrator import PyCuSDR

    sdr = PyCuSDR(args.configFile, args)
    sdr.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
