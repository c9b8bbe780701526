"""Multiprocess-safe logging setup (a copy of
``pycusdr_tpu/utils/logger.py``).

Capability parity with ``pyCuSDR/multiprocessing_logger.py:11-67``:
console + optional file handler + a MemoryHandler that buffers and
flushes on ERROR. The external ``multiprocessing_logging`` package is
replaced with a QueueHandler/QueueListener pair from the stdlib, which
is the supported way to fan log records in from child processes.
"""

import logging
import logging.handlers
import multiprocessing
import sys
import time

from pycusdr_tpu_torch.globals import LOG_NAME

_FORMAT = "%(asctime)-16s %(processName)-12s %(name)-40s %(levelname)-8s %(message)s"

_listener = None
_log_queue = None


def logger_setup(fileName=None, logLevel=logging.INFO, memoryBufferSize: int = 20,
                 enable_queue: bool = True):
    """Configure the root framework logger. Returns the logger.

    ``-v`` verbosity counting in the CLI maps to logLevel upstream.
    """
    global _listener, _log_queue

    log = logging.getLogger(LOG_NAME)
    log.setLevel(logLevel)
    log.handlers.clear()

    logging.Formatter.converter = time.gmtime
    formatter = logging.Formatter(_FORMAT, "%Y-%m-%d %H:%M:%S")

    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(formatter)

    handlers = [console]
    if fileName:
        fileH = logging.FileHandler(fileName)
        fileH.setFormatter(formatter)
        # Buffer records in memory; flush the last N on ERROR so the file
        # keeps the context leading up to a failure.
        memH = logging.handlers.MemoryHandler(memoryBufferSize, flushLevel=logging.ERROR, target=fileH)
        handlers.append(memH)

    if enable_queue:
        # Multiprocess-safe: children log into a queue; a listener thread
        # in the parent writes to the real handlers.
        _log_queue = multiprocessing.Queue(-1)
        _listener = logging.handlers.QueueListener(_log_queue, *handlers, respect_handler_level=True)
        _listener.start()
        qh = logging.handlers.QueueHandler(_log_queue)
        log.addHandler(qh)
    else:
        for h in handlers:
            log.addHandler(h)

    return log


def child_logger_setup(logLevel=logging.INFO):
    """Call in a spawned child process to attach to the parent's queue."""
    log = logging.getLogger(LOG_NAME)
    log.setLevel(logLevel)
    if not log.handlers:
        console = logging.StreamHandler(sys.stdout)
        console.setFormatter(logging.Formatter(_FORMAT, "%Y-%m-%d %H:%M:%S"))
        log.addHandler(console)
    return log


def shutdown_logging():
    global _listener
    if _listener is not None:
        _listener.stop()
        _listener = None
