"""Median device ms of the program's ``graph`` span, from its first to its last
event on the stream
(``obs/profiling.py``'s ``summary()``), over the traced segments, where
the spans record. None where the program has no spans or recorded none."""


def read(r):
    try:
        from pycusdr_tpu_torch.obs import profiling

        return profiling.summary()["graph"]["device_ms_p50"]
    except (ImportError, AttributeError, KeyError):
        return None
