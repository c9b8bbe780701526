"""Median host ms of the program's ``download.wait`` span, the wait for a call's
rows in pinned host memory
(``obs/profiling.py``'s ``summary()``), over the traced segments, where
the spans record. None where the program has no spans or recorded none."""


def read(r):
    try:
        from pycusdr_tpu_torch.obs import profiling

        return profiling.summary()["download.wait"]["host_ms_p50"]
    except (ImportError, AttributeError, KeyError):
        return None
