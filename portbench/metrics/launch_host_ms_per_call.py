"""Median per call of the host ms the program's ``launch`` spans (its calls into
the kernel library) take inside its ``graph`` span
(``obs/profiling.py``'s ``summary()``), over the traced segments, where
the spans record. None where the program has no spans or recorded none."""


def read(r):
    try:
        from pycusdr_tpu_torch.obs import profiling

        return profiling.summary()["graph"]["launch_ms_per_call_p50"]
    except (ImportError, AttributeError, KeyError):
        return None
