"""The benchmark's machinery: cells and their data files, the traffic
generator, the entries into the measured program, the closed-loop window,
the trace, the frozen work model and the comparison that decides
``correct``."""
