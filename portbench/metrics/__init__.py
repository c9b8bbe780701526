"""One reader a per-layer metric: ``read(r)`` returns its value or None."""
