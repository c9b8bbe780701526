"""Observability: per-worker stats ring buffers (``visualizer``) and the
post-pass analytics written at shutdown (``stats``)."""
