"""Across-channel device ops: the channel group's diversity vote (K8)."""
