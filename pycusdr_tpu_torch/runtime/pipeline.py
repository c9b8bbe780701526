"""Shared scaffolding for pipelined (asynchronously in-flight) device
dispatch in the streaming processes (a copy of
``pycusdr_tpu/runtime/pipeline.py``).

CUDA launches are asynchronous: the block graph returns its result
tensor as soon as the copy and the kernels are queued on the stream.
The streaming runtimes exploit this by keeping up to ``depth - 1``
dispatched blocks in flight, so device compute and the dispatch/fetch
round trip overlap host post-processing and the wait for the next hop
of samples. Results are always collected in dispatch
order (the block-boundary healer is sequential host state).
"""

from collections import deque


class InflightPipeline:
    """Bounded FIFO of asynchronously dispatched device blocks.

    ``depth >= 2`` keeps ``depth - 1`` handles in flight; ``depth = 1``
    is synchronous (every push immediately emits — the reference's
    per-block semantics). Pipelining should only hold results while the
    sample feed actually has hops queued: callers drain via ``flush``
    whenever the feed goes idle, so a stalled-but-connected feed never
    holds demodulated results back for the feed-timeout window. The
    regime where pipelining wins — a backlogged feed — is exactly the
    regime where the queue stays full.
    """

    def __init__(self, depth, emit):
        self.depth = max(int(depth), 1)
        self._emit = emit
        self._q = deque()

    def __len__(self):
        return len(self._q)

    def push(self, *item):
        """Enqueue one dispatched block; emit down to depth-1 in flight."""
        self._q.append(item)
        while len(self._q) >= self.depth:
            self._emit(*self._q.popleft())

    def flush(self):
        """Emit everything in flight, in dispatch order."""
        while self._q:
            self._emit(*self._q.popleft())
