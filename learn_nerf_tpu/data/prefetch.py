"""Async host→device input prefetch for the training hot loop.

``jax.device_put`` (and the multi-process
``make_array_from_process_local_data`` used by ``TrainLoop.shard_batch``)
only *enqueues* a transfer; keeping ``depth`` batches in flight overlaps
the upload of batch ``i+1`` with the compute of step ``i``, hiding the
input-transfer latency behind the step.

The reference has no input pipeline at all — its jitted step blocks on the
host batch transfer every step (``learn_nerf/scripts/train_nerf.py:117-127``).
"""

from collections import deque
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def prefetch_to_device(
    iterator: Iterable[T], place: Callable[[T], U], depth: int = 2
) -> Iterator[U]:
    """Yield ``place(item)`` with ``depth`` placements dispatched ahead.

    :param iterator: host-side item source (e.g. ``iterate_batches``).
    :param place: async placement fn (e.g. ``TrainLoop.shard_batch``).
    :param depth: in-flight transfers; 2 = double buffering.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    buf = deque()
    for item in iterator:
        buf.append(place(item))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
