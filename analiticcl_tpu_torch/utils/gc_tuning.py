"""CPython GC tuning for steady-state query serving.

The port's copy of ``analiticcl_tpu/utils/gc_tuning.py``.

A built model holds hundreds of thousands of long-lived Python objects
(decoder entries, encoder strings). CPython's generational GC rescans ALL
tracked objects on every gen-2 collection, so with a large vocabulary each
such collection is a long pause, and it recurs every few query batches.
Freezing the heap after build moves those objects to the permanent
generation, which the collector no longer scans: gen-2 pauses shrink to the
objects made since, and batch times become uniform.

This is application-level tuning (the CLI calls it after its model is built,
and ``gc.unfreeze()`` when it returns); the library never mutates GC state
behind an embedding application's back.
"""

from __future__ import annotations

import gc


def prewarm_heap(nbytes: int = 512 * 1024 * 1024) -> None:
    """Touch ``nbytes`` of fresh memory once, then release it to the
    allocator.

    On lazily-provisioned VMs (Firecracker-style backing), the FIRST touch
    of new guest memory is much slower than re-use of freed pages.
    Pre-warming before a timed build (or before serving) moves that one-off
    provisioning cost out of the hot path. Memory is freed immediately —
    only the allocator's warm arena remains."""
    import numpy as np

    block = np.empty(nbytes, dtype=np.uint8)
    block[::4096] = 1  # one write per page faults it in
    del block


def freeze_model_heap() -> int:
    """Collect garbage, then freeze all surviving objects into the permanent
    generation. Call once after models are loaded and built. Returns the
    number of frozen objects."""
    gc.collect()
    gc.freeze()
    return gc.get_freeze_count()

