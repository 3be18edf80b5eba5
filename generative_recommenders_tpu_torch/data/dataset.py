"""Batch prefetching (own copy of `background_prefetch` from
`generative_recommenders_tpu/data/dataset.py`)."""

from __future__ import annotations

import queue
import threading


def background_prefetch(iterable, size: int = 8):
    """Runs any batch generator on a background thread with a bounded
    queue, so that host batch assembly overlaps the device steps. An error
    in the generator is raised again in the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    failed = []

    def _worker():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # re-raised in the consumer
            failed.append(e)
        finally:
            q.put(done)

    t = threading.Thread(target=_worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is done:
            if failed:
                raise failed[0]
            break
        yield item
