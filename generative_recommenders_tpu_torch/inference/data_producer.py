"""Query runners feeding the serving harness (the port's own copy of
`generative_recommenders_tpu/inference/data_producer.py`): inline, or N
worker threads pulling from a queue."""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable


class SingleThreadDataProducer:
    """Synchronous: run the prediction inline on enqueue."""

    def __init__(self, predict_fn: Callable[[Any], Any]) -> None:
        self._predict = predict_fn

    def enqueue(self, query_id: int, sample: Any, on_done) -> None:
        on_done(query_id, self._predict(sample))

    def shutdown(self) -> None:
        pass


class MultiThreadDataProducer:
    """N worker threads pulling from a queue."""

    def __init__(
        self, predict_fn: Callable[[Any], Any], num_threads: int = 2
    ) -> None:
        self._predict = predict_fn
        self._q: "queue.Queue" = queue.Queue()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True)
            for _ in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            query_id, sample, on_done = item
            on_done(query_id, self._predict(sample))

    def enqueue(self, query_id: int, sample: Any, on_done) -> None:
        self._q.put((query_id, sample, on_done))

    def shutdown(self) -> None:
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join()
