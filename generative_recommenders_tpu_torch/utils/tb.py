"""TensorBoard logging (own copy of `generative_recommenders_tpu/utils/
tb.py`): scalars through torch.utils.tensorboard when a log directory is
given. Unlike the JAX package's copy, a writer that cannot be built (no
`tensorboard` package) raises: a run asked to log does not go on without.
"""

from __future__ import annotations

import logging
from typing import Mapping, Optional

logger = logging.getLogger(__name__)


class SummaryLogger:
    def __init__(self, log_dir: Optional[str]) -> None:
        self._writer = None
        if log_dir:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=log_dir)
            logger.info("tensorboard -> %s", log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def scalars(self, metrics: Mapping[str, float], step: int, prefix: str = "") -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)) and k != "epoch":
                self.scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.flush()
            self._writer.close()
