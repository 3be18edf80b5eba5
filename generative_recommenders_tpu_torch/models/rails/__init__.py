"""RAILS, retrieval with learned similarities: the Mixture-of-Logits
similarity (port of `generative_recommenders_tpu/models/rails/`)."""

from generative_recommenders_tpu_torch.models.rails.layers import GeGLU, SwiGLU
from generative_recommenders_tpu_torch.models.rails.mol import (
    MoLConfig,
    MoLSimilarity,
    load_balancing_mi_loss,
    softmax_dropout_combiner,
)

__all__ = [
    "GeGLU",
    "SwiGLU",
    "MoLConfig",
    "MoLSimilarity",
    "load_balancing_mi_loss",
    "softmax_dropout_combiner",
]
