"""Frozen research experiment presets (port of
`generative_recommenders_tpu/configs/research.py`): the hyperparameters
behind the public metric tables. Each preset is a complete `TrainConfig`.
The SASRec presets build their config; constructing their model raises,
since SASRec is not ported yet.
"""

from __future__ import annotations

from typing import Dict

from generative_recommenders_tpu_torch.models.sequential import ModelConfig
from generative_recommenders_tpu_torch.train.train_loop import TrainConfig

_DATASET_NUM_ITEMS = {
    # the largest item id of each preprocessed dataset
    "ml-1m": 3952,
    "ml-20m": 131262,
    "amzn-books": 695762,
    "ml-3b": 26743 * 32,
}


def _mk(
    dataset: str,
    main_module: str,
    *,
    seq_len: int,
    dim: int,
    blocks: int,
    heads: int,
    dqk: int = 0,
    dv: int = 0,
    ffn_hidden: int = 0,
    negatives: int = 128,
    batch: int = 128,
    epochs: int = 101,
) -> TrainConfig:
    return TrainConfig(
        model=ModelConfig(
            main_module=main_module,
            num_items=_DATASET_NUM_ITEMS[dataset],
            max_sequence_len=seq_len,
            gr_output_length=10,
            item_embedding_dim=dim,
            num_blocks=blocks,
            num_heads=heads,
            dqk=dqk or dim,
            dv=dv or dim,
            linear_dropout_rate=0.2,
            dropout_rate=0.2,
            user_embedding_norm="l2_norm",
            ffn_hidden_dim=ffn_hidden or dim,
            ffn_activation_fn="relu",
            attn_kernel="auto",  # the JAX package's choice; the port does not read it
        ),
        local_batch_size=batch,
        eval_batch_size=batch,
        num_epochs=epochs,
        learning_rate=1e-3,
        weight_decay=0.0,
        num_warmup_steps=0,
        sampling_strategy="local",
        loss_module="SampledSoftmaxLoss",
        num_negatives=negatives,
        temperature=0.05,
        item_l2_norm=True,
        l2_norm_eps=1e-6,
    )


RESEARCH_PRESETS: Dict[str, TrainConfig] = {
    "ml-1m/sasrec-sampled-softmax-n128": _mk(
        "ml-1m", "SASRec", seq_len=200, dim=50, blocks=2, heads=1, ffn_hidden=50,
    ),
    "ml-1m/hstu-sampled-softmax-n128": _mk(
        "ml-1m", "HSTU", seq_len=200, dim=50, blocks=2, heads=1, dqk=50, dv=50,
    ),
    "ml-1m/hstu-sampled-softmax-n128-large": _mk(
        "ml-1m", "HSTU", seq_len=200, dim=50, blocks=8, heads=2, dqk=25, dv=25,
    ),
    "ml-20m/sasrec-sampled-softmax-n128": _mk(
        "ml-20m", "SASRec", seq_len=200, dim=256, blocks=4, heads=4, ffn_hidden=256,
    ),
    "ml-20m/hstu-sampled-softmax-n128": _mk(
        "ml-20m", "HSTU", seq_len=200, dim=256, blocks=8, heads=2, dqk=32, dv=32,
    ),
    "ml-20m/hstu-sampled-softmax-n128-large": _mk(
        "ml-20m", "HSTU", seq_len=200, dim=256, blocks=16, heads=8, dqk=32, dv=32,
    ),
    "amzn-books/sasrec-sampled-softmax-n512": _mk(
        "amzn-books", "SASRec", seq_len=50, dim=64, blocks=4, heads=4,
        ffn_hidden=64, negatives=512, epochs=201,
    ),
    "amzn-books/hstu-sampled-softmax-n512": _mk(
        "amzn-books", "HSTU", seq_len=50, dim=64, blocks=4, heads=4,
        dqk=16, dv=16, negatives=512, epochs=201,
    ),
    "amzn-books/hstu-sampled-softmax-n512-large": _mk(
        "amzn-books", "HSTU", seq_len=50, dim=64, blocks=16, heads=8,
        dqk=8, dv=8, negatives=512, epochs=201,
    ),
    "ml-3b/hstu-sampled-softmax-n96-seqlen500-large": _mk(
        "ml-3b", "HSTU", seq_len=500, dim=256, blocks=16, heads=8,
        dqk=32, dv=32, negatives=128, batch=96, epochs=100,
    ),
}
