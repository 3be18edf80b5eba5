"""Per-dataset DlrmHSTU presets (port of
`generative_recommenders_tpu/configs/dlrm.py`, kept as data): debug /
movielens-1m / movielens-20m / kuairand-1k feature wiring, multitask tasks
and embedding tables, with the training values (dropout rates, multitask
loss weight). Only the random `debug` dataset is served and trained by this
port; the real-dataset loaders are still to port.
"""

from __future__ import annotations

from typing import Tuple

from generative_recommenders_tpu_torch.modules.dlrm_hstu import (
    DlrmHSTUConfig,
    EmbeddingTableConfig,
)
from generative_recommenders_tpu_torch.modules.multitask_module import (
    MultitaskTaskType,
    TaskConfig,
)

KUAIRAND_TASKS: Tuple[TaskConfig, ...] = tuple(
    TaskConfig(name, 1 << i, MultitaskTaskType.BINARY_CLASSIFICATION)
    for i, name in enumerate(
        [
            "is_click", "is_like", "is_follow", "is_comment",
            "is_forward", "is_hate", "long_view", "is_profile_enter",
        ]
    )
)


def get_hstu_configs(
    dataset: str = "debug",
    max_uih_len: int = 256,
    max_num_candidates: int = 10,
) -> DlrmHSTUConfig:
    base = dict(
        max_uih_len=max_uih_len,
        max_num_candidates=max_num_candidates,
        hstu_num_heads=4,
        hstu_attn_linear_dim=128,
        hstu_attn_qk_dim=128,
        hstu_attn_num_layers=3,
        hstu_embedding_table_dim=256,
        hstu_transducer_embedding_dim=512,
        hstu_group_norm=True,
        hstu_input_dropout_ratio=0.2,
        hstu_linear_dropout_rate=0.1,
        causal_multitask_weights=0.2,
    )
    if "movielens" in dataset:
        small = dataset == "movielens-1m"
        user_feats = (
            ("movie_id", "user_id", "sex", "age_group", "occupation", "zip_code")
            if small
            else ("movie_id", "user_id")
        )
        ctx = tuple((f, 1) for f in user_feats if f not in ("movie_id",))
        return DlrmHSTUConfig(
            **base,
            user_embedding_feature_names=user_feats,
            item_embedding_feature_names=("item_movie_id",),
            uih_post_id_feature_name="movie_id",
            uih_action_time_feature_name="action_timestamp",
            candidates_querytime_feature_name="item_query_time",
            candidates_weight_feature_name="item_dummy_weights",
            candidates_watchtime_feature_name="item_dummy_watchtime",
            contextual_feature_to_max_length=ctx,
            contextual_feature_to_min_uih_length=(),
            merge_uih_candidate_feature_mapping=(
                ("movie_id", "item_movie_id"),
                ("action_timestamp", "item_query_time"),
                ("dummy_weights", "item_dummy_weights"),
                ("dummy_watch_time", "item_dummy_watchtime"),
            ),
            multitask_configs=(
                TaskConfig(
                    "rating", 1, MultitaskTaskType.REGRESSION
                ),
            ),
        )
    if "kuairand" in dataset:
        return DlrmHSTUConfig(
            **base,
            user_embedding_feature_names=(
                "video_id", "user_id", "user_active_degree",
                "follow_user_num_range", "fans_user_num_range",
                "friend_user_num_range", "register_days_range",
            ),
            item_embedding_feature_names=("item_video_id",),
            uih_post_id_feature_name="video_id",
            uih_action_time_feature_name="action_timestamp",
            uih_weight_feature_name="action_weight",
            candidates_querytime_feature_name="item_query_time",
            candidates_weight_feature_name="item_action_weight",
            candidates_watchtime_feature_name="item_target_watchtime",
            contextual_feature_to_max_length=(
                ("user_id", 1),
                ("user_active_degree", 1),
                ("follow_user_num_range", 1),
                ("fans_user_num_range", 1),
                ("friend_user_num_range", 1),
                ("register_days_range", 1),
            ),
            contextual_feature_to_min_uih_length=(),
            merge_uih_candidate_feature_mapping=(
                ("video_id", "item_video_id"),
                ("action_timestamp", "item_query_time"),
                ("action_weight", "item_action_weight"),
                ("watch_time", "item_target_watchtime"),
            ),
            multitask_configs=KUAIRAND_TASKS,
            action_weights=(1, 2, 4, 8, 16, 32, 64, 128),
        )
    # debug (random data)
    return DlrmHSTUConfig(
        **base,
        user_embedding_feature_names=(
            "uih_post_id", "uih_owner_id", "viewer_id", "dummy_contexual",
        ),
        item_embedding_feature_names=("item_post_id", "item_owner_id"),
        uih_post_id_feature_name="uih_post_id",
        uih_action_time_feature_name="uih_action_time",
        uih_weight_feature_name="uih_weight",
        candidates_querytime_feature_name="item_query_time",
        candidates_weight_feature_name="item_action_weight",
        candidates_watchtime_feature_name="item_target_watchtime",
        contextual_feature_to_max_length=(
            ("viewer_id", 1),
            ("dummy_contexual", 1),
        ),
        contextual_feature_to_min_uih_length=(
            ("viewer_id", 128),
            ("dummy_contexual", 128),
        ),
        merge_uih_candidate_feature_mapping=(
            ("uih_post_id", "item_post_id"),
            ("uih_owner_id", "item_owner_id"),
            ("uih_action_time", "item_query_time"),
            ("uih_weight", "item_action_weight"),
            ("uih_watchtime", "item_target_watchtime"),
        ),
        multitask_configs=(
            TaskConfig("vvp100", 1, MultitaskTaskType.BINARY_CLASSIFICATION),
        ),
        action_weights=(1, 2, 4, 8),
    )


def get_embedding_table_config(
    dataset: str = "debug",
    hash_size: int = 10_000_000,
    dim: int = 256,
) -> Tuple[EmbeddingTableConfig, ...]:
    """Embedding tables of the preset (10M-row tables by default)."""
    if "movielens" in dataset:
        small = dataset == "movielens-1m"
        names = (
            ["movie_id", "user_id", "sex", "age_group", "occupation", "zip_code"]
            if small
            else ["movie_id", "user_id"]
        )
        tables = []
        for n in names:
            feats = (n, "item_movie_id") if n == "movie_id" else (n,)
            tables.append(
                EmbeddingTableConfig(n, hash_size, dim, feats)
            )
        return tuple(tables)
    if "kuairand" in dataset:
        return (
            EmbeddingTableConfig(
                "video_id", hash_size, dim, ("video_id", "item_video_id")
            ),
            EmbeddingTableConfig("user_id", hash_size, dim, ("user_id",)),
            EmbeddingTableConfig(
                "user_active_degree", hash_size, dim, ("user_active_degree",)
            ),
            EmbeddingTableConfig(
                "follow_user_num_range", hash_size, dim,
                ("follow_user_num_range",),
            ),
            EmbeddingTableConfig(
                "fans_user_num_range", hash_size, dim, ("fans_user_num_range",)
            ),
            EmbeddingTableConfig(
                "friend_user_num_range", hash_size, dim,
                ("friend_user_num_range",),
            ),
            EmbeddingTableConfig(
                "register_days_range", hash_size, dim,
                ("register_days_range",),
            ),
        )
    return (
        EmbeddingTableConfig(
            "post_id", hash_size, dim, ("uih_post_id", "item_post_id")
        ),
        EmbeddingTableConfig(
            "owner_id", hash_size, dim, ("uih_owner_id", "item_owner_id")
        ),
        EmbeddingTableConfig("viewer_id", hash_size, dim, ("viewer_id",)),
        EmbeddingTableConfig(
            "dummy_contexual", hash_size, dim, ("dummy_contexual",)
        ),
    )
