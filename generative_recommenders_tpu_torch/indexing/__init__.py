"""Retrieval over the item corpus (port of `generative_recommenders_tpu/indexing/`)."""
