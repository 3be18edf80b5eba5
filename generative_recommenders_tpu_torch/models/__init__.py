"""The research stack's sequential retrieval models (port of
`generative_recommenders_tpu/models/`): item embeddings, the input
preprocessor, the HSTU and SASRec encoders, output postprocessors, similarity, losses and
negatives samplers."""
