"""Download and preprocess a public dataset into its `sasrec_format.csv`
(port of `generative_recommenders_tpu/cli/preprocess_public_data.py`):

    python -m generative_recommenders_tpu_torch.cli.preprocess_public_data \\
        --dataset_name ml-1m [--data_root tmp]

The archive is fetched only when it is not already at its registry path
(`data/preprocessor.py:get_common_preprocessors`).
"""

from __future__ import annotations

import argparse
import logging
from typing import List, Optional

from generative_recommenders_tpu_torch.data.preprocessor import get_common_preprocessors


def main(argv: Optional[List[str]] = None) -> Optional[int]:
    """Returns the number of distinct items the processor wrote (None for the
    synthetic corpora, which the fractal expansion writes)."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_name", required=True, choices=sorted(get_common_preprocessors()))
    p.add_argument("--data_root", default="tmp")
    args = p.parse_args(argv)
    return get_common_preprocessors(args.data_root)[args.dataset_name].preprocess_rating()


if __name__ == "__main__":
    main()
