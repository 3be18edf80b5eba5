"""Carries the JAX package's parameters into the port.

The port's modules keep the JAX names and layouts, so a flax parameter tree
maps onto a ``state_dict`` by flattening its path with dots:

* dense kernels stay [in, out] (the port's `Dense` computes ``x @ kernel``,
  where a ``torch.nn.Linear`` weight would be [out, in]);
* ``STULayer.uvqk_weight`` stays [D, (2h + 2a) * H], split u, v, q, k after
  the product, and ``output_weight`` stays [3 * h * H, D];
* the tables stay ``embedding_tables_<name>``;
* ``batched_contextual_linear_weights`` stays [C, Din, Dout].

The research model (`models/sequential.py:SequentialRecommender`) needs no
renaming: ``embedding_module/item_emb``, ``input_preproc/pos_emb`` and
``encoder/layer_i/{uvqk, o/kernel, o/bias, rel_attn_bias/{pos_w, ts_w}}``
are the port's own names, with ``uvqk`` [D, (2 dv + 2 dqk) * H] split u, v,
q, k and ``o/kernel`` [in, out]. Its SASRec encoder neither:
``encoder/attn_i/{in_proj_weight, in_proj_bias, out_proj_weight,
out_proj_bias}`` keep torch's [3D, D] and [D, D] (used as ``x @ w.T``) and
``encoder/ffn_i/{conv1, conv2}/{kernel, bias}`` are dense layers [in, out].
Its MoL similarity neither: ``mol/{query_proj, item_proj}/glu/{w, b}``
([in, 2 out], split lhs / rhs) and ``.../out/{kernel, bias}``,
``mol/{gating_query, gating_item, gating_qi}/{fc1, fc2}/{kernel, bias}``
(no ``fc2/bias`` in the query and item gates) and
``mol/uid_embeddings_<i>`` [hash + 1, d] are the port's names and layouts.
The rated preprocessors (``pos_emb``, ``rating_emb``) and
`CategoricalEmbeddingModule` (``item_emb``; its id-to-category map is not a
parameter on either side) need none either.

The renamings: in `DlrmHSTU`, the flax tree holds the transducer's parts
at the top (``stu``, ``preprocessor``, ``positional_encoder``,
``postprocessor``); the port nests them under ``hstu_transducer`` with the
transducer's own attribute names. The research model trained without
timestamps holds its position-only bias as ``rel_attn_bias/w``, the port's
``rel_attn_bias.pos_w`` (the port's time table ``ts_w`` has no counterpart
in such a tree).

The dynamic STU wrappers need none: `STUStack` creates its layers in
``setup`` under their names, so flax binds them to the stack and a wrapped
stack's paths are ``stu/layer_i/...`` as without wrappers; a wrapper built
around a layer of its own (``L2STU(STULayer(...))``) adopts it as ``stu``,
the port's attribute name.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_DLRM_PREFIXES = {
    "stu": "hstu_transducer.stu_module",
    "preprocessor": "hstu_transducer.input_preprocessor",
    "positional_encoder": "hstu_transducer.positional_encoder",
    "postprocessor": "hstu_transducer.output_postprocessor",
}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, name))
        else:
            flat[name] = value
    return flat


def params_from_flax(flax_params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (nested dicts of numpy arrays, with or without
    the top-level ``"params"`` collection) -> the port's ``state_dict``."""
    if "params" in flax_params:
        flax_params = flax_params["params"]
    # a DlrmHSTU tree, not one of its parts (a wrapper's layer is "stu" too)
    is_dlrm = "stu" in flax_params and any(str(k).startswith("embedding_tables_") for k in flax_params)
    state: Dict[str, torch.Tensor] = {}
    for name, value in _flatten(flax_params).items():
        head, _, rest = name.partition(".")
        if is_dlrm and head in _DLRM_PREFIXES:
            name = f"{_DLRM_PREFIXES[head]}.{rest}"
        if name.endswith("rel_attn_bias.w"):
            name = name[: -len("w")] + "pos_w"
        state[name] = torch.from_numpy(np.array(value, copy=True))
    return state
