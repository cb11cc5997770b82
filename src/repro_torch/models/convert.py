"""Parameters of the reference package → the port's ``state_dict``.

``params_from_reference(cfg, tree)`` takes the reference's parameter pytree
with **numpy** leaves (layer-stacked along a leading axis, dense weights
stored ``(in, out)``) and returns a ``state_dict`` for
``transformer.Transformer``: one entry per layer, dense weights ``(out,
in)``.  With it both packages compute the same function of the same numbers.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they go through float32, which holds every
bf16 value exactly, and are cast back.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers


def _tensor(a: Any, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64, np.float16):
        a = a.astype(np.float32)  # ml_dtypes.bfloat16 -> f32 is exact
    # a copy: the tensors must not alias the (read-only) reference arrays
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(dtype)


def params_from_reference(cfg: ArchConfig, tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """-> ``state_dict`` (CPU tensors in ``cfg.param_dtype``); load it with
    ``model.load_state_dict``."""
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported yet")
    dtype = layers.to_dtype(cfg.param_dtype)
    sd: Dict[str, torch.Tensor] = {}
    sd["embed.weight"] = _tensor(tree["embed"]["w"], dtype)
    sd["final_ln.scale"] = _tensor(tree["final_ln"]["scale"], dtype)
    if not cfg.tie_embeddings:
        sd["head.weight"] = _tensor(tree["head"]["w"], dtype).T.contiguous()

    blocks = tree["blocks"]
    for i in range(cfg.n_layers):
        pre = f"blocks.{i}."
        sd[pre + "ln1.scale"] = _tensor(blocks["ln1"]["scale"][i], dtype)
        sd[pre + "ln2.scale"] = _tensor(blocks["ln2"]["scale"][i], dtype)
        for group, names in (("attn", ("wq", "wk", "wv", "wo")),
                             ("ffn", ("gate", "up", "down"))):
            for name in names:
                leaf = blocks[group][name]
                key = f"{pre}{group}.{name}."
                sd[key + "weight"] = _tensor(leaf["w"][i],
                                             dtype).T.contiguous()
                if "b" in leaf:
                    sd[key + "bias"] = _tensor(leaf["b"][i], dtype)
    return sd
