"""Parameters of the reference package → the port's ``state_dict``.

``params_from_reference(cfg, tree)`` takes the reference's parameter pytree
with **numpy** leaves (layer-stacked along a leading axis, dense weights
stored ``(in, out)``) and returns a ``state_dict`` for
``transformer.Transformer``: one entry per layer, dense weights ``(out,
in)``.  With it both packages compute the same function of the same numbers.

Every family.  The SSM mixer's ``conv_w`` keeps the reference's ``(d_conv,
conv_dim)`` layout; its ``A_log``, ``D`` and ``dt_bias`` stay f32 whatever
``param_dtype`` is, as in the reference.  The hybrid's shared attention+MLP
block is not stacked in the reference either.  The MoE's router and experts
keep the reference's layout (``models/moe.py``); the audio family's
multi-codebook embedding ``(n_codebooks, V, d)`` is copied and its heads
``(n_heads, d, V)`` become ``(n_heads, V, d)``.

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they go through float32, which holds every
bf16 value exactly, and are cast back.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers

#: parameters of the SSM mixer that the reference keeps in f32
SSM_F32 = ("A_log", "D", "dt_bias")


def _tensor(a: Any, dtype: torch.dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in (np.float32, np.float64, np.float16):
        a = a.astype(np.float32)  # ml_dtypes.bfloat16 -> f32 is exact
    # a copy: the tensors must not alias the (read-only) reference arrays
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(dtype)


def _dense_block(sd: Dict[str, torch.Tensor], pre: str,
                 blk: Mapping[str, Any], take: Callable, dtype) -> None:
    """ln1, attn, ln2, and ffn or moe of one attention+MLP block."""
    sd[pre + "ln1.scale"] = _tensor(take(blk["ln1"]["scale"]), dtype)
    sd[pre + "ln2.scale"] = _tensor(take(blk["ln2"]["scale"]), dtype)
    groups = [("attn", ("wq", "wk", "wv", "wo"))]
    if "moe" in blk:
        for name in ("router", "gate", "up", "down"):
            sd[f"{pre}moe.{name}"] = _tensor(take(blk["moe"][name]), dtype)
    else:
        groups.append(("ffn", ("gate", "up", "down")))
    for group, names in groups:
        for name in names:
            leaf = blk[group][name]
            key = f"{pre}{group}.{name}."
            sd[key + "weight"] = _tensor(take(leaf["w"]), dtype).T.contiguous()
            if "b" in leaf:
                sd[key + "bias"] = _tensor(take(leaf["b"]), dtype)


def _ssm_block(sd: Dict[str, torch.Tensor], pre: str,
               blk: Mapping[str, Any], take: Callable, dtype) -> None:
    """ln and the Mamba2 mixer of one SSM block."""
    sd[pre + "ln.scale"] = _tensor(take(blk["ln"]["scale"]), dtype)
    m = blk["mixer"]
    for name in ("in_proj", "out_proj"):
        sd[f"{pre}mixer.{name}.weight"] = \
            _tensor(take(m[name]["w"]), dtype).T.contiguous()
    for name in ("conv_w", "conv_b", "norm"):
        sd[f"{pre}mixer.{name}"] = _tensor(take(m[name]), dtype)
    for name in SSM_F32:
        sd[f"{pre}mixer.{name}"] = _tensor(take(m[name]), torch.float32)


def params_from_reference(cfg: ArchConfig, tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """-> ``state_dict`` (CPU tensors in ``cfg.param_dtype``, the SSM's
    ``A_log``/``D``/``dt_bias`` in f32); load it with
    ``model.load_state_dict``."""
    dtype = layers.to_dtype(cfg.param_dtype)
    sd: Dict[str, torch.Tensor] = {}
    sd["embed.weight"] = _tensor(tree["embed"]["w"], dtype)
    sd["final_ln.scale"] = _tensor(tree["final_ln"]["scale"], dtype)
    if not cfg.tie_embeddings:
        # (d, V) -> (V, d); (n_heads, d, V) -> (n_heads, V, d)
        sd["head.weight"] = _tensor(tree["head"]["w"], dtype) \
            .transpose(-1, -2).contiguous()

    block = _ssm_block if cfg.family in ("ssm", "hybrid") else _dense_block
    for i in range(cfg.n_layers):
        block(sd, f"blocks.{i}.", tree["blocks"], lambda a, i=i: a[i], dtype)
    if cfg.family == "hybrid":
        _dense_block(sd, "shared.", tree["shared"], lambda a: a, dtype)
    return sd
