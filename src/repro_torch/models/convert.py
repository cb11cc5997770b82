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
``(n_heads, d, V)`` become ``(n_heads, V, d)``.  ``axes_from_reference``
lays the reference's logical-axes tree out by the same rules.

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


def _dense_block(sd: Dict[str, Any], pre: str, blk: Mapping[str, Any],
                 take: Callable, flip: Callable) -> None:
    """ln1, attn, ln2, and ffn or moe of one attention+MLP block."""
    sd[pre + "ln1.scale"] = take(blk["ln1"]["scale"])
    sd[pre + "ln2.scale"] = take(blk["ln2"]["scale"])
    groups = [("attn", ("wq", "wk", "wv", "wo"))]
    if "moe" in blk:
        for name in ("router", "gate", "up", "down"):
            sd[f"{pre}moe.{name}"] = take(blk["moe"][name])
    else:
        groups.append(("ffn", ("gate", "up", "down")))
    for group, names in groups:
        for name in names:
            leaf = blk[group][name]
            key = f"{pre}{group}.{name}."
            sd[key + "weight"] = flip(take(leaf["w"]))
            if "b" in leaf:
                sd[key + "bias"] = take(leaf["b"])


def _ssm_block(sd: Dict[str, Any], pre: str, blk: Mapping[str, Any],
               take: Callable, flip: Callable) -> None:
    """ln and the Mamba2 mixer of one SSM block."""
    sd[pre + "ln.scale"] = take(blk["ln"]["scale"])
    m = blk["mixer"]
    for name in ("in_proj", "out_proj"):
        sd[f"{pre}mixer.{name}.weight"] = flip(take(m[name]["w"]))
    for name in ("conv_w", "conv_b", "norm"):
        sd[f"{pre}mixer.{name}"] = take(m[name])
    for name in SSM_F32:
        sd[f"{pre}mixer.{name}"] = take(m[name], f32=True)


def _convert(cfg: ArchConfig, tree: Mapping[str, Any], leaf: Callable,
             flip: Callable) -> Dict[str, Any]:
    """The layout rules: ``leaf(x, layer, f32)`` makes one entry of a leaf
    (``layer``: its index along the stacked axis, None for a leaf that is
    not stacked; ``f32``: a parameter the reference keeps in f32) and
    ``flip`` swaps its last two dimensions."""
    sd: Dict[str, Any] = {}
    top = lambda a, f32=False: leaf(a, None, f32)
    sd["embed.weight"] = top(tree["embed"]["w"])
    sd["final_ln.scale"] = top(tree["final_ln"]["scale"])
    if not cfg.tie_embeddings:
        # (d, V) -> (V, d); (n_heads, d, V) -> (n_heads, V, d)
        sd["head.weight"] = flip(top(tree["head"]["w"]))

    block = _ssm_block if cfg.family in ("ssm", "hybrid") else _dense_block
    for i in range(cfg.n_layers):
        block(sd, f"blocks.{i}.", tree["blocks"],
              lambda a, f32=False, i=i: leaf(a, i, f32), flip)
    if cfg.family == "hybrid":
        _dense_block(sd, "shared.", tree["shared"], top, flip)
    return sd


def params_from_reference(cfg: ArchConfig, tree: Mapping[str, Any]
                          ) -> Dict[str, torch.Tensor]:
    """-> ``state_dict`` (CPU tensors in ``cfg.param_dtype``, the SSM's
    ``A_log``/``D``/``dt_bias`` in f32); load it with
    ``model.load_state_dict``."""
    dtype = layers.to_dtype(cfg.param_dtype)

    def leaf(a, layer, f32):
        return _tensor(a if layer is None else a[layer],
                       torch.float32 if f32 else dtype)

    return _convert(cfg, tree, leaf,
                    lambda t: t.transpose(-1, -2).contiguous())


def axes_from_reference(cfg: ArchConfig, axes_tree: Mapping[str, Any]
                        ) -> Dict[str, tuple]:
    """The reference's logical-axes tree (``transformer.param_axes``), or
    any tree of per-dimension tuples of that layout (a tree of its
    ``PartitionSpec``s), laid out as the port's ``state_dict`` by the rules
    of ``params_from_reference``: the stacked ``layers`` axis dropped (the
    rules map ``layers`` to no mesh axis), the last two axes of the dense
    weights and the heads swapped."""
    def leaf(ax, layer, f32):
        return tuple(ax) if layer is None else tuple(ax)[1:]

    return _convert(cfg, axes_tree, leaf,
                    lambda ax: ax[:-2] + (ax[-1], ax[-2]))
