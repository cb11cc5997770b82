"""The weights of a configuration, made on the device from the seed.

``param_spec`` lists every parameter as the program names and shapes it
(``(out, in)`` for a dense layer, the MoE's ``(E, d, ff)`` layout), with
its type and how it is drawn: the configuration's reference module's own
``param_spec(cfg)`` where it defines one, else the list this module builds
for today's families.  ``make`` draws all the random leaves of one
type with a few large calls into one flat buffer and hands out views of
it; the constant leaves (norm scales, the SSM's A_log, D, dt_bias, biases)
are set directly.  The same tensors go to the program and to the plain
reference, which only reads them.
"""
from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

#: elements drawn by one call (a call above 2**31 elements is avoided)
CHUNK = 1 << 30


class Leaf(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str   # normal | ones | zeros | a_log


def _attention(p: str, cfg: dict, dt) -> List[Leaf]:
    d, H, KVH, dh = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                     cfg["head_dim"])
    out = [Leaf(f"{p}.wq.weight", (H * dh, d), dt, "normal"),
           Leaf(f"{p}.wk.weight", (KVH * dh, d), dt, "normal"),
           Leaf(f"{p}.wv.weight", (KVH * dh, d), dt, "normal")]
    if cfg.get("use_qkv_bias"):
        out += [Leaf(f"{p}.wq.bias", (H * dh,), dt, "zeros"),
                Leaf(f"{p}.wk.bias", (KVH * dh,), dt, "zeros"),
                Leaf(f"{p}.wv.bias", (KVH * dh,), dt, "zeros")]
    out.append(Leaf(f"{p}.wo.weight", (d, H * dh), dt, "normal"))
    return out


def _dense_block(p: str, cfg: dict, dt) -> List[Leaf]:
    d, ff = cfg["d_model"], cfg["d_ff"]
    out = [Leaf(f"{p}.ln1.scale", (d,), dt, "ones")]
    out += _attention(f"{p}.attn", cfg, dt)
    out.append(Leaf(f"{p}.ln2.scale", (d,), dt, "ones"))
    moe = cfg.get("moe")
    if moe:
        E = moe["n_experts"]
        out += [Leaf(f"{p}.moe.router", (d, E), dt, "normal"),
                Leaf(f"{p}.moe.gate", (E, d, ff), dt, "normal"),
                Leaf(f"{p}.moe.up", (E, d, ff), dt, "normal"),
                Leaf(f"{p}.moe.down", (E, ff, d), dt, "normal")]
    else:
        out += [Leaf(f"{p}.ffn.gate.weight", (ff, d), dt, "normal"),
                Leaf(f"{p}.ffn.up.weight", (ff, d), dt, "normal"),
                Leaf(f"{p}.ffn.down.weight", (d, ff), dt, "normal")]
    return out


def ssm_sizes(cfg: dict) -> Dict[str, int]:
    s, d = cfg["ssm"], cfg["d_model"]
    din = s["expand"] * d
    heads = din // s["head_dim"]
    conv = din + 2 * s["n_groups"] * s["d_state"]
    return {"d_inner": din, "heads": heads, "conv_dim": conv,
            "proj": din + conv + heads}


def _ssm_block(p: str, cfg: dict, dt) -> List[Leaf]:
    d, s = cfg["d_model"], cfg["ssm"]
    z = ssm_sizes(cfg)
    f32 = torch.float32
    return [Leaf(f"{p}.ln.scale", (d,), dt, "ones"),
            Leaf(f"{p}.mixer.in_proj.weight", (z["proj"], d), dt, "normal"),
            Leaf(f"{p}.mixer.conv_w", (s["d_conv"], z["conv_dim"]), dt,
                 "normal"),
            Leaf(f"{p}.mixer.conv_b", (z["conv_dim"],), dt, "zeros"),
            Leaf(f"{p}.mixer.A_log", (z["heads"],), f32, "a_log"),
            Leaf(f"{p}.mixer.D", (z["heads"],), f32, "ones"),
            Leaf(f"{p}.mixer.dt_bias", (z["heads"],), f32, "zeros"),
            Leaf(f"{p}.mixer.norm", (z["d_inner"],), dt, "ones"),
            Leaf(f"{p}.mixer.out_proj.weight", (d, z["d_inner"]), dt,
                 "normal")]


def param_spec(cfg: dict, ref: Optional[ModuleType] = None) -> List[Leaf]:
    """Every parameter of ``cfg``'s model, by the program's name: ``ref``'s
    ``param_spec(cfg)`` where the reference module defines one."""
    if hasattr(ref, "param_spec"):
        return ref.param_spec(cfg)
    dt = DTYPES[cfg["param_dtype"]]
    d, V = cfg["d_model"], cfg["vocab_size"]
    ssm = cfg["family"] in ("ssm", "hybrid")
    spec = [Leaf("embed.weight", (V, d), dt, "normal")]
    for i in range(cfg["n_layers"]):
        spec += (_ssm_block if ssm else _dense_block)(f"blocks.{i}", cfg, dt)
    if cfg["family"] == "hybrid":
        spec += _dense_block("shared", cfg, dt)
    spec.append(Leaf("final_ln.scale", (d,), dt, "ones"))
    if not cfg.get("tie_embeddings"):
        spec.append(Leaf("head.weight", (V, d), dt, "normal"))
    return spec


def n_params(cfg: dict, ref: Optional[ModuleType] = None) -> int:
    return sum(math.prod(leaf.shape) for leaf in param_spec(cfg, ref))


def _constant(leaf: Leaf, device) -> torch.Tensor:
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "a_log":
        return torch.log(torch.linspace(1.0, 16.0, leaf.shape[0],
                                        dtype=torch.float32, device=device)
                         ).to(leaf.dtype)
    raise ValueError(f"{leaf.name}: unknown init {leaf.init!r}")


def make(cfg: dict, seed: int, device, ref: Optional[ModuleType] = None
         ) -> Dict[str, torch.Tensor]:
    """name -> tensor on ``device``: the random leaves N(0, init_scale²)
    drawn by a generator on ``device`` seeded with ``seed``, one flat
    buffer a type filled in calls of at most ``CHUNK`` elements, in the
    order of ``param_spec(cfg, ref)``."""
    spec = param_spec(cfg, ref)
    scale = float(cfg["init_scale"])
    gen = torch.Generator(device).manual_seed(int(seed))
    out: Dict[str, torch.Tensor] = {}
    by_type: Dict[torch.dtype, List[Leaf]] = {}
    for leaf in spec:
        if leaf.init == "normal":
            by_type.setdefault(leaf.dtype, []).append(leaf)
        else:
            out[leaf.name] = _constant(leaf, device)
    for dtype in sorted(by_type, key=str):
        leaves = by_type[dtype]
        flat = torch.empty(sum(math.prod(x.shape) for x in leaves),
                           dtype=dtype, device=device)
        for i in range(0, flat.numel(), CHUNK):
            flat[i:i + CHUNK].normal_(0.0, scale, generator=gen)
        off = 0
        for leaf in leaves:
            n = math.prod(leaf.shape)
            out[leaf.name] = flat[off:off + n].view(leaf.shape)
            off += n
    return {leaf.name: out[leaf.name] for leaf in spec}
