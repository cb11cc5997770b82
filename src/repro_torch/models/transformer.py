"""Model assembly for every family of the registry.

The model is an ``nn.Module`` (``Transformer``) whose blocks sit in an
``nn.ModuleList`` and are run by a Python loop, eagerly; the reference stacks
layer parameters along a leading axis and scans over them.  The functions
keep the reference's names and argument order, with the module in the place
of the parameter pytree.

Families:
  dense / moe / vlm / audio : pre-norm attention + (FFN | MoE) blocks; vlm
                              places vision embeddings over the first
                              positions and turns q, k by M-RoPE; audio sums
                              codebook embeddings and has one LM head per
                              codebook
  ssm                       : Mamba2 (SSD) blocks
  hybrid                    : Zamba2 — SSD blocks + one *shared*
                              attention+MLP block applied after every
                              ``attn_every``-th SSD layer
  pattern                   : Nemotron-H — block i is the i-th letter of
                              ``block_pattern``, each one pre-norm residual
                              block of one mixer: "M" Mamba2, "E" the MoE,
                              "*" attention (no FFN after it)

Training: ``loss_fn`` differentiates ``forward`` with torch autograd; the
kernels sit inside autograd Functions (``attention._FlashAttention``,
``ssm._SSDScan``).  The reference's ``jax.checkpoint`` remat per block is
``torch.utils.checkpoint`` (``_remat``): ``full`` keeps only block
boundaries, ``dots`` also keeps the outputs of the 2-D matrix products.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import logical
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm
from repro_torch.runtime import flags


def _has_ssm(cfg: ArchConfig) -> bool:
    """ssm and hybrid stack SSM blocks; every other family attention
    blocks."""
    return cfg.family in ("ssm", "hybrid")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class DenseBlock(nn.Module):
    """Pre-norm attention + SwiGLU FFN (``ffn``) or mixture of experts
    (``moe``)."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        self.ln1 = layers.RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.attn = attn.Attention(cfg, dtype, device, generator)
        self.ln2 = layers.RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        if cfg.moe is not None:
            self.moe = moe.MoE(cfg, dtype, device, generator)
        else:
            self.ffn = layers.FFN(cfg.d_model, cfg.d_ff, dtype, device,
                                  generator)


class SSMBlock(nn.Module):
    """Pre-norm Mamba2 mixer."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        self.ln = layers.RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.mixer = ssm.SSM(cfg, dtype, device, generator)


class MoEBlock(nn.Module):
    """Pre-norm mixture of experts (the pattern family's "E")."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        self.ln = layers.RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.moe = moe.MoE(cfg, dtype, device, generator)


class AttnBlock(nn.Module):
    """Pre-norm attention and no FFN after it (the pattern family's
    "*")."""

    def __init__(self, cfg: ArchConfig, dtype, device, generator):
        super().__init__()
        self.ln = layers.RMSNorm(cfg.d_model, dtype, device, cfg.norm_eps)
        self.attn = attn.Attention(cfg, dtype, device, generator)


#: the pattern family's block of each letter
PATTERN_BLOCKS = {"M": SSMBlock, "E": MoEBlock, "*": AttnBlock}


class Transformer(nn.Module):
    """``place(module, name)``, called on each top-level part (the
    embedding, each block, the shared block, the final norm, the head) as
    soon as it is made, lays its parameters out (``init_params``' sharded
    form); the random draws follow the construction order whatever it
    does."""

    def __init__(self, cfg: ArchConfig, device, generator: torch.Generator,
                 place: Optional[Callable[[nn.Module, str], nn.Module]]
                 = None):
        super().__init__()
        place = place or (lambda m, name: m)
        dtype = layers.to_dtype(cfg.param_dtype)
        self.embed = place(layers.Embedding(cfg.vocab_size, cfg.d_model,
                                            dtype, device, generator,
                                            cfg.n_input_codebooks), "embed")
        if cfg.family == "pattern":
            kinds = [PATTERN_BLOCKS[c] for c in cfg.blocks]
        else:
            kinds = [SSMBlock if _has_ssm(cfg) else DenseBlock] \
                * cfg.n_layers
        self.blocks = nn.ModuleList(
            place(block(cfg, dtype, device, generator), f"blocks.{i}")
            for i, block in enumerate(kinds))
        if cfg.family == "hybrid":
            if cfg.n_layers % cfg.hybrid.attn_every:
                raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not "
                                 f"a multiple of attn_every "
                                 f"{cfg.hybrid.attn_every}")
            # ONE attention+MLP block, applied at every site
            self.shared = place(DenseBlock(cfg, dtype, device, generator),
                                "shared")
        self.final_ln = place(layers.RMSNorm(cfg.d_model, dtype, device,
                                             cfg.norm_eps), "final_ln")
        self.head = None if cfg.tie_embeddings else place(layers.LMHead(
            cfg.d_model, cfg.vocab_size, dtype, device, generator,
            cfg.n_output_heads), "head")


def init_params(cfg: ArchConfig,
                generator: Optional[torch.Generator] = None, *,
                device="cuda", seed: int = 0, mesh=None,
                plan=None) -> Transformer:
    """A model with seeded random weights (``N(0, INIT_SCALE²)``, norms at
    one), made on ``device``.  ``generator`` must live on ``device``; without
    one, a new generator is seeded with ``seed``.

    With ``mesh`` and ``plan`` the parameters are DTensors laid out by the
    plan's rules (``sharding.param_shardings`` of ``param_axes``), each
    part sharded as soon as it is made: no rank ever holds more than one
    block whole, and the values equal the unsharded model's."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(seed)
    place = None
    if mesh is not None:
        specs = dict(Transformer(cfg, torch.device("meta"),
                                 None).named_parameters())
        placements = sharding.param_shardings(
            mesh, plan, param_axes(cfg, specs), specs)

        def place(module, name):
            return sharding.distribute_params(
                module, mesh, {k: placements[f"{name}.{k}"]
                               for k, _ in module.named_parameters()})
    return Transformer(cfg, device, generator, place)


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def param_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


# ---------------------------------------------------------------------------
# Logical axes and shapes (for the sharding rules)
# ---------------------------------------------------------------------------

#: logical axes of a block's parameters by their name inside the block;
#: dense weights are stored (out, in), so their axes read (out, in)
BLOCK_AXES = {
    "ln1.scale": ("embed",), "ln2.scale": ("embed",), "ln.scale": ("embed",),
    "attn.wq.weight": ("heads", "embed"), "attn.wq.bias": ("heads",),
    "attn.wk.weight": ("kv_heads", "embed"), "attn.wk.bias": ("kv_heads",),
    "attn.wv.weight": ("kv_heads", "embed"), "attn.wv.bias": ("kv_heads",),
    "attn.wo.weight": ("embed", "heads"),
    "ffn.gate.weight": ("ff", "embed"), "ffn.up.weight": ("ff", "embed"),
    "ffn.down.weight": ("embed", "ff"),
    "moe.router": ("embed", "expert"), "moe.router_bias": ("expert",),
    "moe.shared_up": ("embed", "ff"), "moe.shared_down": ("ff", "embed"),
    "moe.gate": ("expert", "embed", "ff"), "moe.up": ("expert", "embed", "ff"),
    "moe.down": ("expert", "ff", "embed"),
    "mixer.in_proj.weight": ("ssm_inner", "embed"),
    "mixer.conv_w": ("conv", "ssm_inner"), "mixer.conv_b": ("ssm_inner",),
    "mixer.A_log": ("ssm_heads",), "mixer.D": ("ssm_heads",),
    "mixer.dt_bias": ("ssm_heads",), "mixer.norm": ("ssm_inner",),
    "mixer.out_proj.weight": ("embed", "ssm_inner"),
}


def param_shapes(cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The full model's ``state_dict`` as meta tensors (shapes and types;
    nothing allocated)."""
    return Transformer(cfg, torch.device("meta"), None).state_dict()


def param_axes(cfg: ArchConfig, shapes: Optional[Dict[str, Any]] = None
               ) -> Dict[str, Tuple[Optional[str], ...]]:
    """Logical axes of every ``state_dict`` entry, read off the model's
    structure on the meta device (nothing allocated); ``shapes``: that
    ``state_dict`` (or the named parameters) where the caller has it."""
    axes = {}
    for name, t in (param_shapes(cfg) if shapes is None else shapes).items():
        if name == "embed.weight":
            ax = ("codebook", "vocab", "embed") if t.ndim == 3 \
                else ("vocab", "embed")
        elif name == "head.weight":
            ax = ("head_idx", "vocab", "embed") if t.ndim == 3 \
                else ("vocab", "embed")
        elif name == "final_ln.scale":
            ax = ("embed",)
        else:
            # blocks.<i>.<name in block> or shared.<name in block>
            local = name.split(".", 2)[2] if name.startswith("blocks.") \
                else name.split(".", 1)[1]
            ax = BLOCK_AXES[local]
        axes[name] = ax
    return axes


def decode_state_axes(cfg: ArchConfig) -> Dict[str, Any]:
    """Logical-axes tree mirroring ``init_decode_state``'s output."""
    kv_axes = attn.KVCache(
        k=("act_layers", "act_batch", "act_seq_dp", "act_kv_heads", None),
        v=("act_layers", "act_batch", "act_seq_dp", "act_kv_heads", None))
    ssm_axes = ssm.SSMState(
        conv=("act_layers", "act_batch", None, "act_ssm_inner"),
        h=("act_layers", "act_batch", "act_ssm_heads", None, None))
    axes: Dict[str, Any] = {"pos": ()}
    if _has_ssm(cfg) or cfg.family == "pattern":
        axes["ssm"] = ssm_axes
    if cfg.family != "ssm":
        axes["kv"] = kv_axes
    return axes


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

#: the products ``dots`` keeps: 2-D matrix products, as JAX's
#: ``dots_with_no_batch_dims_saveable`` keeps dots without batch dimensions
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, policy: Optional[str]) -> Callable:
    """``fn`` under the remat ``policy``: ``none`` runs it as it is;
    ``full`` keeps only its inputs and recomputes the rest in the backward;
    ``dots`` also keeps the outputs of its 2-D matrix products.  Without
    autograd (prefill) there is nothing to keep, and ``fn`` runs as it is.

    The recompute runs inside the backward, which for CUDA tensors runs on
    autograd's own thread, where the thread-local ``runtime.flags`` are at
    their defaults: the flags and the sharding state of the forward are
    captured here and set again around every run of ``fn``, so that the
    recompute takes the same path (kernel or plain, its layouts) as the
    forward it replays."""
    if policy in (None, "none") or not torch.is_grad_enabled():
        return fn
    if policy not in ("full", "nothing", "dots"):
        raise ValueError(f"unknown remat policy {policy!r}")
    kernels, stub = flags.kernels_enabled(), flags.attention_stubbed()
    priced, state = flags.kernels_priced(), sharding.snapshot()

    def run(*args):
        with flags.use_kernels(kernels), flags.stub_attention(stub), \
                flags.price_kernels(priced), sharding.restored(state):
            return fn(*args)

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(_ckpt.checkpoint, run, use_reentrant=False,
                             **kw)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _annotate_resid(h):
    return logical(h, ("act_batch", "act_seq", "act_embed"))


def _dense_block_apply(bp: DenseBlock, h, cfg, positions, cache=None,
                       cache_pos=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (h, the block's auxiliary loss: the MoE's, else 0)."""
    a_out, _ = attn.attn_apply(bp.attn, bp.ln1(h), cfg, positions=positions,
                               cache=cache, cache_pos=cache_pos)
    h = _annotate_resid(h + a_out)
    x = bp.ln2(h)
    if cfg.moe is not None:
        f_out, aux = moe.moe_apply(bp.moe, x, cfg)
    else:
        f_out = bp.ffn(x)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _annotate_resid(h + f_out), aux


def _ssm_block_apply(bp: SSMBlock, h, cfg, state=None):
    m_out, _ = ssm.ssm_apply(bp.mixer, bp.ln(h), cfg, state=state)
    return _annotate_resid(h + m_out)


def _pattern_block_apply(bp: nn.Module, h, cfg, kind: str, positions,
                         cache=None, cache_pos=None, state=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of the pattern family, of ``kind`` M, E or * -> (h, the
    block's auxiliary loss: the MoE's, else 0)."""
    if kind == "M":
        return _ssm_block_apply(bp, h, cfg, state), \
            torch.zeros((), dtype=torch.float32, device=h.device)
    x = bp.ln(h)
    if kind == "E":
        out, aux = moe.moe_apply(bp.moe, x, cfg)
    else:
        out, _ = attn.attn_apply(bp.attn, x, cfg, positions=positions,
                                 cache=cache, cache_pos=cache_pos)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _annotate_resid(h + out), aux


def _pattern_slot(cfg, i: int) -> int:
    """Block i's index among the pattern's blocks of its letter (its KV
    cache or SSM state)."""
    return cfg.blocks[:i].count(cfg.blocks[i])


def _is_site(cfg, i: int) -> bool:
    """Does the hybrid's shared block follow SSM layer ``i``?"""
    return cfg.family == "hybrid" and (i + 1) % cfg.hybrid.attn_every == 0


def embed_inputs(model: Transformer, cfg: ArchConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The token embeddings; with ``cfg.vision_tokens``,
    ``batch["vision_embeds"]`` (B, vision_tokens, d) in place of the first
    ``vision_tokens`` positions."""
    h = model.embed(batch["tokens"])
    if cfg.vision_tokens:
        ve = batch["vision_embeds"].to(h.dtype)
        if ve.shape[1] > h.shape[1]:
            raise ValueError(f"{ve.shape[1]} vision embeddings for a "
                             f"sequence of {h.shape[1]}")
        h = torch.cat([ve, h[:, ve.shape[1]:]], dim=1)
    return _annotate_resid(h)


def logits_from_hidden(model: Transformer, cfg: ArchConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """(B, S, V); (B, S, n_output_heads, V) with several heads."""
    h = model.final_ln(h)
    if cfg.tie_embeddings:
        logits = layers.tied_lm_head(model.embed.weight, h)
        names = ("act_batch", "act_seq", "act_vocab")
    else:
        logits = model.head(h)
        names = (("act_batch", "act_seq", "act_vocab")
                 if cfg.n_output_heads == 1
                 else ("act_batch", "act_seq", None, "act_vocab"))
    return logical(logits, names)


def forward(model: Transformer, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor],
            remat_policy: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (logits, aux_loss).  Train/prefill path (full sequence); the
    auxiliary loss is the MoE layers' summed, f32 (zero for the other
    families).  ``remat_policy`` (default ``cfg.remat_policy``) wraps each
    block — for the hybrid, each super-block of ``attn_every`` SSM layers
    and the shared block, as the reference's ``super_body`` — in
    ``_remat``."""
    policy = remat_policy or cfg.remat_policy
    h = embed_inputs(model, cfg, batch)
    B, S = h.shape[0], h.shape[1]
    positions = attn._positions_for(cfg, B, S, device=h.device)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.family == "pattern":
        for bp, kind in zip(model.blocks, cfg.blocks):
            h, a = _remat(functools.partial(
                _pattern_block_apply, bp, cfg=cfg, kind=kind,
                positions=positions), policy)(h)
            aux = aux + a
    elif not _has_ssm(cfg):
        for bp in model.blocks:
            h, a = _remat(functools.partial(_dense_block_apply, bp, cfg=cfg,
                                            positions=positions), policy)(h)
            aux = aux + a
    else:
        k = cfg.hybrid.attn_every if cfg.family == "hybrid" else 1
        for i in range(0, cfg.n_layers, k):
            h = _remat(functools.partial(_super_block_apply, model, cfg,
                                         range(i, i + k), positions),
                       policy)(h)
    return logits_from_hidden(model, cfg, h), aux


def _super_block_apply(model: Transformer, cfg, layers_, positions, h):
    """SSM layers ``layers_`` and, where the hybrid applies it, the shared
    block after them."""
    for i in layers_:
        h = _ssm_block_apply(model.blocks[i], h, cfg)
        if _is_site(cfg, i):
            h, _ = _dense_block_apply(model.shared, h, cfg, positions)
    return h


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def loss_fn(model: Transformer, cfg: ArchConfig,
            batch: Dict[str, torch.Tensor],
            remat_policy: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (total, {"ce", "aux"}): the mean (masked) next-token cross-entropy
    of ``batch["labels"]`` ((B, S), or (B, S, n_output_heads) with several
    heads, the mask (B, S) then applying to every head), plus
    ``cfg.moe.aux_loss_weight`` × the auxiliary loss for the MoE family."""
    logits, aux = forward(model, cfg, batch, remat_policy)
    mask = batch.get("loss_mask")
    if cfg.n_output_heads > 1 and mask is not None:
        mask = mask[..., None]
    ce = layers.softmax_xent(logits, batch["labels"], mask)
    total = ce
    if cfg.moe is not None:
        total = total + cfg.moe.aux_loss_weight * aux
    return total, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ArchConfig, B: int, max_len: int, dtype=None,
                      device="cuda") -> Dict[str, Any]:
    """Decode caches stacked along a leading axis, and the position:

    * ``"kv"``: KV caches ``(n, B, Smax, KVH, dh)``, one per attention layer
      (dense, moe, vlm, audio, the pattern's "*" blocks) or one per
      application site of the shared block (hybrid, ``n_layers //
      attn_every`` sites);
    * ``"ssm"``: ``SSMState(conv (L, B, d_conv-1, conv_dim), h (L, B, H, P,
      N) f32)``, one per SSM layer (ssm, hybrid, the pattern's "M"
      blocks).

    As in the reference there is ONE position for all ``B`` rows.  It is kept
    as a host integer, so reading it never waits for the device."""
    dtype = dtype or layers.to_dtype(cfg.compute_dtype)
    state: Dict[str, Any] = {"pos": 0}
    pattern = cfg.family == "pattern"
    if _has_ssm(cfg) or pattern:
        one = ssm.init_ssm_state(cfg, B, dtype, device=device)
        n = cfg.blocks_of("M") if pattern else cfg.n_layers
        state["ssm"] = ssm.SSMState(
            *(t.new_zeros((n,) + tuple(t.shape)) for t in one))
    if cfg.family != "ssm":
        n = cfg.n_layers // cfg.hybrid.attn_every \
            if cfg.family == "hybrid" else cfg.n_layers
        if pattern:
            n = cfg.blocks_of("*")
        shape = (n,) + attn.cache_shape(cfg, B, max_len)
        state["kv"] = attn.KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))
    return state


def decode_step(model: Transformer, cfg: ArchConfig, state: Dict[str, Any],
                tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One-token decode.  tokens (B, 1[, n_codebooks]) -> logits (B, 1[,
    n_output_heads], V), new state.  Text only, as in the reference: no
    vision embeddings; an MoE layer routes the B tokens as one group.

    The caches of ``state`` (KV and SSM) are updated IN PLACE; the returned
    state shares them and carries the advanced position."""
    pos = int(state["pos"])
    kv, st = state.get("kv"), state.get("ssm")
    h = _annotate_resid(model.embed(tokens))
    B = h.shape[0]
    positions = attn._positions_for(cfg, B, 1, offset=pos, device=h.device)

    def cache(site: int) -> attn.KVCache:
        return attn.KVCache(kv.k[site], kv.v[site])

    for i, bp in enumerate(model.blocks):
        if cfg.family == "pattern":
            kind, j = cfg.blocks[i], _pattern_slot(cfg, i)
            h, _ = _pattern_block_apply(
                bp, h, cfg, kind, positions,
                cache(j) if kind == "*" else None, pos,
                ssm.SSMState(st.conv[j], st.h[j]) if kind == "M" else None)
            continue
        if not _has_ssm(cfg):
            h, _ = _dense_block_apply(bp, h, cfg, positions, cache(i), pos)
            continue
        h = _ssm_block_apply(bp, h, cfg, ssm.SSMState(st.conv[i], st.h[i]))
        if _is_site(cfg, i):
            h, _ = _dense_block_apply(model.shared, h, cfg, positions,
                                      cache(i // cfg.hybrid.attn_every), pos)
    logits = logits_from_hidden(model, cfg, h)
    return logits, {**state, "pos": pos + 1}
