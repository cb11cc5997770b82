"""Symbolic per-architecture property counts — closed-form p_i(n).

The paper's extraction produces *piecewise quasi-polynomials in the size
parameters* so the model can be "cheaply re-evaluated for changed values of
the parameter vector n".  This module provides the same for whole model
steps: given an ``ArchConfig``, it emits a property vector whose values are
``symcount.Expr``s in the free variables

    B  global batch            S  sequence length
    M  microbatches            (mesh sizes enter via ``shard_env``)

for each of the three phases (train / prefill / decode) of a
``core.workload.WorkloadSpec``.  Decode specs carrying refinements
introduce additional variables (only when the spec sets the field — see
``WorkloadSpec.structure``):

    CT  total context tokens read across slots (KV/SSM cache traffic)
    AS  occupied decode slots (occupancy-aware per-token work)
    SL  speculative-decode tokens verified per iteration
    MI  MoE hottest-expert load multiplier

Downstream:

  * ``core.predictor`` evaluates these against a fitted/analytic weight set
    in O(|properties|) — the paper's "small inner product";
  * ``launch/autoshard.py`` re-evaluates them per candidate Plan in µs,
    realizing the paper's §6.2 'optimal configuration selection' extension;
  * tests pin them against ``extract_jaxpr`` / XLA ``cost_analysis`` on
    reduced configs.

Counting conventions
  * MXU flops: 2·MACs of every projection / attention / expert contraction,
    per token.  MoE uses the *active* expert count (top-k) + the dense
    dispatch/combine einsum cost at the configured capacity.
  * VPU flops: norms, softmax, rope, silu, residuals — one bucketed count
    per op kind (add/mul/div/exp/special), coefficients from the literal
    jnp implementation in ``repro_torch.models`` (kept in sync by tests).
  * Bytes move as s1 loads/stores of the *compute dtype* except where the
    access is genuinely strided/gathered (embedding lookup = gather).
  * train = fwd + bwd (2× fwd flops for dW, 1× for dX ⇒ 3× multiplier on
    MXU terms (+1× more with full remat), plus optimizer update traffic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.configs.base import ArchConfig
from repro_torch.core import properties as props
from repro_torch.core import workload as wl
from repro_torch.core.symcount import (
    CeilDiv, Const, Expr, ExprLike, Max, Min, Piecewise, Var, add_vectors,
    as_expr, evaluate_vector, scale_vector,
)

B = Var("B")   # global batch
S = Var("S")   # sequence length (train/prefill) or KV length (decode)
M = Var("M")   # microbatches
DP = Var("DP")  # data-parallel ways (product of the plan's dp-axis sizes)
TP = Var("TP")  # tensor-parallel ways (the plan's tp-axis size)
CT = Var("CT")  # total cache-context tokens across decode slots
AS = Var("AS")  # occupied decode slots
SL = Var("SL")  # speculative-decode length (tokens/iteration/slot)
MI = Var("MI")  # MoE hottest-expert load multiplier


def _bits(cfg: ArchConfig) -> int:
    return 16 if "16" in cfg.compute_dtype else 32


# ---------------------------------------------------------------------------
# Per-block MAC counts (per token)
# ---------------------------------------------------------------------------


def _attn_proj_macs(cfg: ArchConfig) -> int:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return d * H * hd + 2 * d * KV * hd + H * hd * d  # q,k,v,o


def _attn_score_macs_train(cfg: ArchConfig) -> Expr:
    """Per-token QK^T + PV MACs over a length-S causal (or SWA) context."""
    H, hd = cfg.n_heads, cfg.head_dim_
    if cfg.sliding_window is not None:
        ctx = Min(S, Const(cfg.sliding_window))
        eff = ctx  # every token sees ≤ window
    else:
        eff = S * 0.5  # causal average context
    return 2 * H * hd * eff  # qk + pv


def _ffn_macs(cfg: ArchConfig, active_experts: float = 1.0) -> float:
    return active_experts * 3 * cfg.d_model * cfg.d_ff  # gate, up, down


def _moe_active(cfg: ArchConfig) -> float:
    """Dense (GShard) dispatch really computes capacity-PADDED expert FFNs:
    top_k · capacity_factor expert-equivalents per token."""
    return cfg.moe.top_k * cfg.moe.capacity_factor


def _ssm_macs(cfg: ArchConfig) -> Expr:
    """Mamba2/SSD per-token MACs: projections + chunked SSD terms."""
    s = cfg.ssm
    d, din = cfg.d_model, cfg.d_inner
    nH, P, N, G = cfg.ssm_heads, s.head_dim, s.d_state, s.n_groups
    proj = d * (2 * din + 2 * G * N + nH) + din * d  # in_proj + out_proj
    conv = (din + 2 * G * N) * s.d_conv
    Q = Const(s.chunk)
    # intra-chunk: CB (Q·N per token·head) + y_intra (Q·P) ;
    # inter-chunk + state update: 2·P·N per token·head
    ssd = nH * (Q * N + Q * P + 2 * P * N)
    return proj + conv + ssd


def _moe_dispatch_macs(cfg: ArchConfig, tokens: ExprLike = None) -> Expr:
    """Dense GShard dispatch/combine einsum MACs per token.

    dispatch xe=einsum(gtec,gtd) + combine y=einsum(egcd,gtec) each cost
    t·(E·C·d) per group with E·C ≈ top_k·cf·t — i.e. per-token cost scales
    with the dispatch GROUP SIZE t = min(tokens, GROUP_TOKENS): the
    quadratic-in-group-size price of dense dispatch (this is why the
    group-size cap exists)."""
    from repro_torch.models.moe import GROUP_TOKENS
    m = cfg.moe
    E = m.n_experts
    d = cfg.d_model
    tg = Min(as_expr(tokens if tokens is not None else B * S),
             Const(GROUP_TOKENS))
    return (as_expr(2 * m.top_k * m.capacity_factor * d) * tg
            + d * E)  # + router


# ---------------------------------------------------------------------------
# VPU (elementwise) per-token flop buckets, per layer
# ---------------------------------------------------------------------------


def _vpu_layer(cfg: ArchConfig) -> Dict[str, ExprLike]:
    d = cfg.d_model
    out: Dict[str, ExprLike] = {}
    add = mul = div = exp = special = as_expr(0)
    # 2 rmsnorms: mean(x²) (2d add+mul) + rsqrt + scale (d mul)
    add = add + 4 * d
    mul = mul + 6 * d
    special = special + 2  # rsqrt
    add = add + 2 * d  # residuals
    if cfg.n_heads:
        H, hd = cfg.n_heads, cfg.head_dim_
        # rope: 4 mul + 2 add per q/k element pair + sin/cos
        rope_elems = (cfg.n_heads + cfg.n_kv_heads) * hd
        mul = mul + 2 * rope_elems
        add = add + rope_elems
        special = special + rope_elems  # sin/cos pairs
        # softmax over context: exp + sum + div per score
        ctx = Min(S, Const(cfg.sliding_window)) if cfg.sliding_window \
            else S * 0.5
        exp = exp + H * ctx
        add = add + H * ctx
        div = div + H * ctx
    if cfg.ssm is not None:
        din = cfg.d_inner
        # silu(conv) + silu(z)·y + gated norm + softplus(dt) + exp(dA)
        special = special + 2 * din + 2 * cfg.ssm_heads
        mul = mul + 3 * din
        add = add + 2 * din
    if cfg.d_ff and cfg.moe is None:
        special = special + cfg.d_ff   # silu
        mul = mul + cfg.d_ff
    if cfg.moe is not None:
        E = cfg.moe.n_experts
        exp = exp + E            # router softmax
        add = add + 3 * E
        div = div + E
        special = special + cfg.moe.top_k * cfg.moe.capacity_factor * cfg.d_ff
        mul = mul + cfg.moe.top_k * cfg.moe.capacity_factor * cfg.d_ff
    b = _bits(cfg)
    for k, v in (("add", add), ("mul", mul), ("div", div), ("exp", exp),
                 ("special", special)):
        out[props.flop_key(32, k)] = v  # VPU math runs f32 in our models
    return out


# ---------------------------------------------------------------------------
# Whole-step property vectors (symbolic)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StepCounts:
    """Symbolic property vector + the MODEL_FLOPS closed form."""
    pv: Dict[str, ExprLike]
    model_flops: ExprLike  # 6·N·D (train) / 2·N_active·D (inference)

    def concrete(self, env: Mapping[str, float]) -> Dict[str, float]:
        full = dict(env)
        full.setdefault("M", 1)
        return evaluate_vector(self.pv, full)

    def concrete_model_flops(self, env: Mapping[str, float]) -> float:
        e = self.model_flops
        full = dict(env); full.setdefault("M", 1)
        return e.eval(full) if isinstance(e, Expr) else float(e)


def _layer_macs(cfg: ArchConfig) -> Expr:
    """Per-token MACs of one *average* layer (MoE: active experts)."""
    if cfg.family == "ssm":
        return as_expr(_ssm_macs(cfg))
    if cfg.family == "hybrid":
        k = cfg.hybrid.attn_every
        shared = (_attn_proj_macs(cfg) + _ffn_macs(cfg)
                  + _attn_score_macs_train(cfg))
        return as_expr(_ssm_macs(cfg)) + as_expr(shared) * (1.0 / k)
    macs = as_expr(_attn_proj_macs(cfg)) + _attn_score_macs_train(cfg)
    if cfg.moe is not None:
        macs = macs + _ffn_macs(cfg, _moe_active(cfg)) + _moe_dispatch_macs(cfg)
    else:
        macs = macs + _ffn_macs(cfg)
    return macs


def _embed_head_macs(cfg: ArchConfig) -> ExprLike:
    # embedding lookup is a gather (no MACs); head is d×V per output head
    return cfg.d_model * cfg.vocab_size * cfg.n_output_heads


def forward_counts(cfg: ArchConfig) -> Dict[str, ExprLike]:
    """Symbolic property vector of ONE forward pass over (B, S) tokens."""
    T = B * S
    bits = _bits(cfg)
    L = cfg.n_layers
    pv: Dict[str, ExprLike] = {}

    macs = _layer_macs(cfg) * L + _embed_head_macs(cfg)
    pv[props.mxu_key(bits)] = as_expr(2) * macs * T

    pv = add_vectors(pv, scale_vector(_vpu_layer(cfg), T * L))
    # final norm + softmax-xent flops
    pv = add_vectors(pv, {
        props.flop_key(32, "add"): T * 2 * cfg.d_model,
        props.flop_key(32, "exp"): T * cfg.vocab_size * cfg.n_output_heads,
    })

    # --- data motion (elems) ---
    d = cfg.d_model
    # params stream HBM→chip once per step
    pv[props.mem_key("load", bits, "s1")] = as_expr(cfg.n_params())
    # embedding lookup: gather of T·d
    pv[props.mem_key("load", bits, "gather")] = T * d
    # residual stream activations: ~4 reads + 2 writes per layer
    pv[props.mem_key("load", bits, "s1")] = (
        pv[props.mem_key("load", bits, "s1")] + T * d * 4 * L)
    pv[props.mem_key("store", bits, "s1")] = (
        T * d * 2 * L + T * cfg.vocab_size * cfg.n_output_heads)
    return pv


def train_fwd_multiplier(cfg: ArchConfig,
                         remat_policy: Optional[str] = None) -> float:
    """fwd+bwd compute multiplier: bwd ≈ 2× fwd MXU flops, and full remat
    re-runs the forward once more inside bwd."""
    policy = remat_policy or cfg.remat_policy
    return 3.0 + (1.0 if policy in ("full", "nothing") else 0.0)


def train_counts(cfg: ArchConfig,
                 remat_policy: Optional[str] = None) -> StepCounts:
    """fwd + bwd + optimizer.  bwd ≈ 2× fwd MXU flops; full remat re-runs
    the forward once more inside bwd."""
    fwd = forward_counts(cfg)
    mult = train_fwd_multiplier(cfg, remat_policy)
    pv = scale_vector(fwd, mult)
    bits = _bits(cfg)
    Np = cfg.n_params()
    # optimizer: read params+grads+m+v, write params+m+v (f32 states)
    pv = add_vectors(pv, {
        props.mem_key("load", 32, "s1"): 4.0 * Np,
        props.mem_key("store", 32, "s1"): 3.0 * Np,
        props.flop_key(32, "mul"): 8.0 * Np,
        props.flop_key(32, "add"): 6.0 * Np,
        props.flop_key(32, "special"): Np,  # rsqrt
        props.GROUPS: CeilDiv(B * S, Const(2 ** 14)),
    })
    model_flops = as_expr(6.0 * cfg.n_active_params()) * B * S
    return StepCounts(pv=pv, model_flops=model_flops)


def _n_attn_layers(cfg: ArchConfig) -> int:
    if not cfg.n_heads:
        return 0
    return (cfg.n_layers // cfg.hybrid.attn_every
            if cfg.family == "hybrid" else cfg.n_layers)


def _cache_write_elems(cfg: ArchConfig) -> ExprLike:
    """KV/SSM cache elements written when (B, S) prompt tokens prefill
    their slots: every attention layer stores the tokens' K and V rows;
    SSM layers store one final recurrent state per sequence."""
    out: ExprLike = as_expr(0)
    n_attn = _n_attn_layers(cfg)
    if n_attn:
        out = out + as_expr(2 * cfg.n_kv_heads * cfg.head_dim_
                            * n_attn) * B * S
    if cfg.ssm is not None:
        out = out + as_expr(cfg.n_layers * cfg.ssm_heads * cfg.ssm.head_dim
                            * cfg.ssm.d_state) * B
    return out


def prefill_counts(cfg: ArchConfig) -> StepCounts:
    """Serving prefill: one forward pass over (B, S) prompt tokens that
    additionally writes those tokens' KV/SSM cache rows on the way out —
    the cache-write traffic a pure forward pass does not pay."""
    pv = dict(forward_counts(cfg))
    bits = _bits(cfg)
    sk = props.mem_key("store", bits, "s1")
    pv[sk] = as_expr(pv[sk]) + _cache_write_elems(cfg)
    pv[props.GROUPS] = CeilDiv(B * S, Const(2 ** 14))
    return StepCounts(pv=pv,
                      model_flops=as_expr(2.0 * cfg.n_active_params()) * B * S)


def decode_counts(cfg: ArchConfig,
                  spec: Optional[wl.WorkloadSpec] = None) -> StepCounts:
    """One decode iteration against KV/SSM caches over B allocated slots.

    With a default ``spec`` (or None) this is the classic per-token count:
    one token per slot, every slot occupied and full — bitwise the
    pre-``WorkloadSpec`` closed forms.  Spec refinements swap dedicated
    free variables into the forms (``WorkloadSpec.structure`` is the
    program-cache key, so unrefined specs share the default programs):

      * ``cache_tokens`` → ``CT`` replaces the ``B·min(S, window)``
        cache-read/attention footprint — the total context actually
        resident across slots;
      * ``active_slots`` → per-token work (projections, FFN, head, VPU,
        cache writes) scales with ``AS`` instead of the allocated ``B``;
      * ``spec_len`` → ``SL`` multiplies token throughput (speculative
        decoding verifies SL tokens per iteration, each attending the
        full context);
      * ``moe_imbalance`` → ``MI`` multiplies expert-FFN compute (the
        hottest expert paces an EP decode step).
    """
    flags = frozenset(spec.structure()[1:]) if spec is not None \
        else frozenset()
    bits = _bits(cfg)
    L = cfg.n_layers
    pv: Dict[str, ExprLike] = {}
    d = cfg.d_model

    rows = AS if "as" in flags else B            # token rows computed
    tok = rows * SL if "sl" in flags else rows   # token positions/iteration
    # total context read this iteration, summed across slots
    ctx = Min(S, Const(cfg.sliding_window)) if cfg.sliding_window else S
    ctx_total = CT if "ct" in flags else ctx * B

    # per-token projection MACs (no sequence dim)
    if cfg.family == "ssm":
        mac = as_expr(_ssm_macs(cfg)) * L
        cache_elems = as_expr(L) * (cfg.ssm_heads * cfg.ssm.head_dim
                                    * cfg.ssm.d_state
                                    + (cfg.ssm.d_conv - 1)
                                    * (cfg.d_inner + 2 * cfg.ssm.n_groups
                                       * cfg.ssm.d_state)) * rows
        attn_flops = as_expr(0)
    else:
        proj = _attn_proj_macs(cfg)
        if cfg.moe is not None:
            expert = as_expr(_ffn_macs(cfg, _moe_active(cfg)))
            if "mi" in flags:
                expert = expert * MI
            ff = expert + _moe_dispatch_macs(cfg, tokens=tok)  # group = tok
        else:
            ff = as_expr(_ffn_macs(cfg))
        per_layer = as_expr(proj) + ff
        if cfg.family == "hybrid":
            k = cfg.hybrid.attn_every
            per_layer = as_expr(_ssm_macs(cfg)) \
                + (as_expr(proj) + as_expr(_ffn_macs(cfg))) * (1.0 / k)
        mac = per_layer * L
        # attention over the caches: 2·H·hd MACs per (new token × context
        # token) per attention layer (GQA shares the KV rows, not the MACs)
        n_attn = _n_attn_layers(cfg)
        attn_flops = as_expr(4 * cfg.n_heads * cfg.head_dim_
                             * n_attn) * ctx_total
        if "sl" in flags:
            attn_flops = attn_flops * SL
        cache_elems = (as_expr(2 * cfg.n_kv_heads * cfg.head_dim_ * n_attn)
                       * ctx_total)
        if cfg.family == "hybrid":
            cache_elems = cache_elems + as_expr(L) * rows * (
                cfg.ssm_heads * cfg.ssm.head_dim * cfg.ssm.d_state)
    pv[props.mxu_key(bits)] = \
        as_expr(2) * (mac + _embed_head_macs(cfg)) * tok + attn_flops

    pv = add_vectors(pv, scale_vector(_vpu_layer(cfg), tok * L))
    # params + cache stream once per decode step
    pv = add_vectors(pv, {
        props.mem_key("load", bits, "s1"): as_expr(cfg.n_params()) + cache_elems,
        props.mem_key("store", bits, "s1"):
            tok * (2 * max(cfg.n_kv_heads, 1) * cfg.head_dim_ if cfg.n_heads
                   else cfg.d_inner) * L
            + tok * cfg.vocab_size * cfg.n_output_heads,
        props.mem_key("load", bits, "gather"): tok * d,
        props.GROUPS: CeilDiv(B, Const(256)),
    })
    return StepCounts(pv=pv,
                      model_flops=as_expr(2.0 * cfg.n_active_params()) * tok)


def counts_for(cfg: ArchConfig, workload: wl.WorkloadLike,
               remat_policy: Optional[str] = None) -> StepCounts:
    """Symbolic step counts for a workload — a ``WorkloadSpec``, a
    ``ShapeConfig``, or (deprecated, warns) a bare phase string."""
    spec = wl.as_spec(workload)
    if spec.phase == "train":
        return train_counts(cfg, remat_policy=remat_policy)
    if spec.phase == "prefill":
        return prefill_counts(cfg)
    return decode_counts(cfg, spec)


# ---------------------------------------------------------------------------
# Collective counts for a (Plan, mesh) — the beyond-paper distributed terms
# ---------------------------------------------------------------------------


def collective_topology(plan) -> Tuple[bool, Optional[str], str]:
    """The plan fields that select *which* collective terms exist — the
    'topology class' of ``collective_counts_symbolic``.  Plans sharing a
    class share one compiled collective vector; everything else about the
    mesh (dp/tp ways) and the schedule (microbatches) enters through the
    free variables DP/TP/M."""
    return (bool(plan.fsdp), plan.compression, plan.moe_mode)


def collective_counts_symbolic(cfg: ArchConfig, kind,
                               topology: Tuple[bool, Optional[str], str]
                               ) -> Dict[str, ExprLike]:
    """Per-device collective bytes as Exprs in {B, S, M, DP, TP}.

    ``kind`` may be a phase string or anything with a ``.kind`` (a
    ``WorkloadSpec`` or ``ShapeConfig``) — collectives depend only on the
    phase, so the bare string stays first-class here.

    The closed forms are ``collective_counts``'s, with the mesh-dependent
    gates (``dp > 1``, ``tp > 1``) expressed as ``Piecewise`` guards on
    ``DP - 1`` / ``TP - 1`` instead of Python ``if``s — so ONE compiled
    vector per (kind, topology class) scores a whole mesh-factorization
    sweep as array ops (``np.where`` over the DP/TP arrays).  The batched
    search engine (``core.planspace``) compiles these per class; the
    interpreted ``collective_counts`` stays the per-plan reference and
    tests pin the two pointwise.
    """
    kind = getattr(kind, "kind", kind)  # WorkloadSpec/ShapeConfig → phase
    fsdp, compression, moe_mode = topology
    bits = _bits(cfg)
    bytes_per = bits // 8
    out: Dict[str, ExprLike] = {}
    T_dev = B * S / DP            # tokens per device
    d = cfg.d_model
    zero = Const(0)

    param_bytes_tp = as_expr(cfg.n_params() * bytes_per) / TP
    if fsdp:
        n_gather = (2.0 * M) if kind == "train" else as_expr(1.0)
        gather = n_gather * ((DP - 1) / DP) * param_bytes_tp
        out[props.coll_key("all_gather")] = Piecewise([(DP - 1, gather)],
                                                      zero)
    if kind == "train":
        grad_bytes = as_expr(4.0 * cfg.n_params()) / TP  # f32, TP-sharded
        if compression == "int8_ef":
            grad_bytes = grad_bytes / 4.0
        if fsdp:  # grads land sharded: reduce-scatter, 1× wire
            out[props.coll_key("reduce_scatter")] = Piecewise(
                [(DP - 1, ((DP - 1) / DP) * grad_bytes)], zero)
        else:
            out[props.coll_key("all_reduce")] = Piecewise(
                [(DP - 1, 2.0 * ((DP - 1) / DP) * grad_bytes)], zero)
    if cfg.n_heads:
        # Megatron TP: 2 all-reduces of the residual per layer fwd (+2 bwd)
        n_ar = 2.0 * cfg.n_layers * (2.0 if kind == "train" else 1.0)
        act = (as_expr(B) * d * bytes_per if kind == "decode"
               else T_dev * d * bytes_per)
        term = Piecewise(
            [(TP - 1, as_expr(n_ar * 2.0) * ((TP - 1) / TP) * act)], zero)
        prev = out.get(props.coll_key("all_reduce"))
        out[props.coll_key("all_reduce")] = \
            term if prev is None else as_expr(prev) + term
    if cfg.moe is not None and moe_mode == "ep":
        tok = as_expr(B) if kind == "decode" else T_dev
        a2a = tok * d * bytes_per * cfg.moe.top_k * 2.0  # dispatch + combine
        out[props.coll_key("all_to_all")] = Piecewise(
            [(TP - 1, a2a * ((TP - 1) / TP))], zero)
    # canonicalize: the gate/traffic products above repeat subterms (the
    # (DP-1)/DP wire factors, the TP-sharded byte counts); simplifying here
    # benefits both the per-property compiled vectors and the fused basis
    # programs built from this map
    from repro_torch.core import exprops
    return {k: exprops.simplify(v) for k, v in out.items()}


def collective_counts(cfg: ArchConfig, kind, plan, mesh_shape:
                      Mapping[str, int]) -> Dict[str, ExprLike]:
    """Per-device collective *bytes* per step for a sharding plan.

    ``kind`` may be a phase string or anything with a ``.kind`` (a
    ``WorkloadSpec``/``ShapeConfig``) — collectives depend only on phase.

    Closed forms (ring algorithms, per-device traffic ≈ 2·(n−1)/n·bytes for
    all-reduce, (n−1)/n for all-gather / reduce-scatter):
      · DP gradients: all-reduce (replicated params) or reduce-scatter
        (FSDP, grads land sharded) — int8 compression divides by 4
      · FSDP param all-gather: 2·(fwd+bwd) per microbatch, bf16
      · TP activation collectives per layer (Megatron: 2 AR fwd (+2 bwd))
      · EP all-to-all dispatch+combine (MoE)
    """
    kind = getattr(kind, "kind", kind)
    bits = _bits(cfg)
    bytes_per = bits // 8
    dp = 1
    for ax in plan.dp_axes:
        dp *= mesh_shape.get(ax, 1)
    tp = mesh_shape.get(plan.tp_axis, 1) if plan.tp_axis else 1
    out: Dict[str, ExprLike] = {}
    T_dev = B * S / Const(max(dp, 1))  # tokens per device
    d = cfg.d_model
    M_ = plan.microbatches

    param_bytes_tp = cfg.n_params() * bytes_per / max(tp, 1)
    if plan.fsdp and dp > 1:
        # each microbatch re-gathers the dp-sharded params (fwd + bwd)
        n_gather = (2.0 * M_ if kind == "train" else 1.0)
        out[props.coll_key("all_gather")] = \
            n_gather * (dp - 1) / dp * param_bytes_tp
    if kind == "train" and dp > 1:
        grad_bytes = 4.0 * cfg.n_params() / max(tp, 1)  # f32 grads, TP-sharded
        if plan.compression == "int8_ef":
            grad_bytes /= 4.0
        if plan.fsdp:  # grads land sharded: reduce-scatter, 1× wire
            out[props.coll_key("reduce_scatter")] = \
                (dp - 1) / dp * grad_bytes
        else:
            out[props.coll_key("all_reduce")] = \
                2.0 * (dp - 1) / dp * grad_bytes
    if tp > 1 and cfg.n_heads:
        # Megatron TP: 2 all-reduces of the (T_dev × d) residual per layer
        # fwd (+2 bwd for train)
        n_ar = 2.0 * cfg.n_layers * (2.0 if kind == "train" else 1.0)
        if kind == "decode":
            act = as_expr(B) * d * bytes_per
        else:
            act = T_dev * d * bytes_per
        out[props.coll_key("all_reduce")] = out.get(
            props.coll_key("all_reduce"), as_expr(0)) \
            + as_expr(n_ar * 2.0 * (tp - 1) / tp) * act
    if cfg.moe is not None and plan.moe_mode == "ep" and tp > 1:
        tok = as_expr(B) if kind == "decode" else T_dev
        a2a = tok * d * bytes_per * cfg.moe.top_k * 2.0  # dispatch + combine
        out[props.coll_key("all_to_all")] = a2a * (tp - 1) / tp
    return out
