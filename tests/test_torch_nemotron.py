"""NVIDIA-Nemotron-3-Nano-30B-A3B in the port: the block pattern, Mamba2
with groups, the sigmoid-routed dropless MoE of relu² experts with its
shared expert, attention without RoPE, the decode caches and the system's
own counts.  The JAX package has none of these, so the port is held
against the plain reference ``bench/reference/nemotron-3-nano-30b-a3b.py``
and against loops written here, at a tiny size on the CPU in f32: the
two paths are written independently and agree to f32 rounding (2e-6 of
the logits' norm).  The card-only test runs one MoE layer at the
published widths with the device refusing any read back to the host."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "bench"))

from benchkit import manifest, program, weights  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.core import archcount, kernelmodel  # noqa: E402
from repro_torch.core import properties as props  # noqa: E402
from repro_torch.core import workload as wl  # noqa: E402
from repro_torch.benchmarks import predictor_validation as pv  # noqa: E402
from repro_torch.calibration import seeds  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import layers, moe, ssm, transformer  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.runtime import flags, steps  # noqa: E402

NAME = "nemotron-3-nano-30b-a3b"
REF = manifest.reference(NAME)
#: f32 on both sides: rounding alone
TOL = 2e-6


def tiny(groups: int = 8, pattern: str = "MEM*E", dtype: str = "float32"):
    """(ArchConfig, the reference's dict) of the registry's smoke variant:
    every kind of block, 16 SSD heads of 8 in ``groups`` groups, 8 experts
    top-3 with a shared expert of 48."""
    a = get_arch(NAME).reduced()
    a = dataclasses.replace(
        a, param_dtype=dtype, compute_dtype=dtype, block_pattern=pattern,
        n_layers=len(pattern),
        ssm=dataclasses.replace(a.ssm, heads=16, head_dim=8, n_groups=groups),
        moe=dataclasses.replace(a.moe, top_k=3))
    return a, dict(dataclasses.asdict(a), init_scale=0.02)


def model_and_weights(cfg_pair, seed=2**31 + 11):
    arch, cfg = cfg_pair
    w = weights.make(cfg, seed, "cpu", REF)
    return program.model_with(arch, w), w


def tokens(B=2, S=32, seed=0):
    return torch.randint(0, 256, (B, S),
                         generator=torch.Generator().manual_seed(seed))


def rel(a, b):
    return float((a - b).detach().norm() / b.detach().norm())


@pytest.mark.parametrize("groups", [8, 1])
@pytest.mark.parametrize("pattern", ["MEM*E", "*EM", "EEM*M"])
def test_logits_equal_the_reference(groups, pattern):
    arch, cfg = pair = tiny(groups, pattern)
    model, w = model_and_weights(pair)
    tok = tokens()
    got = transformer.forward(model, arch, {"tokens": tok})[0]
    record = {}
    want = REF.logits(w, cfg, tok, record=record)
    assert rel(got, want) < TOL
    assert len(record["picks"]) == pattern.count("E")


def test_prefill_then_decode_equal_the_references_full_forward():
    """The prompt fed through the caches (the server's prefill), then 4
    decode steps: every position's logits are the reference's over the
    whole sequence.  8 groups: the decode step's B / C by head."""
    arch, cfg = pair = tiny(groups=8)
    model, w = model_and_weights(pair)
    tok = tokens(2, 20, seed=3)
    want = REF.logits(w, cfg, tok)
    state = transformer.init_decode_state(arch, 2, 24, dtype=torch.float32,
                                          device="cpu")
    assert state["kv"].k.shape[0] == arch.blocks_of("*")
    assert state["ssm"].h.shape[:3] == (arch.blocks_of("M"), 2, 16)
    out = []
    with torch.no_grad():
        for t in range(20):
            logits, state = transformer.decode_step(model, arch, state,
                                                    tok[:, t:t + 1])
            out.append(logits)
    assert state["pos"] == 20
    assert rel(torch.cat(out, 1), want) < TOL
    # the decode step against a prefill of the same 16-token prompt
    pre = transformer.forward(model, arch, {"tokens": tok[:, :16]})[0]
    assert rel(torch.cat(out[:16], 1), pre) < TOL


def test_decode_reads_each_heads_group():
    """The decode step's state update with 8 groups equals the recurrence
    written with the group of each head by hand."""
    arch, _ = pair = tiny(groups=8)
    model, _ = model_and_weights(pair)
    p = model.blocks[0].mixer
    x = torch.randn(3, 1, arch.d_model, generator=torch.Generator()
                    .manual_seed(1))
    st = ssm.init_ssm_state(arch, 3, torch.float32, device="cpu")
    h0 = torch.randn(st.h.shape, generator=torch.Generator().manual_seed(2))
    st.h.copy_(h0)
    ssm.ssm_apply(p, x, arch, state=st)
    # by hand
    s, N, H, P, G = arch.ssm, arch.ssm.d_state, 16, 8, 8
    proj = p.in_proj(x)[:, 0]
    z, xbc, dt = proj.split([H * P, H * P + 2 * G * N, H], -1)
    conv = F.silu(xbc * p.conv_w[-1] + p.conv_b)       # the state was 0
    xs, Bm, Cm = conv.split([H * P, G * N, G * N], -1)
    dt = F.softplus(dt + p.dt_bias)
    A = -torch.exp(p.A_log)
    for h in range(H):
        g = h // (H // G)
        b = Bm[:, g * N:(g + 1) * N]
        upd = (dt[:, h, None, None] * xs[:, h * P:(h + 1) * P, None]
               * b[:, None, :])
        want = h0[:, h] * torch.exp(dt[:, h] * A[h])[:, None, None] + upd
        assert torch.allclose(st.h[:, h], want, atol=1e-6)


def test_group_norm_by_hand():
    g = torch.Generator().manual_seed(4)
    y, z = torch.randn(2, 5, 64, generator=g), torch.randn(2, 5, 64,
                                                           generator=g)
    scale = torch.rand(64, generator=g) + 0.5
    got = ssm.gated_norm(scale, y, z, 8, 1e-5)
    gated = y * F.silu(z)
    for k in range(8):
        sl = slice(8 * k, 8 * k + 8)
        want = layers.rmsnorm(scale[sl], gated[..., sl], 1e-5)
        assert torch.allclose(got[..., sl], want, atol=1e-6)
    # one group is today's norm, bit for bit
    one = ssm.gated_norm(scale.bfloat16(), y.bfloat16(), z.bfloat16(), 1,
                         1e-5)
    assert torch.equal(one, layers.rmsnorm(
        scale.bfloat16(), y.bfloat16() * F.silu(z.bfloat16()), 1e-5))


def _layer(seed=5, E=8, K=3, d=32, ff=16, sff=24):
    arch, _ = tiny()
    arch = dataclasses.replace(arch, d_model=d, d_ff=ff, moe=dataclasses
                               .replace(arch.moe, n_experts=E, top_k=K,
                                        shared_ff=sff))
    p = moe.MoE(arch, torch.float32, "cpu",
                torch.Generator().manual_seed(seed))
    with torch.no_grad():
        p.router_bias.normal_(0.0, 0.02, generator=torch.Generator()
                              .manual_seed(seed + 1))
    x = torch.randn(2, 12, d, generator=torch.Generator().manual_seed(seed))
    return arch, p, x


def test_dropless_layer_equals_a_loop_over_tokens_and_picks():
    arch, p, x = _layer()
    got, aux = moe.moe_apply(p, x, arch)
    assert float(aux) == 0.0
    r = moe.routing(p, x, arch)
    xt = x.reshape(-1, x.shape[-1])
    want = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for k in range(arch.moe.top_k):
            e = int(r.experts[t, k])
            h = torch.square(F.relu(xt[t] @ p.up[e])) @ p.down[e]
            want[t] += r.weights[t, k] * h
        want[t] += torch.square(F.relu(xt[t] @ p.shared_up)) @ p.shared_down
    assert rel(got.reshape(xt.shape), want) < TOL


def test_dispatch_sorts_the_picks_by_expert():
    E = 6
    experts = torch.tensor([[3, 0], [5, 3], [0, 2], [3, 5]])
    x = torch.arange(4.0)[:, None].expand(4, 3)
    rows, order, offsets = moe.dispatch(x, experts, E)
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == [2, 2, 3, 6, 6, 8]   # expert e's rows end
    ids = experts.reshape(-1)[order]
    assert ids.tolist() == sorted(ids.tolist())
    assert torch.equal(rows[:, 0], (order // 2).float())
    # put back in (token, k) order
    y = rows * 10
    back = moe.combine(y, order, torch.ones(4, 2))
    assert torch.equal(back, 20 * x)


def test_expert_products_follow_the_grouped_gemms_offsets():
    """The plain version (one product an expert) computes what
    ``torch._grouped_mm`` does with the same ``offsets``, empty experts
    included."""
    g = torch.Generator().manual_seed(6)
    E, d, ff = 5, 16, 8
    up, down = torch.randn(E, d, ff, generator=g), torch.randn(E, ff, d,
                                                               generator=g)
    x = torch.randn(11, d, generator=g)
    offsets = torch.tensor([3, 3, 7, 7, 11], dtype=torch.int32)
    got = moe.expert_products(x, offsets, up, down)
    h = torch._grouped_mm(x, up, offs=offsets)
    want = torch._grouped_mm(torch.square(F.relu(h)), down, offs=offsets)
    assert torch.allclose(got, want, atol=1e-5)


def test_router_bias_moves_the_picks_not_their_weights():
    arch, p, x = _layer(K=2)
    with torch.no_grad():
        p.router_bias.zero_()
    free = moe.routing(p, x, arch)
    assert torch.allclose(free.weights.sum(-1),
                          torch.full((x.shape[0] * x.shape[1],), 2.5))
    with torch.no_grad():
        p.router_bias[3] = 1.0     # expert 3 wins every token's first pick
    steered = moe.routing(p, x, arch)
    assert bool((steered.experts[:, 0] == 3).all())
    assert not torch.equal(steered.experts, free.experts)
    # the weights are the unbiased scores of the picks, renormalised
    s = torch.sigmoid(x.reshape(-1, x.shape[-1]) @ p.router)
    w = torch.gather(s, -1, steered.experts)
    assert torch.allclose(steered.weights, 2.5 * w / w.sum(-1, keepdim=True))
    assert torch.allclose(steered.weights.sum(-1),
                          torch.full_like(steered.weights[:, 0], 2.5))


@pytest.mark.parametrize("field,value", [("shared_ff", 48),
                                         ("routed_scale", 2.5)])
def test_the_gshard_path_refuses_what_it_does_not_compute(field, value):
    """GShard's dispatch computes no shared expert and no routed scale: a
    configuration that asks for one there is refused, not ignored."""
    arch, _ = tiny()
    bad = dataclasses.replace(arch, moe=dataclasses.replace(
        arch.moe, **{"dropless": False, "shared_ff": 0, "routed_scale": 1.0,
                     field: value}))
    with pytest.raises(ValueError, match="GShard"):
        moe.MoE(bad, torch.float32, "cpu", torch.Generator())
    moe.MoE(dataclasses.replace(bad, moe=dataclasses.replace(
        bad.moe, dropless=True)), torch.float32, "cpu", torch.Generator())


def test_a_train_step_holds_the_router_bias_fixed():
    """The correction bias steers the picks and gets no gradient: it is no
    trainable parameter, so the training step differentiates and updates
    every other one and leaves the bias as it was."""
    arch, _ = tiny()
    o = opt.get_optimizer("adamw")
    state = steps.init_train_state(arch, torch.Generator().manual_seed(0), o,
                                   device="cpu")
    model = state.params
    bias = {n for n, p in model.named_parameters()
            if n.endswith("moe.router_bias")}
    assert len(bias) == arch.blocks_of("E") == 2
    assert set(steps.trainable(model)) == \
        {n for n, _ in model.named_parameters()} - bias
    with torch.no_grad():
        for n in bias:
            model.get_parameter(n).normal_(0.0, 0.02)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tok = tokens()
    batch = {"tokens": tok, "labels": tok,
             "loss_mask": torch.ones(tok.shape)}
    state, metrics = steps.make_train_step(arch, o)(state, batch)
    assert torch.isfinite(metrics["loss"]) and float(metrics["grad_norm"]) > 0
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]) == (n in bias), n


def test_a_depth_cut_takes_the_patterns_first_blocks():
    full = get_arch(NAME)
    cut = dataclasses.replace(full, n_layers=7)
    assert cut.blocks == "MEMEM*E"
    assert [cut.blocks_of(k) for k in "ME*"] == [3, 3, 1]
    base = dataclasses.replace(full, n_layers=0).n_params()
    per = {k: dataclasses.replace(full, n_layers=1, block_pattern=k)
           .n_params() - base for k in "ME*"}
    assert cut.n_params() == base + 3 * per["M"] + 3 * per["E"] + per["*"]
    assert full.n_params() == base + sum(full.blocks_of(k) * per[k]
                                         for k in "ME*")
    small = dataclasses.replace(get_arch(NAME).reduced(), n_layers=3)
    model = transformer.Transformer(small, torch.device("meta"), None)
    assert [type(b) for b in model.blocks] == \
        [transformer.PATTERN_BLOCKS[c] for c in "MEM"]
    with pytest.raises(ValueError, match="block_pattern"):
        dataclasses.replace(small, n_layers=6)


def test_the_dry_run_skips_the_dropless_moe_with_its_reason():
    rec = dryrun.run_cell(NAME, "train_4k", multi_pod=False, verbose=False)
    assert rec["status"] == "skip" and rec["why"] == moe.NO_SHARDED_DISPATCH


def test_predictor_validation_trains_the_pattern_family(tmp_path,
                                                        monkeypatch):
    """``predictor_validation.run`` traces and times Nemotron's training
    step (its smoke variant on the CPU) beside the calibration arch."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / "experiments").mkdir()
    m = seeds.ANALYTIC_SEEDS["gpu-h100"]()
    m.device = "cpu-tiny"
    m.save(str(tmp_path / "experiments" / "torch_model_cpu-tiny_tiny.json"))
    res = pv.run(scale="tiny", B=2, S=32, device="cpu",
                 archs=[pv.CALIBRATION_ARCH, NAME], verbose=False)
    row = next(r for r in res["rows"] if r["arch"] == NAME)
    assert row["status"] == "ok" and row["layers_run"] == row["layers"] == 5
    assert row["predicted_ms"] > 0 and row["actual_ms"] > 0
    assert row["flops"] > 0 and "mxu:16" not in row["unpriced"]


def test_nope_attention_turns_nothing():
    """Without RoPE a block's attention does not depend on where the
    sequence starts: the last row of a shifted cache equals it."""
    arch, _ = tiny(pattern="*")
    model, _ = model_and_weights((arch, dict(dataclasses.asdict(arch),
                                             init_scale=0.02)))
    tok = tokens(1, 8)
    a = transformer.forward(model, arch, {"tokens": tok})[0]
    roped = dataclasses.replace(arch, use_rope=True)
    b = transformer.forward(model, roped, {"tokens": tok})[0]
    assert not torch.allclose(a, b)
    # a single token attends only to itself: the same at any position
    one = transformer.forward(model, arch, {"tokens": tok[:, :1]})[0]
    assert torch.allclose(one[0, 0], a[0, 0], atol=1e-6)


# ---------------------------------------------------------------------------
# the system's own counts
# ---------------------------------------------------------------------------


def test_n_params_is_the_published_count():
    arch = get_arch(NAME)
    assert arch.n_params() == 31_577_940_288
    assert arch.n_params() == sum(
        p.numel() for p in transformer.Transformer(
            arch, torch.device("meta"), None).parameters())
    small = tiny()[0]
    assert small.n_params() == sum(p.numel() for p in transformer
                                   .Transformer(small, torch.device("meta"),
                                                None).parameters())
    # active: 6 of 128 routed experts a block
    assert arch.n_active_params() == arch.n_params() \
        - 23 * 122 * 2 * 2688 * 1856


def _score_terms(arch, B, S):
    """The terms archcount and the reference count by different
    conventions, per token as MACs: archcount's chunked SSD and conv and
    its mean causal context, the reference's recurrent SSD and exact
    visible pairs."""
    s = arch.ssm
    nM, nA = arch.blocks_of("M"), arch.blocks_of("*")
    ours = nM * (arch.ssm_heads * (s.chunk * s.d_state + s.chunk * s.head_dim
                                   + 2 * s.head_dim * s.d_state)
                 + (arch.d_inner + 2 * s.n_groups * s.d_state) * s.d_conv) \
        + nA * arch.n_heads * arch.head_dim_ * S
    theirs = nM * 2 * arch.ssm_heads * s.d_state * s.head_dim \
        + nA * 2 * arch.n_heads * arch.head_dim_ * (S + 1) / 2 * 1.0
    return ours, theirs


@pytest.mark.parametrize("B,S", [(4, 2048), (1, 512)])
def test_archcount_macs_are_the_references_flops(B, S):
    """Per token, archcount's MACs of a forward pass by the pattern (23
    SSD, 23 MoE with the router, 6 routed and the shared expert and no
    capacity slack, 6 attention blocks, the head) are the reference's
    ``forward_flops`` ÷ 2, the SSD and attention scores aside (counted
    by each side's own convention, ``_score_terms``)."""
    arch = get_arch(NAME)
    cfg = dict(dataclasses.asdict(arch))
    T = B * S
    mxu = archcount.forward_counts(arch)[props.mxu_key(16)]
    macs = mxu.eval({"B": B, "S": S}) / 2 / T
    ours, theirs = _score_terms(arch, B, S)
    want = REF.forward_flops(cfg, B, S) / 2 / T
    assert macs - ours == pytest.approx(want - theirs, rel=1e-12)
    # the parts by hand: 23 MoE blocks of router + 6 routed + shared
    d = 2688
    moe_macs = d * 128 + 2 * d * (6 * 1856 + 3712)
    assert archcount._dropless_moe_macs(arch) == moe_macs


def test_kernelmodel_prices_the_pattern():
    """The card's composition: the dropless MoE's products as GEMMs (no
    dispatch einsum), attention at 6 blocks, the SSD at 23; its mxu total
    agrees with archcount's in the leading term."""
    arch = get_arch(NAME)
    spec = wl.WorkloadSpec(phase="prefill", global_batch=4, seq_len=2048)
    vec = kernelmodel.step_kernel_vectors(arch, spec)
    env = {"B": 4, "S": 2048}
    key = props.mxu_key(16)
    total = sum(float(v[key].eval(env)) if hasattr(v[key], "eval")
                else float(v[key]) for v in vec.values() if key in v)
    want = float(archcount.forward_counts(arch)[key].eval(env))
    assert total == pytest.approx(want, rel=2e-3)
    conv = 23 * (4096 + 2 * 8 * 128) * 4 * 2 * 8192
    assert float(vec["unkernelized"][key].eval(env)) == pytest.approx(conv)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the grouped GEMM runs on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_moe_layer_reads_nothing_back_to_the_host(cuda):
    """One MoE block at the published widths (128 experts of 1856 top-6,
    the shared expert, 4 × 2048 tokens): routed, dispatched, computed and
    combined with every synchronising call refused, and equal bit for bit
    to the plain version (one product an expert), as the card reads it."""
    arch = get_arch(NAME)
    p = moe.MoE(arch, torch.bfloat16, cuda,
                torch.Generator(cuda).manual_seed(0))
    with torch.no_grad():
        p.router_bias.normal_(0.0, 0.02, generator=torch.Generator(cuda)
                              .manual_seed(1))
    x = torch.randn(4, 2048, arch.d_model, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2)) \
        .bfloat16()
    with torch.no_grad():
        moe.moe_apply(p, x, arch)          # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, _ = moe.moe_apply(p, x, arch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        with flags.use_kernels(False):
            want, _ = moe.moe_apply(p, x, arch)
    err = float((got.float() - want.float()).norm() / want.float().norm())
    assert torch.equal(got, want), err
