"""NVIDIA-Nemotron-3-Nano-30B-A3B's files: the configuration builds the
registry's model, the reference module's weights are the program's
parameters (31,577,940,288 of them) and its FLOPs and routed layers are
counted by hand, a small run of ``nemotron-prefill`` is correct with a
finite regret and falls for a fault, and the experts' roofline reader
counts its bound by hand."""
import time

import pytest
import torch

import _bench_tiny
from benchkit import cells, manifest, prefill, program, weights
from benchkit.window import Result
from repro_torch.configs.registry import get_arch
from repro_torch.models import transformer

MAN = manifest.manifest()
NAME = "nemotron-3-nano-30b-a3b"
CELL = "nemotron-prefill"
REF = manifest.reference(NAME)
SEED = 2**31 + 37


def tiny_files(dtype: str = "bfloat16"):
    """The cell's configuration cut to a few dozen (every kind of block,
    16 SSD heads in 8 groups, 8 experts top-3 with the shared expert; the
    catalog's copies left out) and its traffic at 2 × 64 tokens."""
    cfg = manifest.config(MAN, NAME)
    cfg = {k: v for k, v in cfg.items() if k not in cfg["published"]}
    cfg.update(published={}, n_layers=5, block_pattern="MEM*E", d_model=64,
               n_heads=4, n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
               param_dtype=dtype, compute_dtype=dtype, norm_eps=1e-5,
               rope_theta=10000.0, sliding_window=None)
    cfg["ssm"] = dict(cfg["ssm"], d_state=16, head_dim=8, heads=16,
                      n_groups=8, chunk=16)
    cfg["moe"] = dict(cfg["moe"], n_experts=8, top_k=3, shared_ff=48)
    traffic = manifest.traffic(manifest.cell(MAN, CELL)["traffic"])
    traffic.update(batch=_bench_tiny.B, seq_len=_bench_tiny.S)
    return cfg, traffic


def test_arch_config_builds_the_registrys_model():
    cfg = manifest.config(MAN, NAME)
    assert program.arch_config(cfg) == get_arch(NAME)
    assert cfg["reduced"] == []
    assert cfg["block_pattern"] == cfg["published"][
        "hybrid_override_pattern"]


def test_param_spec_is_the_programs_parameters():
    cfg = manifest.config(MAN, NAME)
    spec = weights.param_spec(cfg, REF)
    model = transformer.Transformer(get_arch(NAME), torch.device("meta"),
                                    None)
    have = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    assert {x.name: (x.shape, x.dtype) for x in spec} == have
    assert weights.n_params(cfg, REF) == 31_577_940_288
    assert weights.n_params(cfg, REF) == get_arch(NAME).n_params()
    # the router and its correction bias are drawn, in f32
    init = {x.name: (x.dtype, x.init) for x in spec}
    assert init["blocks.1.moe.router_bias"] == (torch.float32, "normal")
    assert init["blocks.1.moe.router"] == (torch.float32, "normal")


def test_forward_flops_by_hand():
    """At one token: a Mamba2 block's in_proj 10304 × 2688 and out_proj
    2688 × 4096 and the SSD's 4·64·128·64; an MoE block's router 128,
    6 routed experts and the shared one, up and down; an attention
    block's q, k, v, o and its one visible pair; the head."""
    cfg = manifest.config(MAN, NAME)
    d = 2688
    mamba = 2 * d * 10304 + 2 * 4096 * d + 4 * 64 * 128 * 64
    moe = 2 * d * 128 + 2 * 2 * d * (6 * 1856 + 3712)
    attn = 2 * d * (2 * 32 * 128 + 2 * 2 * 128) + 4 * 32 * 128
    want = 23 * mamba + 23 * moe + 6 * attn + 2 * d * 131072
    assert REF.forward_flops(cfg, 1, 1) == want
    # 4 × 2048: the pairs of a causal sequence, S (S + 1) / 2
    pairs = 6 * 4 * 4 * 32 * 128 * (2048 * 2049 // 2 - 2048)
    assert REF.forward_flops(cfg, 4, 2048) == 8192 * want + pairs


def test_routed_layers_are_the_moe_blocks():
    cfg = manifest.config(MAN, NAME)
    assert REF.routed_layers(cfg) == prefill.routed_layers(cfg, REF) == 23


def _run(cfg, traffic, **kw):
    return cells.measure(CELL, SEED, 0.2, False, time.perf_counter(),
                         device="cpu", cfg=cfg, traffic=traffic, **kw)


def test_a_small_run_is_correct_with_a_finite_regret():
    cfg, traffic = tiny_files()
    line, res = _run(cfg, traffic)
    assert line["correct"], line["compared"]
    assert 0.0 <= res.numbers["route_regret"] < float("inf")
    assert res.numbers["logit_err"] < manifest.limits(CELL)["limits"][
        "logit_err"]


def test_the_check_replays_the_programs_picks():
    """In f32 the program's picks are the reference's own: the regret is
    0 and the logits agree to rounding."""
    cfg, traffic = tiny_files("float32")
    _, res = _run(cfg, traffic)
    assert res.numbers["route_regret"] == 0.0
    assert res.numbers["logit_err"] < 1e-5


def test_a_stale_step_is_not_correct(monkeypatch):
    from repro_torch.runtime import steps
    make = steps.make_prefill_step

    def stale(cfg, **kw):
        step, first = make(cfg, **kw), []

        def broken(model, batch):
            if not first:
                first.append(step(model, batch))
            return first[0]
        return broken

    monkeypatch.setattr(steps, "make_prefill_step", stale)
    cfg, traffic = tiny_files()
    line, _ = _run(cfg, traffic)
    assert not line["correct"]


def test_the_control_reads_above_the_program():
    cfg, traffic = tiny_files()
    w = weights.make(cfg, SEED, "cpu", REF)
    g = torch.Generator().manual_seed(SEED * 2 + 1)
    tok = torch.randint(0, cfg["vocab_size"], (traffic["batch"],
                                               traffic["seq_len"]),
                        generator=g, dtype=torch.int32)
    low = prefill.control_step(cfg, REF, w, tok)
    _, res = _run(cfg, traffic)
    assert low["logit_err"] >= 3 * res.numbers["logit_err"]


def test_experts_roofline_bound_by_hand():
    r = manifest.reader("moe_experts_roofline.prefill")
    assert r.ENTRY[:2] == ("repro_torch.models.moe", "expert_products")
    x = torch.empty(49152, 2688, dtype=torch.bfloat16, device="meta")
    up = torch.empty(128, 2688, 1856, dtype=torch.bfloat16, device="meta")
    down = torch.empty(128, 1856, 2688, dtype=torch.bfloat16, device="meta")
    c = r.ENTRY[2](x, None, up, down)
    assert c == {"rows": 49152, "E": 128, "d": 2688, "ff": 1856,
                 "itemsize": 2}
    ops = 4 * 49152 * 2688 * 1856
    nbytes = 2 * (128 * 2 * 2688 * 1856 + 2 * 49152 * 2688)
    assert r.bound_s(c) == pytest.approx(max(ops / 989e12,
                                             nbytes / 3.35e12))
    # 0.99 ms by operations, 0.92 by bytes: on the ridge
    assert ops / 989e12 == pytest.approx(0.99e-3, rel=0.01)
    ctx = cells.Context({"name": CELL}, {}, {"kind": "prefill"},
                        Result(calls={"expert_products": [c, c]},
                               profile={"spans": {"expert_products":
                                                  [2e-3, 2e-3]}}))
    assert r.read(ctx) == pytest.approx(100 * r.bound_s(c) / 2e-3)
    # nothing to read outside a traced run
    assert r.read(cells.Context({}, {}, {"kind": "prefill"},
                                Result())) is None


def test_the_programs_dropless_layer_takes_the_readers_entry():
    """The layer looks ``expert_products`` up at call time, so the traced
    window's wrapper sees every MoE block's call."""
    from repro_torch.models import moe
    cfg, traffic = tiny_files("float32")
    arch = program.arch_config(cfg)
    seen = []
    orig = moe.expert_products

    def spy(*a, **k):
        seen.append(a[0].shape)
        return orig(*a, **k)

    moe.expert_products = spy
    try:
        model = transformer.init_params(arch, device="cpu")
        with torch.no_grad():
            transformer.forward(model, arch, {"tokens": torch.zeros(
                (2, 16), dtype=torch.long)})
    finally:
        moe.expert_products = orig
    assert seen == [torch.Size([2 * 16 * 3, 64])] * arch.blocks_of("E")
