"""The benchmark's counts of operations, bytes and model FLOPs against
values worked out by hand, and the readers that divide them by time."""
import math

import pytest

import _bench_tiny  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import cells, counts, manifest, weights
from benchkit.window import Result


def test_visible_pairs():
    assert counts.visible_pairs(4, 4, True, None) == 1 + 2 + 3 + 4
    assert counts.visible_pairs(4, 4, True, 2) == 1 + 2 + 2 + 2
    assert counts.visible_pairs(4, 4, False, None) == 16
    # queries at the end of a longer key sequence
    assert counts.visible_pairs(2, 4, True, None) == 3 + 4
    S = 2048
    assert counts.visible_pairs(S, S, True, 4096) == S * (S + 1) // 2


def test_attention_counts():
    assert counts.attention_ops(1, 2, 4, 4, 8) == 4 * 2 * 10 * 8
    assert counts.attention_ops(2, 2, 4, 4, 8, window=2) == 4 * 2 * 2 * 7 * 8
    # q (1,4,2,8) and o: 64 each; k, v (1,4,1,8): 32 each; bf16
    assert counts.attention_bytes(1, 2, 1, 4, 4, 8, 2) == (128 + 64) * 2
    assert counts.attention_bytes(1, 2, 1, 4, 4, 8, 2, lse=True) \
        == 384 + 2 * 4 * 4


def test_ssd_counts():
    assert counts.ssd_ops(1, 2, 4, 3, 5) == 4 * 2 * 4 * 3 * 5
    # x 40 el · 2 B, dt 8 · 4, A 2 · 4, B and C 12 el each · 2, y 40 · 2
    assert counts.ssd_bytes(1, 2, 4, 5, 1, 3, 2, 4, 4, 2, 2) \
        == 80 + 32 + 8 + 48 + 80


def test_bound_is_the_slower_of_compute_and_memory():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


MOE = {"family": "moe", "n_layers": 1, "d_model": 4, "n_heads": 2,
       "n_kv_heads": 1, "head_dim": 2, "d_ff": 6, "vocab_size": 10,
       "sliding_window": None,
       "moe": {"n_experts": 4, "top_k": 2}}
HYBRID = {"family": "hybrid", "n_layers": 2, "d_model": 4, "n_heads": 2,
          "n_kv_heads": 2, "head_dim": 2, "d_ff": 6, "vocab_size": 10,
          "sliding_window": None, "hybrid": {"attn_every": 2},
          "ssm": {"d_state": 2, "d_conv": 4, "expand": 2, "head_dim": 2,
                  "n_groups": 1}}


def test_forward_flops_by_hand():
    # B=1, S=3: the head, q k v o and the 1 + 2 + 3 visible pairs
    head = 2 * 3 * 4 * 10
    attn = 2 * 3 * 4 * (2 * 2 * 2 + 2 * 1 * 2) + 4 * 2 * 6 * 2
    router = 2 * 3 * 4 * 4
    experts = 2 * (2 * 3 * 3 * 4 * 6)      # top-2 of 4, no slack
    assert counts.forward_flops(MOE, 1, 3) == head + attn + router + experts
    # d_inner 8, 4 heads, conv 12, in_proj 4 -> 24
    ssm = 2 * 3 * 4 * 24 + 2 * 3 * 8 * 4 + 4 * 4 * 3 * 2 * 2
    site = 2 * 3 * 4 * 16 + 4 * 2 * 6 * 2 + 2 * 3 * 3 * 4 * 6
    assert counts.forward_flops(HYBRID, 1, 3) == head + 2 * ssm + site
    assert counts.train_flops(HYBRID, 1, 3) == \
        3 * counts.forward_flops(HYBRID, 1, 3)


@pytest.mark.parametrize("name", ["zamba2-2.7b", "mixtral-8x7b-16l",
                                  "mamba2-370m"])
def test_forward_flops_follow_the_weights(name):
    """At one token the model FLOPs are twice the weights the token
    multiplies (experts: top_k of n_experts; no embedding lookup, no conv;
    a tied head once), plus one attention pair a head and the SSD's
    4·H·N·P."""
    cfg = manifest.config(manifest.manifest(), name)
    moe = cfg.get("moe")
    if cfg["family"] == "hybrid":
        sites = cfg["n_layers"] // cfg["hybrid"]["attn_every"]
    else:
        sites = 0 if cfg["family"] == "ssm" else cfg["n_layers"]
    mult = 0
    for leaf in weights.param_spec(cfg):
        n = math.prod(leaf.shape)
        if leaf.init != "normal" or len(leaf.shape) < 2 \
                or leaf.name == "embed.weight" or "conv_w" in leaf.name:
            continue
        if moe and leaf.name.split(".")[-1] in ("gate", "up", "down") \
                and ".moe." in leaf.name:
            n = n * moe["top_k"] // moe["n_experts"]
        if leaf.name.startswith("shared."):
            n *= sites   # the one shared block, applied at every site
        mult += n
    if cfg["tie_embeddings"]:
        mult += cfg["vocab_size"] * cfg["d_model"]   # the head
    extra = 0
    if cfg.get("ssm"):
        z = weights.ssm_sizes(cfg)
        s = cfg["ssm"]
        extra += cfg["n_layers"] * 4 * z["heads"] * s["d_state"] \
            * s["head_dim"]
    extra += sites * 4 * cfg["n_heads"] * cfg["head_dim"]
    assert counts.forward_flops(cfg, 1, 1) == 2 * mult + extra


def test_published_sizes():
    man = manifest.manifest()
    z = manifest.config(man, "zamba2-2.7b")
    m = manifest.config(man, "mixtral-8x7b-16l")
    # by hand: 54 × 39,888,240 (in_proj 2560 × 10448, conv, A_log, D,
    # dt_bias, norm, out_proj, ln) + the shared block 104,862,720 + the
    # embedding and the head 2 × 81,920,000 + the final norm
    assert weights.n_params(z) == 54 * 39888240 + 104862720 \
        + 163840000 + 2560
    # a layer: 8 experts × 3 × 4096 × 14336, q k v o 41,943,040, the
    # router 32,768, two norms; the embedding and the head 2 × 131,072,000
    layer = 8 * 3 * 4096 * 14336 + 41943040 + 32768 + 8192
    assert weights.n_params(m) == 16 * layer + 262144000 + 4096


def _ctx(kind, cfg, traffic, **res):
    return cells.Context({}, cfg, traffic, Result(**res))


def test_mfu_and_roofline_readers():
    man = manifest.manifest()
    cfg = manifest.config(man, "zamba2-2.7b")
    t = {"kind": "prefill", "batch": 4, "seq_len": 2048}
    flops = counts.forward_flops(cfg, 4, 2048)
    step = flops / counts.PEAK_FLOPS / 0.25   # a step at 25 % of the peak
    ctx = _ctx("prefill", cfg, t, timed_s=[step, step])
    assert manifest.reader("mfu.prefill").read(ctx) == pytest.approx(25.0)
    assert manifest.reader("mfu.train").read(ctx) is None
    shape = {"B": 4, "Hq": 32, "Hkv": 32, "Sq": 2048, "Skv": 2048, "dh": 80,
             "causal": True, "window": None, "lse": False, "itemsize": 2}
    fa = manifest.reader("flash_attention_roofline")
    bound = fa.bound_s(shape)
    ctx = _ctx("prefill", cfg, t, calls={"flash_attention": [shape] * 3},
               profile={"spans": {"flash_attention": [2 * bound] * 3},
                        "busy_s": 0.75, "window_s": 1.0})
    assert fa.read(ctx) == pytest.approx(50.0)
    assert manifest.reader("device_idle_pct.prefill").read(ctx) \
        == pytest.approx(25.0)
    assert manifest.reader("ssd_scan_roofline.prefill").read(ctx) is None
    ctx.result.calls["flash_attention"] = [shape] * 2
    with pytest.raises(RuntimeError):
        fa.read(ctx)


def test_trainer_host_and_memory_readers():
    ctx = _ctx("train", {}, {"kind": "train"}, host_ms=[2.0, 4.0],
               window_peak_bytes=3 * 2**30)
    assert manifest.reader("trainer_host_ms.train").read(ctx) == 3.0
    assert manifest.reader("peak_mem_gib.train").read(ctx) == 3.0
    assert manifest.reader("peak_mem_gib.prefill").read(ctx) is None
    assert manifest.reader("ssd_scan_roofline.train").read(ctx) is None
