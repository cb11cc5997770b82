"""An architecture's particulars come with its own files: the configuration
file's keys pass to the program's ``ArchConfig`` by its fields, the
reference module's ``param_spec`` / ``forward_flops`` / ``routed_layers``
replace the functions for today's families, the readers declare the entry
points the traced window wraps, and the traced run hands them the
program's spans.  Today's configurations keep their configs, weights and
counts."""
import dataclasses
import hashlib
import math
import time
from typing import Optional

import pytest
import torch

import _bench_tiny
from benchkit import (cells, counts, entries, manifest, prefill, program,
                      weights)
from benchkit.window import Result, Window
from repro_torch.configs.base import (ArchConfig, HybridConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.configs.registry import get_arch
from repro_torch.models import moe as program_moe
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime import steps

MAN = manifest.manifest()
TODAY = ["zamba2-2.7b", "mixtral-8x7b-16l"]
SEED = 2**31 + 29
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}

# ---------------------------------------------------------------------------
# (a) the configuration as the program's ArchConfig
# ---------------------------------------------------------------------------

#: the keys the harness passed before it read ``ArchConfig``'s fields
FIXED = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
         "d_ff", "vocab_size", "head_dim", "rope_theta", "sliding_window",
         "norm_eps", "tie_embeddings", "param_dtype", "compute_dtype",
         "optimizer", "remat_policy")


def fixed_list_arch_config(cfg: dict) -> ArchConfig:
    """``program.arch_config`` as it was: a fixed list of keys and four of
    the MoE's."""
    kw = {k: cfg[k] for k in FIXED}
    if cfg.get("ssm"):
        kw["ssm"] = SSMConfig(**cfg["ssm"])
    if cfg.get("hybrid"):
        kw["hybrid"] = HybridConfig(**cfg["hybrid"])
    moe = cfg.get("moe")
    if moe:
        kw["moe"] = MoEConfig(n_experts=moe["n_experts"], top_k=moe["top_k"],
                              capacity_factor=moe["capacity_factor"],
                              aux_loss_weight=moe["aux_loss_weight"])
    return ArchConfig(**kw)


@pytest.mark.parametrize("name", TODAY)
def test_arch_config_equals_the_fixed_lists(name):
    cfg = manifest.config(MAN, name)
    assert program.arch_config(cfg) == fixed_list_arch_config(cfg)


def test_mamba2_file_states_the_registrys_model():
    """The registry's model, with the release's padded vocabulary (the
    registry pads 50,277 tokens to 50280, the release to 50288)."""
    cfg = manifest.config(MAN, "mamba2-370m")
    assert program.arch_config(cfg) == dataclasses.replace(
        get_arch("mamba2-370m"), vocab_size=50288)


@pytest.mark.parametrize("where,key", [
    ("", "layer_pattern"), ("ssm", "n_heads"),
    ("moe", "shared_expert_width")])
def test_arch_config_refuses_a_key_the_program_does_not_know(where, key):
    name = "mixtral-8x7b-16l" if where != "ssm" else "zamba2-2.7b"
    cfg = manifest.config(MAN, name)
    (cfg[where] if where else cfg)[key] = 1
    path = f"{where}.{key}" if where else key
    with pytest.raises(ValueError, match=repr(path)):
        program.arch_config(cfg)


@pytest.mark.parametrize("top,published,reduced,refused", [
    ({"hidden_size": 4096}, {"hidden_size": 4096}, [], None),
    ({"hidden_size": 2048}, {"hidden_size": 4096}, ["hidden_size"], None),
    ({"hidden_size": 2048}, {"hidden_size": 4096}, [], "'hidden_size'"),
    ({"hidden_size": 4096}, {}, [], "'hidden_size'"),
    ({"vocab_size": 256}, {"vocab_size": 32000}, [], "'vocab_size'"),
])
def test_a_key_of_the_source_passes_as_a_copy_of_published(
        top, published, reduced, refused):
    """A catalog model's file holds the catalog's config at the top level:
    a key that names no field passes where ``published`` holds it, at its
    value or named in ``reduced``; any other is refused, and so is a field
    that departs from ``published`` unnamed."""
    cfg = manifest.config(MAN, "mixtral-8x7b-16l")
    base = program.arch_config(cfg)
    cfg.update(top, published=dict(cfg["published"], **published),
               reduced=cfg["reduced"] + reduced)
    if refused is None:
        assert program.arch_config(cfg) == base
    else:
        with pytest.raises(ValueError, match=refused):
            program.arch_config(cfg)


def test_group_tokens_is_checked_where_given():
    cfg = manifest.config(MAN, "mixtral-8x7b-16l")
    cfg["moe"] = dict(cfg["moe"], group_tokens=program_moe.GROUP_TOKENS * 2)
    with pytest.raises(ValueError, match="groups of"):
        program.arch_config(cfg)
    del cfg["moe"]["group_tokens"]
    assert program.arch_config(cfg).moe == MoEConfig(
        n_experts=8, top_k=2, capacity_factor=1.25, aux_loss_weight=0.01)


def test_a_field_the_program_adds_passes_through(monkeypatch):
    """A field a later ``ArchConfig`` has, and a later group's, reach the
    program with no edit of the harness; lists become tuples."""
    @dataclasses.dataclass(frozen=True)
    class Shared:
        width: int = 0

    @dataclasses.dataclass(frozen=True)
    class Later(ArchConfig):
        layer_pattern: str = ""
        shared: Optional[Shared] = None

    monkeypatch.setattr(program, "ArchConfig", Later)
    cfg = manifest.config(MAN, "mixtral-8x7b-16l")
    cfg.update(layer_pattern="MEM*", shared={"width": 3712},
               mrope_sections=[2, 3, 3])
    arch = program.arch_config(cfg)
    assert arch.layer_pattern == "MEM*"
    assert arch.shared == Shared(width=3712)
    assert arch.mrope_sections == (2, 3, 3)


# ---------------------------------------------------------------------------
# (b) today's configurations: the same leaves, weights and counts
# ---------------------------------------------------------------------------

#: (leaves, parameters, sha256 of "name shape dtype init" a line) of the
#: harness before the reference modules could bring their own leaves
LEAVES = {
    "zamba2-2.7b": (498, 2422670240, "e5b0085ebe54f88624f88cab9e962da4"
                    "04e077dc7a7e7f78083f48cca1cd0c57"),
    "mixtral-8x7b-16l": (163, 23482470400, "88e7e93c727ee05928ca6ae0d3e2da75"
                         "288a33d6102f10ab2f0a532f739115b4"),
}
#: forward FLOPs at 4 x 2048, training FLOPs at 2 x 4096, the same
FLOPS = {"zamba2-2.7b": (53417691054080, 162572355502080),
         "mixtral-8x7b-16l": (107710263590912, 329727860539392)}
#: sha256 of the names and bits of the small configurations' weights, seed
#: 2**31 + 3, on the CPU
TINY_WEIGHTS = {
    "zamba2-2.7b": "2c0fcacbc70cd0446eb4ae5ec92f71af"
                   "790b9449eb8142b4f1218c19146398de",
    "mixtral-8x7b-16l": "8c852169ae3b73a57f7794a297f618e5"
                        "d741398f7110bbf8a2b54c1fa6a94354"}


def _leaf_digest(spec):
    lines = "\n".join(f"{x.name} {tuple(x.shape)} {x.dtype} {x.init}"
                      for x in spec)
    return hashlib.sha256(lines.encode()).hexdigest()


@pytest.mark.parametrize("name", TODAY)
def test_todays_leaves_and_counts_are_unchanged(name):
    cfg = manifest.config(MAN, name)
    ref = manifest.reference(name)
    spec = weights.param_spec(cfg, ref)
    assert spec == weights.param_spec(cfg)
    n, total, digest = LEAVES[name]
    assert (len(spec), weights.n_params(cfg, ref), _leaf_digest(spec)) \
        == (n, total, digest)
    fwd, trn = FLOPS[name]
    assert counts.forward_flops(cfg, 4, 2048, ref) == fwd
    assert counts.train_flops(cfg, 2, 4096, ref) == trn
    assert prefill.routed_layers(cfg, ref) == cfg["n_layers"]


@pytest.mark.parametrize("name", TODAY)
def test_todays_weights_are_bit_equal(name):
    cfg = _bench_tiny.config(name)
    w = weights.make(cfg, 2**31 + 3, "cpu", manifest.reference(name))
    h = hashlib.sha256()
    for n, t in w.items():
        h.update(n.encode())
        bits = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                   else torch.uint8)
        h.update(bits.numpy().tobytes())
    assert h.hexdigest() == TINY_WEIGHTS[name]


def test_mamba2_published_size():
    """By hand: a layer is the norm 1024, in_proj 4384 x 1024 (z 2048, xBC
    2048 + 2 x 128, dt 32), conv 4 x 2304 and its bias, A_log, D, dt_bias
    32 each, the gated norm 2048 and out_proj 1024 x 2048; the tied
    embedding 50288 x 1024 and the final norm."""
    cfg = manifest.config(MAN, "mamba2-370m")
    layer = 1024 + 4384 * 1024 + 4 * 2304 + 2304 + 3 * 32 + 2048 \
        + 1024 * 2048
    assert weights.n_params(cfg) == 48 * layer + 50288 * 1024 + 1024
    assert weights.n_params(cfg) == get_arch("mamba2-370m").n_params() \
        + 8 * 1024


# ---------------------------------------------------------------------------
# (c) a configuration's reference module brings its own shape functions
# ---------------------------------------------------------------------------


def own_functions(config_name: str, routed_delta: int = 0):
    """A fresh copy of the configuration's reference module that defines
    the three shape functions, each counting its calls: the default leaves
    in reverse order, twice the default FLOPs, and the layers routed."""
    ref = manifest.reference(config_name)
    ref.used = {"param_spec": 0, "forward_flops": 0, "routed_layers": 0}

    def param_spec(cfg):
        ref.used["param_spec"] += 1
        return weights.param_spec(cfg)[::-1]

    def forward_flops(cfg, B, S):
        ref.used["forward_flops"] += 1
        return 2 * counts.forward_flops(cfg, B, S)

    def routed_layers(cfg):
        ref.used["routed_layers"] += 1
        return cfg["n_layers"] + routed_delta

    ref.param_spec = param_spec
    ref.forward_flops = forward_flops
    ref.routed_layers = routed_layers
    return ref


@pytest.mark.parametrize("cell,mfu,factor", [
    ("mixtral-prefill", "mfu.prefill", 1), ("zamba2-train", "mfu.train", 3)])
def test_a_cell_runs_on_its_reference_modules_functions(cell, mfu, factor):
    c, cfg, traffic = _bench_tiny.cell_files(cell)
    ref = own_functions(c["config"])
    line, res = cells.measure(cell, SEED, 0.2, True, time.perf_counter(),
                              device="cpu", cfg=cfg, traffic=traffic, ref=ref)
    assert line["correct"], line["compared"]
    # the weights of the program and of the reference's check: the
    # module's leaves (the prefill driver makes them once, training twice:
    # for the trainer and for the reference's steps)
    assert ref.used["param_spec"] == (1 if traffic["kind"] == "prefill"
                                      else 2)
    assert ref.used["forward_flops"] == 1
    flops = 2 * factor * counts.forward_flops(cfg, traffic["batch"],
                                              traffic["seq_len"])
    step = sum(res.timed_s) / len(res.timed_s)
    assert line["metrics"][mfu]["value"] == pytest.approx(
        100.0 * flops / (counts.PEAK_FLOPS * step))
    if cfg.get("moe"):   # once a sampled step
        assert ref.used["routed_layers"] \
            == min(res.steps, traffic["sampled_steps"])


def test_a_cell_takes_its_reference_modules_routed_layers():
    """Picks of every layer where the module routes one more than there are
    are no routing: the regret is infinite and the run not correct."""
    c, cfg, traffic = _bench_tiny.cell_files("mixtral-prefill")
    ref = own_functions(c["config"], routed_delta=1)
    out = cells.run_cell("mixtral-prefill", SEED, 0.2, False,
                         time.perf_counter(), device="cpu", cfg=cfg,
                         traffic=traffic, ref=ref)
    assert ref.used["routed_layers"] \
        == min(out["attempted"], traffic["sampled_steps"])
    assert out["compared"]["route_regret"]["value"] == float("inf")
    assert not out["correct"]


# ---------------------------------------------------------------------------
# (d) the prefill check takes the routed layers' picks
# ---------------------------------------------------------------------------


class Routed:
    """A reference with ``n`` routed layers: it hands back the logits it
    is given and the same router probabilities in every routed layer."""

    def __init__(self, n: int, out: torch.Tensor, probs: torch.Tensor):
        self.n, self.out, self.probs = n, out, probs
        self.replayed = None

    def routed_layers(self, cfg):
        return self.n

    def logits(self, weights, cfg, tokens, precision, picks=None,
               record=None):
        self.replayed = picks
        record["probs"] = [self.probs] * self.n
        return self.out


@pytest.mark.parametrize("n_picked,finite", [(3, True), (2, False),
                                             (4, False)])
def test_check_step_regret_is_finite_for_the_routed_layers(n_picked, finite):
    cfg = {"n_layers": 7, "moe": {"top_k": 2}}
    g = torch.Generator().manual_seed(5)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    out = torch.randn(1, 4, 16, generator=g)
    probs = torch.softmax(torch.randn(1, 4, 6, generator=g), -1)
    best = torch.topk(probs, 2, dim=-1).indices
    ref = Routed(3, out, probs)
    got = prefill.check_step(cfg, ref, {}, tokens, out, [best] * n_picked)
    assert got["logit_err"] == 0.0
    if finite:
        assert got["route_regret"] == 0.0
        assert len(ref.replayed) == 3
    else:
        assert got["route_regret"] == float("inf")
        assert ref.replayed is None


# ---------------------------------------------------------------------------
# (e) the traced window wraps the entry points the cell's readers declare
# ---------------------------------------------------------------------------

DECLARED = {"mixtral-prefill": {"flash_attention"},
            "zamba2-prefill": {"flash_attention", "ssd_scan"},
            "zamba2-train": {"ssd_scan"},
            "mamba2-prefill": {"ssd_scan"}}


@pytest.mark.parametrize("cell", sorted(DECLARED))
def test_todays_cells_declare_todays_entries(cell):
    read = cells.readers(MAN, cell)
    assert {r.ENTRY[1] for r in read.values() if hasattr(r, "ENTRY")} \
        == DECLARED[cell]


@pytest.mark.parametrize("cell", [c["name"] for c in MAN["workloads"]])
def test_the_window_wraps_the_declared_entries(cell):
    read = cells.readers(MAN, cell)
    declared = {r.ENTRY[1] for r in read.values() if hasattr(r, "ENTRY")}
    from repro_torch.kernels import ops
    before = {n: getattr(ops, n) for n in ("flash_attention", "ssd_scan")}
    win = Window("cpu", 0.0, True, entries.union(read.values()))
    try:
        assert sorted(c.name for c in win.calls) == sorted(declared)
        for n, f in before.items():
            assert (getattr(ops, n) is f) == (n not in declared)
    finally:
        win.close()
    assert {n: getattr(ops, n) for n in before} == before
    # the timed run wraps nothing
    assert Window("cpu", 0.0, False, entries.union(read.values())).calls \
        == []


def test_readers_that_declare_one_name_differently_are_refused():
    class R:
        ENTRY = ("repro_torch.kernels.ops", "ssd_scan",
                 lambda *a, **k: {})
    with pytest.raises(ValueError, match="ssd_scan"):
        entries.union([manifest.reader("ssd_scan_roofline.prefill"), R])
    assert entries.union([manifest.reader("ssd_scan_roofline.prefill"),
                          manifest.reader("ssd_scan_roofline.train")]) \
        == [entries.SSD_SCAN]


# ---------------------------------------------------------------------------
# (f) the traced run hands the readers the program's spans
# ---------------------------------------------------------------------------


def tracers_seen(monkeypatch):
    """The program's tracer at every prefill step."""
    seen = []
    make = steps.make_prefill_step

    def factory(cfg, **kw):
        step = make(cfg, **kw)

        def spy(model, batch):
            seen.append(obs_trace.get_tracer())
            return step(model, batch)
        return spy

    monkeypatch.setattr(steps, "make_prefill_step", factory)
    return seen


def test_a_traced_moe_prefill_hands_readers_the_moe_spans(monkeypatch):
    cell = "mixtral-prefill"
    _, cfg, traffic = _bench_tiny.cell_files(cell)
    seen = tracers_seen(monkeypatch)
    line, res = cells.measure(cell, SEED, 0.2, True, time.perf_counter(),
                              device="cpu", cfg=cfg, traffic=traffic)
    assert line["correct"], line["compared"]
    ctx = cells.Context(manifest.cell(MAN, cell), cfg, traffic, res)
    names = {h[2] for h in ctx.spans["host"]}
    assert MOE_SPANS <= names
    # each of the profiled steps' MoE layers opened each span once
    for n in MOE_SPANS:
        assert sum(h[2] == n for h in ctx.spans["host"]) \
            == res.profiled * cfg["n_layers"]
    assert res.profiled == traffic["profiled_steps"]
    # the window's steps ran under an enabled tracer, set-up's did not
    window = seen[traffic["warmup_steps"]:]
    assert all(t.enabled for t in window)
    assert not any(t.enabled for t in seen[:traffic["warmup_steps"]])
    assert not obs_trace.get_tracer().enabled
    # the CPU runs no device operation: a span reader reads nothing
    assert manifest.reader("moe_routing_ms.prefill").read(ctx) is None
    assert "moe_routing_ms.prefill" not in line["metrics"]


def test_the_timed_run_runs_no_tracer(monkeypatch):
    cell = "mixtral-prefill"
    _, cfg, traffic = _bench_tiny.cell_files(cell)
    seen = tracers_seen(monkeypatch)
    _, res = cells.measure(cell, SEED, 0.2, False, time.perf_counter(),
                           device="cpu", cfg=cfg, traffic=traffic)
    assert seen and not any(t.enabled for t in seen)
    assert res.spans is None and res.profiled == 0


def test_the_span_report_reads_the_cells_metrics_from_its_window():
    """The span report's readers read its own window: the spans it prints
    and the span metrics come from one profile."""
    import span_report
    cell = "mixtral-prefill"
    _, cfg, traffic = _bench_tiny.cell_files(cell)
    out = span_report.report(cell, SEED, 0.2, device="cpu", cfg=cfg,
                             traffic=traffic)
    assert set(out["per_layer"]) == set(cells.readers(MAN, cell))
    assert out["correct"]
    # the CPU launches nothing on a device: no span metric, no device ms
    assert out["per_layer"]["moe_routing_ms.prefill"] is None
    assert out["device_ms"] == {}
    assert MOE_SPANS <= set(out["idle_inside_pct"])


def _span_ctx(kind, device, host=None, profiled=2):
    r = {"window": (0, 10), "busy": [], "device": device,
         "host": host or [(0, 1, n, 1) for n in device]}
    return cells.Context({"name": "c"}, {}, {"kind": kind},
                         Result(spans=r, profiled=profiled))


def test_span_readers():
    dev = {"moe.route": 1e-3, "moe.dispatch": 2e-3, "moe.combine": 3e-3,
           "moe.experts": 10e-3, "ssd.backward": 8e-3,
           "train.optimizer": 5e-3, "train.backward": 40e-3}
    ctx = _span_ctx("prefill", dev)
    assert manifest.reader("moe_routing_ms.prefill").read(ctx) \
        == pytest.approx(3.0)
    assert manifest.reader("ssd_backward_ms.train").read(ctx) is None
    ctx = _span_ctx("train", dev, profiled=4)
    assert manifest.reader("ssd_backward_ms.train").read(ctx) \
        == pytest.approx(2.0)
    assert manifest.reader("optimizer_ms.train").read(ctx) \
        == pytest.approx(1.25)
    assert manifest.reader("moe_routing_ms.prefill").read(ctx) is None
    # a span that launched nothing, or no traced run: nothing to read
    ctx = _span_ctx("train", {"train.backward": 1e-3})
    assert manifest.reader("ssd_backward_ms.train").read(ctx) is None
    ctx = cells.Context({}, {}, {"kind": "train"}, Result())
    assert manifest.reader("optimizer_ms.train").read(ctx) is None


def test_a_calls_mismatch_names_the_cell():
    ctx = cells.Context({"name": "zamba2-prefill"}, {}, {"kind": "prefill"},
                        Result(calls={"ssd_scan": [{}] * 2},
                               profile={"spans": {"ssd_scan": [1.0]}}))
    with pytest.raises(RuntimeError, match="zamba2-prefill: ssd_scan"):
        ctx.calls("ssd_scan")


def test_mamba2_forward_flops_by_hand():
    """At one token: twice in_proj and out_proj a layer and the tied head,
    and the SSD's 4·H·N·P a layer."""
    cfg = manifest.config(MAN, "mamba2-370m")
    layer = 2 * 1024 * 4384 + 2 * 2048 * 1024 + 4 * 32 * 128 * 64
    assert counts.forward_flops(cfg, 1, 1) == 48 * layer \
        + 2 * 1024 * 50288
    assert counts.forward_flops(cfg, 16, 2048) == math.prod((16, 2048)) \
        * counts.forward_flops(cfg, 1, 1)
