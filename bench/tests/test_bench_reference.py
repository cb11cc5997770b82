"""Each configuration's plain reference against the program's plain path
(``repro_torch`` on the CPU, where every kernel runs its plain version) at
a small size in f32: the logits of a prefill, and the loss and every
gradient of a training step.  The two are written independently, so they
agree only to f32 rounding."""
import pytest
import torch

import _bench_tiny
from benchkit import manifest, program, weights

CONFIGS = ["zamba2-2.7b", "mixtral-8x7b-16l", "mamba2-370m"]


def _tokens(seed=0, V=256, extra=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, V, (_bench_tiny.B, _bench_tiny.S + extra),
                         generator=g)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_equal_the_programs_plain_path(name):
    cfg = _bench_tiny.config(name, "float32")
    w = weights.make(cfg, 2**31 + 7, "cpu")
    arch = program.arch_config(cfg)
    model = program.model_with(arch, w)
    tok = _tokens()
    got = program.prefill_step(arch, *tok.shape)(model, {"tokens": tok})
    record = {}
    want = manifest.reference(name).logits(w, cfg, tok, record=record)
    assert got.shape == want.shape
    err = float((got - want).norm() / want.norm())
    assert err < 2e-6, err
    if cfg.get("moe"):
        assert len(record["picks"]) == cfg["n_layers"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_loss_and_gradients_equal_the_programs(name):
    from repro_torch.models import transformer
    cfg = _bench_tiny.config(name, "float32")
    w = weights.make(cfg, 11, "cpu")
    arch = program.arch_config(cfg)
    model = transformer.init_params(arch, device="cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    tok = _tokens(1, extra=1)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "loss_mask": torch.ones(tok[:, 1:].shape)}
    loss, _ = transformer.loss_fn(model, arch, batch)
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    leaves = {n: t.clone().requires_grad_() for n, t in w.items()}
    ref_loss = manifest.reference(name).loss(leaves, cfg, batch)
    want = torch.autograd.grad(ref_loss, [leaves[n] for n in names])
    assert float(loss.detach()) == pytest.approx(float(ref_loss.detach()),
                                                 rel=1e-6)
    for n, g, r in zip(names, got, want):
        scale = max(float(r.norm()), 1e-6)
        assert float((g - r).norm()) / scale < 1e-4, n


def test_replayed_routing_is_the_references_own():
    """Handed its own picks, the reference computes the same logits: the
    replay changes only which experts are taken."""
    name = "mixtral-8x7b-16l"
    cfg = _bench_tiny.config(name, "float32")
    ref = manifest.reference(name)
    w = weights.make(cfg, 3, "cpu")
    tok = _tokens(2)
    record = {}
    free = ref.logits(w, cfg, tok, record=record)
    again = ref.logits(w, cfg, tok, picks=record["picks"])
    assert torch.equal(free, again)
    shifted = [(p + 1) % cfg["moe"]["n_experts"] for p in record["picks"]]
    assert not torch.allclose(ref.logits(w, cfg, tok, picks=shifted), free)
