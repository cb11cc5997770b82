"""A whole run of the training cell at a small size on the CPU (the look
for a chip skipped), sound and with the timed path broken underneath:
``correct`` holds for the sound run and falls for each fault a training
cell on one chip can have, judged by the cell's own limits."""
import time

import pytest
import torch

import _bench_tiny
from benchkit import cells
from repro_torch.models import transformer
from repro_torch.runtime import steps

CELL = "zamba2-train"


def unchanged(make):
    """The loss and gradients computed, the state returned unchanged."""
    def factory(cfg, optimizer, plan=None, **kw):
        def broken(state, batch):
            loss, _ = transformer.loss_fn(state.params, cfg, batch)
            torch.autograd.grad(loss, list(state.params.parameters()))
            return state, {"loss": loss.detach(),
                           "grad_norm": loss.detach() * 0,
                           "lr": 0.0}
        return broken
    return factory


def half_batch(make):
    """The step on the first half of the rows, its mean over them."""
    def factory(cfg, optimizer, plan=None, **kw):
        step = make(cfg, optimizer, plan, **kw)

        def broken(state, batch):
            return step(state, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()})
        return broken
    return factory


def altered(make):
    """The step's answer, the updated parameters, altered in one
    element."""
    def factory(cfg, optimizer, plan=None, **kw):
        step = make(cfg, optimizer, plan, **kw)

        def broken(state, batch):
            state, metrics = step(state, batch)
            with torch.no_grad():
                next(state.params.parameters()).view(-1)[0] += 1.0
            return state, metrics
        return broken
    return factory


def run(seed=2**31 + 9):
    _, cfg, traffic = _bench_tiny.cell_files(CELL)
    return cells.run_cell(CELL, seed, 0.2, False, time.perf_counter(),
                          device="cpu", cfg=cfg, traffic=traffic)


def test_sound_run_is_correct():
    out = run()
    assert out["correct"], out["compared"]
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=["state_unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(steps, "make_train_step",
                        fault(steps.make_train_step))
    out = run()
    assert not out["correct"], out["compared"]
