"""A whole run of each prefill cell at a small size on the CPU (the look
for a chip skipped), sound and with the timed path broken underneath:
``correct`` holds for the sound run and falls for each fault a prefill
cell can have, judged by the cell's own limits."""
import time

import pytest
import torch

import _bench_tiny
from benchkit import cells, manifest
from repro_torch.runtime import steps

CELLS = ["mixtral-prefill", "zamba2-prefill", "mamba2-prefill"]


def stale(make):
    """A step that returns its first output again: no new work."""
    def factory(cfg, **kw):
        step, first = make(cfg, **kw), []

        def broken(model, batch):
            if not first:
                first.append(step(model, batch))
            return first[0]
        return broken
    return factory


def half_batch(make):
    """Half the rows computed, the rest filled with them."""
    def factory(cfg, **kw):
        step = make(cfg, **kw)

        def broken(model, batch):
            tok = batch["tokens"]
            out = step(model, {"tokens": tok[:tok.shape[0] // 2]})
            return torch.cat([out, out])
        return broken
    return factory


def altered(make):
    """One position's logits replaced by its neighbour's."""
    def factory(cfg, **kw):
        step = make(cfg, **kw)

        def broken(model, batch):
            out = step(model, batch).clone()
            out[0, 5] = out[0, 6]
            return out
        return broken
    return factory


def run(cell, seed=2**31 + 5):
    _, cfg, traffic = _bench_tiny.cell_files(cell)
    return cells.run_cell(cell, seed, 0.2, False, time.perf_counter(),
                          device="cpu", cfg=cfg, traffic=traffic)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in manifest.metrics_of(manifest.manifest(),
                                                   cell, trace=False)}
    assert set(out["metrics"]) == want
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("fault", [stale, half_batch, altered],
                         ids=["state_unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    monkeypatch.setattr(steps, "make_prefill_step",
                        fault(steps.make_prefill_step))
    out = run(cell)
    assert not out["correct"], out["compared"]
