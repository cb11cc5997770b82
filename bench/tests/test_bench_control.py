"""The control of each cell: the plain reference computed with fp8
products in the program's place, judged as the program is.  At a small
size on the CPU it reads at least three times what a sound run of the
program reads; on the card, at the cell's own size, it fails the cell's
limits (``-m gpu``; ``bench/readings.py`` takes the readings the limits
were set from)."""
import time

import pytest
import torch

import _bench_tiny
from benchkit import cells, compare, manifest, prefill, train
from benchkit import weights as W

SEED = 2**31 + 21
PREFILL = ["mixtral-prefill", "zamba2-prefill", "mamba2-prefill"]


def prefill_control(cell, cfg, traffic, device):
    c = manifest.cell(manifest.manifest(), cell)
    ref = manifest.reference(c["config"])
    w = W.make(cfg, SEED, device, ref)
    g = torch.Generator(device).manual_seed(SEED * 2 + 1)
    tok = torch.randint(0, cfg["vocab_size"],
                        (traffic["batch"], traffic["seq_len"]),
                        generator=g, device=device, dtype=torch.int32)
    return prefill.control_step(cfg, ref, w, tok)


def train_control(cell, cfg, traffic, device):
    c = manifest.cell(manifest.manifest(), cell)
    ref = manifest.reference(c["config"])
    want = train.follow(ref, cfg, traffic, SEED, device, "f32")
    low = train.follow(ref, cfg, traffic, SEED, device, "fp8")
    return compare.train_numbers(low, want)


def sound(cell, cfg, traffic):
    return cells.measure(cell, SEED, 0.2, False, time.perf_counter(),
                         device="cpu", cfg=cfg, traffic=traffic)[1].numbers


@pytest.mark.parametrize("cell", PREFILL)
def test_prefill_control_reads_above_the_program(cell):
    _, cfg, traffic = _bench_tiny.cell_files(cell)
    low = prefill_control(cell, cfg, traffic, "cpu")
    assert low["logit_err"] >= 3 * sound(cell, cfg, traffic)["logit_err"]


def test_train_control_reads_above_the_program():
    cell = "zamba2-train"
    _, cfg, traffic = _bench_tiny.cell_files(cell)
    low = train_control(cell, cfg, traffic, "cpu")
    assert low["grad"] >= 3 * sound(cell, cfg, traffic)["grad"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control at the cell's size")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", PREFILL + ["zamba2-train"])
def test_control_fails_the_limits_at_the_cells_size(cell, card):
    man = manifest.manifest()
    c = manifest.cell(man, cell)
    cfg = manifest.config(man, c["config"])
    traffic = manifest.traffic(c["traffic"])
    run = prefill_control if traffic["kind"] == "prefill" else train_control
    correct, shown = compare.judge(run(cell, cfg, traffic, card),
                                   manifest.limits(cell)["limits"])
    assert not correct, shown
