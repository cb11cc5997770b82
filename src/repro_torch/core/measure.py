"""Measurement protocol — paper §4.2.

"We then time 30 runs of each kernel. … we disregard the first 4 runs and
take the minimum of the remaining execution times."  First-touch effects,
kernel builds and library warm-up land in the discarded warmup runs.
``torch.cuda.synchronize()`` on the device of the result is the dispatch
fence (the OpenCL-event analog; the reference's ``block_until_ready``):
PyTorch returns before the card has finished, so a host clock without it
would time the enqueue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Union

import torch


@dataclass
class TimingResult:
    min_s: float
    mean_s: float
    runs: List[float]

    @property
    def spread(self) -> float:
        """min-vs-mean spread — the paper found <5% when well above launch
        overhead; we record it per kernel as a measurement-quality signal."""
        return abs(self.mean_s - self.min_s) / self.min_s if self.min_s else 0.0


def block_until_ready(out: object) -> None:
    """Wait until every CUDA tensor in ``out`` (a tensor, or a tuple or list
    of them) has been computed; CPU tensors are ready when returned."""
    todo = [out]
    while todo:
        x = todo.pop()
        if isinstance(x, (tuple, list)):
            todo.extend(x)
        elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)


def time_kernel(fn: Callable[[], object], *, runs: int = 30, drop: int = 4,
                min_time_s: float = 0.0) -> TimingResult:
    """Time ``fn`` per the paper's protocol.

    ``fn`` must be a zero-arg callable returning tensors (inputs pre-staged
    on the device).  ``min_time_s``: inner-repeat the call until one timing
    sample exceeds this floor (the paper sizes kernels to exceed launch
    overhead; on very fast kernels we repeat instead and divide).
    """
    # warmup: builds and first-call costs outside the counted runs
    block_until_ready(fn())

    # determine inner repeat factor against the launch-overhead floor
    t0 = time.perf_counter()
    block_until_ready(fn())
    once = time.perf_counter() - t0
    inner = max(1, int(min_time_s / max(once, 1e-9)) if min_time_s else 1)

    samples = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn()
        block_until_ready(out)
        samples.append((time.perf_counter() - t0) / inner)
    kept = samples[drop:]
    return TimingResult(min_s=min(kept), mean_s=sum(kept) / len(kept),
                        runs=samples)


def measure_launch_overhead(runs: int = 30, drop: int = 4,
                            device: Union[str, torch.device] = "cuda"
                            ) -> float:
    """Empty-kernel floor — the paper calibrates minimum problem sizes so
    run time meets/exceeds this.  One 0-d tensor made on ``device``: one
    dispatch and, on a card, one fill kernel."""
    return time_kernel(lambda: torch.zeros((), device=device), runs=runs,
                       drop=drop).min_s
