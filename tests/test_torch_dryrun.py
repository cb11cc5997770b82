"""The dry run on a fake world against the reference's compiled rollup.

The port's dry run runs a sharded step as a DTensor program on fake tensors
over the ``fake`` backend, and ``core.extract.extract_step`` counts one
rank's local ops; the reference lowers and compiles the step over virtual
XLA devices and rolls the HLO up (``extract_compiled``).  Each side runs in
a subprocess of its own: a fake world is a process's default group, and
the reference's device count is fixed before JAX starts.

* The parity cell is ``tests/test_multidevice.py``'s: smollm-360m at
  ``train_4k`` on a (2, 4) ``data, model`` mesh, ``plan_for(...,
  tp_size=4)``, both sides pricing the plain chunked attention
  (``use_kernels(False)``; the reference's default).  Its depth is cut to 4
  of 32 layers on both sides (every layer is priced alike; the whole depth
  takes about a minute of DTensor dispatch on a CPU).  Per-rank flops
  within 25 % of the reference's, its bar between extraction and closed
  form (``tests/test_extraction.py:198``); collective bytes kind by kind
  within 25 % of the reference's, or at a ratio pinned with the op that
  issues the difference.
* The expert-parallel cell of ``tests/test_multidevice.py``: mixtral-8x7b
  prefill at global batch 8 on a (1, 8) mesh under ``moe_mode="ep"``, at 2
  of 32 layers: collective bytes non-zero.
* A ``Shard(0)`` matmul is counted at 1/world of its global flops.
* ``python -m repro_torch.launch dryrun`` prices a 256-rank cell.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
LAYERS = 4

PORT = """
import dataclasses, json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCHS
from repro_torch.core import extract
from repro_torch.distributed.plan import plan_for
from repro_torch.launch import dryrun, mesh as lmesh
from repro_torch.runtime import flags

out = {}
lmesh.init_fake_world(8)

# a Shard(0) matmul: (64, 64) rows split over 8 ranks, times a replicated
# (64, 64)
m8 = lmesh.make_mesh((8,), ("data",), device="cpu")
with FakeTensorMode():
    a = DTensor.from_local(torch.empty(8, 64), m8, [Shard(0)],
                           run_check=False)
    b = DTensor.from_local(torch.empty(64, 64), m8, [Replicate()],
                           run_check=False)
c = extract.extract_step(lambda x, y: x @ y, a, b)
out["matmul_flops"] = c.flops
out["matmul_bytes"] = c.bytes_accessed

# the parity cell, the plain chunked attention priced
mesh = lmesh.make_mesh((2, 4), ("data", "model"), device="cpu")
cfg = dataclasses.replace(ARCHS["smollm-360m"], n_layers=LAYERS)
shape = SHAPES["train_4k"]
plan = plan_for(cfg, shape, tp_size=4, hbm_budget=16e9)
with flags.use_kernels(False):
    c = dryrun.price_cell(cfg, shape, mesh, plan)
out["train"] = dataclasses.asdict(c)

# the expert-parallel cell
mesh = lmesh.make_mesh((1, 8), ("data", "model"), device="cpu")
cfg = dataclasses.replace(ARCHS["mixtral-8x7b"], n_layers=2)
shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=8)
plan = plan_for(cfg, shape, tp_size=8, hbm_budget=16e9).with_(moe_mode="ep")
c = dryrun.price_cell(cfg, shape, mesh, plan)
out["ep"] = dataclasses.asdict(c)
json.dump(out, open(sys.argv[1], "w"))
"""

REFERENCE = """
import dataclasses, json, sys
import jax
from repro.configs.base import SHAPES
from repro.configs.registry import ARCHS
from repro.core import extract as cx
from repro.distributed.plan import plan_for
from repro.distributed.sharding import use_sharding
from repro.launch.mesh import make_mesh
from repro.launch.specs import step_and_specs

mesh = make_mesh((2, 4), ("data", "model"))
cfg = dataclasses.replace(ARCHS["smollm-360m"], n_layers=LAYERS)
shape = SHAPES["train_4k"]
plan = plan_for(cfg, shape, tp_size=4)
with mesh, use_sharding(mesh, plan):
    fn, specs, sh, osh = step_and_specs(cfg, shape, mesh, plan)
    compiled = jax.jit(fn, in_shardings=sh,
                       out_shardings=osh).lower(*specs).compile()
json.dump(dataclasses.asdict(cx.extract_compiled(compiled)),
          open(sys.argv[1], "w"))
"""


def _start(code: str, out: Path, env: dict) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def costs(tmp_path_factory):
    """Both sides' costs, computed side by side."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = _start(f"LAYERS = {LAYERS}\n" + textwrap.dedent(PORT),
                  d / "port.json", env)
    ref = _start("import os\nos.environ['XLA_FLAGS'] = "
                 "'--xla_force_host_platform_device_count=8'\n"
                 f"LAYERS = {LAYERS}\n" + textwrap.dedent(REFERENCE),
                 d / "ref.json", dict(env, JAX_PLATFORMS="cpu"))
    for p in (port, ref):
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log
    return (json.loads((d / "port.json").read_text()),
            json.loads((d / "ref.json").read_text()))


def test_per_rank_flops_within_a_quarter_of_the_compiled_rollup(costs):
    port, ref = costs
    got, want = port["train"]["flops"], ref["flops"]
    assert want > 0 and abs(got - want) / want < 0.25, (got, want)


def test_sharded_train_step_moves_collective_bytes(costs):
    port, _ = costs
    coll = port["train"]["collective_bytes"]
    assert sum(coll.values()) > 0, coll
    # FSDP: the weights gathered, the gradients reduce-scattered
    assert coll.get("all_gather", 0) > 0 and \
        coll.get("reduce_scatter", 0) > 0, coll
    assert port["train"]["peak_bytes_per_device"] > 0
    assert port["train"]["xla_flops"] == port["train"]["xla_bytes"] == 0


#: the parity cell's collective bytes a rank, the port's over the
#: reference's compiled rollup, where they differ by more than the flops'
#: 25 % bar (ROADMAP, Queue C watch-points: the ops that issue them).
#: all-gather: ``layers.rows_whole`` gathers the sequence before each
#: projection, the remat's recompute again, and ``sharding.split_last``
#: the heads (15 on 4 ranks); the reduction kinds summed: the reference's
#: CPU program has no reduce-scatter (all-reduce only), DTensor's sequence
#: parallelism reduce-scatters each row-parallel output and each gathered
#: input's gradient
PINNED_OVER_REFERENCE = {"all_gather": 1.3210, "reductions": 3.7409}


def test_collective_bytes_by_kind_against_the_compiled_rollup(costs):
    """The parity cell's collective bytes kind by kind against the
    reference's ``extract_compiled``: within 25 %, or at the pinned ratio
    of a recorded deviation (2 %)."""
    port, ref = costs
    got, want = port["train"]["collective_bytes"], ref["collective_bytes"]
    red = ("all_reduce", "reduce_scatter")
    pairs = {"all_gather": (got.get("all_gather", 0),
                            want.get("all_gather", 0)),
             "reductions": (sum(got.get(k, 0) for k in red),
                            sum(want.get(k, 0) for k in red))}
    assert set(got) | set(want) <= {"all_gather", *red}, (got, want)
    for kind, (a, b) in pairs.items():
        assert b > 0, (kind, want)
        pinned = PINNED_OVER_REFERENCE.get(kind)
        if pinned is None:
            assert abs(a - b) / b < 0.25, (kind, a, b)
        else:
            assert a / b == pytest.approx(pinned, rel=0.02), (kind, a, b)


def test_expert_parallel_cell_moves_collective_bytes(costs):
    port, _ = costs
    assert sum(port["ep"]["collective_bytes"].values()) > 0, port["ep"]
    assert port["ep"]["flops"] > 0
    # the attention kernel is priced, not run, on fake tensors
    assert port["ep"]["kernels"]["flash_attention"]["calls"] == 2


def test_shard0_matmul_counts_one_rank_of_the_global_flops(costs):
    port, _ = costs
    world, n = 8, 64
    assert port["matmul_flops"] == 2 * n * n * n / world
    # the rank's rows and the whole right-hand side read, its rows written
    assert port["matmul_bytes"] == 4 * (n * n / world * 2 + n * n)


def test_dryrun_command_prices_a_256_rank_cell(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--mesh", "single",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["hbm_budget"] == 80e9
    for key in ("flops_per_device", "bytes_per_device",
                "peak_bytes_per_device", "trace_s"):
        assert rec[key] > 0, key
    assert "ssd_scan kernel" in rec["ssd"] and rec["attention"] is None
    # decode runs the SSD recurrence, not the scan kernel
    assert "ssd_scan" not in rec["kernels_priced"]


def test_dryrun_command_skips_what_the_reference_skips(tmp_path):
    out = tmp_path / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch", "dryrun", "--arch",
         "llama3.2-3b", "--shape", "long_500k", "--mesh", "single",
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "skip" and "full-attention" in rec["why"]
