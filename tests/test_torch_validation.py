"""The port's whole-step validation and kernel roofline against the
reference's scripts (``benchmarks/predictor_validation.py``,
``benchmarks/kernel_roofline.py``), on the CPU.

* Predictor validation at the reference's reduced sizes (B 2 × S 64),
  both sides from a temporary directory, each reading a model file put
  where its script looks (the analytic seeds: the fit is Table 1's test):
  the same architectures and row keys, the port's rows adding what it
  names (unpriced keys, cuts, warnings).  The port's extracted step flops
  (matrix and vector) within 25 % of the reference's ``extract_jaxpr`` for
  one dense, one hybrid and one MoE architecture, the bar of
  ``tests/test_extraction.py:198`` between extraction and closed form.
* The kernel roofline of a small cell, llama3.2-3b ``prefill_32k`` cut to
  2 layers and 2048 tokens on a (2, 4) ``data, model`` mesh, each side in
  a subprocess (a fake world of 8 ranks; 8 virtual XLA devices).  At 2048
  tokens both sides take the materialised-logits path (neither skips a
  masked pair) and the heads divide the model axis (no context
  parallelism).  The port's attention-attributable flops are the closed
  form of one rank's share within 2 %; the reference's compiled program
  counts 2.0x that (its rollup at 1 layer equals the port's at 2), a
  deviation pinned at that ratio.  The record's keys are the reference's
  (``smem`` where the reference has ``vmem``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import predictor_validation as jpv   # noqa: E402
from repro.configs.registry import ARCHS as JARCHS   # noqa: E402
from repro.core import extract as jextract           # noqa: E402
from repro.core import predictor as jpredictor       # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import optimizers as jopt           # noqa: E402
from repro.runtime import steps as jsteps            # noqa: E402
from repro_torch.benchmarks import predictor_validation as tpv  # noqa: E402
from repro_torch.calibration import seeds            # noqa: E402

torch.set_num_threads(1)

B, S = 2, 64
FLOPS_RTOL = 0.25
#: the kernel-roofline cell's attention-attributable flops, the
#: reference's rollup over the port's count (see the last test)
REF_OVER_PORT = 2.0066


@pytest.fixture(scope="module")
def validation(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        d = tmp_path_factory.mktemp("ref")
        mp.chdir(d)
        (d / "experiments").mkdir()
        jpredictor.tpu_v5e_weights().save(
            str(d / "experiments" / "model_cpu_tiny.json"))
        out["ref"] = jpv.run(scale="tiny", B=B, S=S, verbose=False)
        d = tmp_path_factory.mktemp("port")
        mp.chdir(d)
        (d / "experiments").mkdir()
        m = seeds.ANALYTIC_SEEDS["gpu-h100"]()
        m.device = "cpu-tiny"
        m.save(str(d / "experiments" / "torch_model_cpu-tiny_tiny.json"))
        # the reference's architectures (the port's registry also holds
        # Nemotron, which the reference has not)
        out["port"] = tpv.run(scale="tiny", B=B, S=S, device="cpu",
                              archs=sorted(JARCHS), verbose=False)
        out["dir"] = d
    finally:
        mp.undo()
    return out


def test_validation_rows_are_the_reference_archs_and_keys(validation):
    ref, port = validation["ref"], validation["port"]
    assert [r["arch"] for r in port["rows"]] == \
        [r["arch"] for r in ref["rows"]]
    assert set(ref) <= set(port)
    added = {"status", "layers", "layers_run", "flops", "unpriced",
             "extract_warnings"}
    for a, b in zip(port["rows"], ref["rows"]):
        assert set(a) == set(b) | added, a["arch"]
        assert a["status"] == "ok" and a["layers_run"] == a["layers"] == 2
        assert np.isfinite(a["predicted_ms"]) and a["predicted_ms"] > 0
        assert a["actual_ms"] > 0
    assert np.isfinite(port["geomean_rel_err"])
    assert (port["B"], port["S"]) == (ref["B"], ref["S"]) == (B, S)
    assert (validation["dir"] / "experiments" /
            "torch_predictor_validation.json").exists()
    assert not (validation["dir"] / "experiments" /
                "predictor_validation.json").exists()


def test_validation_names_the_keys_the_fit_leaves_unpriced(validation):
    for r in validation["port"]["rows"]:
        # the seed prices every key: only the 64-bit exps of the rotary
        # tables and nothing else of weight are absent
        assert all(v > 0 for v in r["unpriced"].values())
        assert "mxu:16" not in r["unpriced"]


@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b",
                                  "mixtral-8x7b"])
def test_step_flops_within_a_quarter_of_extract_jaxpr(validation, arch):
    cfg = JARCHS[arch].reduced()
    o = jopt.get_optimizer("adamw")
    params, _ = jtransformer.init_params(cfg, jax.random.PRNGKey(0))
    state = jsteps.TrainState(params, o.init(params),
                              jnp.zeros((), jnp.int32))
    batch = jpv._batch(cfg, B, S, jax.random.PRNGKey(1))
    pv = jextract.extract_jaxpr(jsteps.make_train_step(cfg, o), state,
                                batch)
    want = sum(v for k, v in pv.items() if k.startswith(("mxu:", "flop:")))
    got = next(r["flops"] for r in validation["port"]["rows"]
               if r["arch"] == arch)
    assert abs(got - want) / want < FLOPS_RTOL, (got, want)


def test_depth_is_cut_only_as_far_as_the_budget_forces():
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS["llama3.2-3b"]
    whole = tpv.reckoned_bytes(cfg, 2, 2048)
    assert tpv.fit_depth(cfg, 2, 2048, whole) == cfg.n_layers
    cut = tpv.fit_depth(cfg, 2, 2048, whole * 0.6)
    assert 0 < cut < cfg.n_layers
    assert tpv.reckoned_bytes(dataclasses.replace(cfg, n_layers=cut), 2,
                              2048) <= whole * 0.6
    big = ARCHS["llama3-405b"]
    one = tpv.reckoned_bytes(dataclasses.replace(big, n_layers=1), 2, 2048)
    assert tpv.fit_depth(big, 2, 2048, one * 0.99) is None
    # under AdamW whatever the config trains with (405b: Adafactor)
    assert one > 80e9


PORT = """
import json, sys
from repro_torch.benchmarks import kernel_roofline
rec = kernel_roofline.analyse("llama3.2-3b", "prefill_32k", device="cpu",
                              mesh_shape=(2, 4), n_layers=2, seq_len=2048,
                              out=sys.argv[1], verbose=False)
"""

REFERENCE = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[2])
os.chdir(sys.argv[1])
from benchmarks import kernel_roofline as kr
from repro.configs.base import SHAPES
from repro.configs.registry import ARCHS
from repro.launch.mesh import make_mesh
ARCHS["llama3.2-3b"] = dataclasses.replace(ARCHS["llama3.2-3b"], n_layers=2)
SHAPES["prefill_32k"] = dataclasses.replace(SHAPES["prefill_32k"],
                                            seq_len=2048)
kr.make_production_mesh = lambda: make_mesh((2, 4), ("data", "model"))
kr.plan_for = (lambda plan_for: lambda cfg, shape: plan_for(
    cfg, shape, tp_size=4))(kr.plan_for)
kr.analyse("llama3.2-3b", "prefill_32k")
"""


def test_kernel_roofline_attributes_the_reference_attention_flops(
        tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    port = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(PORT), str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp_path),
         str(ROOT)], env=dict(env, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for p in (port, ref):
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-4000:]
    name = "kernel_roofline_llama3.2-3b_prefill_32k.json"
    got = json.loads((tmp_path / f"torch_{name}").read_text())
    want = json.loads((tmp_path / "experiments" / name).read_text())
    a, b = got["attention_attributable"]["flops"], \
        want["attention_attributable"]["flops"]
    # the closed form on one rank: q kᵀ and p v over every (q, k) pair of
    # the rank's 16 rows and 6 heads, 2 layers
    closed = 2 * (4 * 16 * 6 * 2048 * 2048 * 128)
    assert abs(a - closed) / closed < 0.02, (a, closed)
    # the reference's partitioned program computes this cell's attention
    # twice over (2.0x the closed form); the ratio is pinned
    assert b / a == pytest.approx(REF_OVER_PORT, rel=0.02), (a, b)
    rename = lambda k: k.replace("vmem", "smem")
    assert {rename(k) for k in want} <= set(got)
    assert {rename(k) for k in want["kernel_terms_s"]} == \
        set(got["kernel_terms_s"])
    assert got["rates"] == {"peak_bf16": 989e12, "hbm": 3.35e12,
                            "link": 450e9}
    assert got["n_devices"] == 8
