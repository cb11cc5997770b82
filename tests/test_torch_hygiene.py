"""The port stands alone: no file of ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``, importing the
port pulls neither in, and ``chip_smoke.py`` fails where there is no GPU
instead of carrying on on the CPU.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro", "flax", "optax", "benchmarks",
             "examples"}
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_package_layout():
    names = {p.relative_to(PKG).as_posix() for p in FILES[:-1]}
    for need in ("configs/base.py", "configs/registry.py",
                 "kernels/flash_attention.py", "kernels/ops.py",
                 "kernels/ref.py", "kernels/_build.py", "runtime/flags.py",
                 "runtime/steps.py", "runtime/server.py",
                 "distributed/sharding.py", "models/layers.py",
                 "models/attention.py", "models/transformer.py",
                 "models/convert.py", "obs/metrics.py", "obs/report.py",
                 "obs/trace.py", "launch/serve.py", "models/ssm.py",
                 "kernels/ssd_scan.py", "kernels/matmul.py",
                 "kernels/transpose.py", "core/properties.py",
                 "core/model.py", "core/fit.py", "core/predictor.py",
                 "core/measure.py", "core/extract.py", "core/mkernels.py",
                 "core/tkernels.py", "calibration/seeds.py",
                 "calibration/registry.py", "calibration/calibrate.py",
                 "calibration/__main__.py", "calibration/__init__.py",
                 "optim/optimizers.py", "distributed/plan.py",
                 "data/pipeline.py", "checkpoint/store.py",
                 "runtime/straggler.py", "runtime/trainer.py",
                 "launch/train.py", "models/moe.py", "core/lru.py",
                 "core/symcount.py", "core/workload.py", "core/archcount.py",
                 "core/exprops.py", "core/kernelmodel.py",
                 "core/planspace.py", "distributed/elastic.py",
                 "calibration/telemetry.py", "calibration/online.py",
                 "runtime/faults.py", "runtime/supervisor.py",
                 "runtime/fleet_supervisor.py", "launch/fleet.py",
                 "launch/__main__.py", "benchmarks/__init__.py",
                 "benchmarks/paper_table1.py", "benchmarks/paper_table2.py",
                 "benchmarks/predictor_validation.py",
                 "benchmarks/roofline.py", "benchmarks/kernel_roofline.py",
                 "benchmarks/search_bench.py", "benchmarks/fused_bench.py",
                 "benchmarks/fleet_bench.py", "benchmarks/run.py",
                 "examples/__init__.py", "examples/quickstart.py",
                 "examples/kernel_autotune.py", "examples/serve_decode.py",
                 "examples/train_smollm.py", "examples/fault_tolerance.py",
                 "examples/fleet_churn.py",
                 "examples/autoshard_search.py"):
        assert need in names, need
    for src in ("flash_attention.cu", "ssd_scan.cu", "matmul.cu",
                "transpose.cu"):
        assert (PKG / "kernels" / "csrc" / src).exists(), src
    assert len(list((PKG / "configs").glob("*.py"))) == 12


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(ROOT).as_posix() for p in FILES])
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.setdefault("OMP_NUM_THREADS", "1")
    return env


def test_importing_the_port_pulls_in_neither():
    mods = sorted(
        p.relative_to(PKG.parent).with_suffix("").as_posix().replace("/", ".")
        for p in FILES[:-1] if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert 'repro_torch.models.transformer' in sys.modules\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout, out.stdout


def test_chip_smoke_fails_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=_env(), cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "kernels" not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the program beside it the script must not report success."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, str(alone)], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
