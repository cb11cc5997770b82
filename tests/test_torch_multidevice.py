"""The port's explicit-collective path against the JAX package, on the CPU:
the int8 error-feedback quantizer, the compressed all-reduce and its
collective bytes, the manual-DP train step, the elastic resume across world
sizes and the context-parallel attention branch.

The port is multi-controller: its ranks are processes (``_torch_ranks.py``)
in a gloo group that meets through a ``FileStore`` in the test's temporary
directory (no fixed port: the suite runs in several workers at once), at
most 4 of them.  The reference runs once per module in a subprocess with 4
virtual CPU devices (``--xla_force_host_platform_device_count``), as
``tests/test_multidevice.py`` runs its own, and hands its results over as
``.npz``.  Both read the same inputs and parameters, made here from seeds.

Tolerances: quantizer codes equal, values 1e-6; the compressed all-reduce's
reduced-shard codes equal, its output within 1e-6 of the max and within 5 %
of the exact sum; the DP step's loss and gradient norm 1e-4 relative without
compression and 1e-3 under ``int8_ef`` (f32 configurations: two frameworks'
summation orders); int8 losses within 5 % of fp32 and decreasing (the
reference's bar); the context-parallel attention 1e-5 (f32).
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

from repro.configs.registry import ARCHS as JARCHS
from repro.distributed import compression as jcomp
from repro.models import transformer as jtransformer
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.core import extract
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding
from repro_torch.distributed.plan import Plan
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttransformer
from repro_torch.runtime import flags

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
B, S = 16, 32
#: the DP configuration: smollm-360m reduced, in f32 for the parity bars
DP_CFG = dict(param_dtype="float32", compute_dtype="float32")
#: the context-parallel case: 3 heads on a model axis of 2, S 2048, f32
CP = dict(n_heads=3, n_kv_heads=1, S=2048, tp=2)


def _dp_cfg(arch_dict):
    return dataclasses.replace(arch_dict["smollm-360m"].reduced(), **DP_CFG)


# ---------------------------------------------------------------------------
# the reference, once per module, in a subprocess with 4 virtual devices
# ---------------------------------------------------------------------------

REFERENCE = """
import dataclasses, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.configs.registry import ARCHS
from repro.core import hloparse
from repro.distributed import compression as comp
from repro.distributed.plan import Plan
from repro.distributed.sharding import use_sharding
from repro.launch.mesh import make_mesh
from repro.models import attention as attn
from repro.optim import optimizers as opt
from repro.runtime import flags, steps

data = sys.argv[1]
inp = np.load(os.path.join(data, "inputs.npz"))
flat = dict(np.load(os.path.join(data, "params.npz")))
out = {}

# the compressed all-reduce, its reduced shards, the collective bytes
mesh = make_mesh((4,), ("data",))
x = jnp.asarray(inp["psum_x"])                       # (4, 1, 4096)

def approx(xs):
    return comp.psum_compressed(xs, "data")

def exact(xs):
    return jax.lax.psum(xs, "data")

def shard_codes(xs):
    # steps 1-2 of comp.psum_compressed (its own lines), then the codes of
    # the reduced shard
    n = 4
    flat_, size = comp._pad_to(xs.astype(jnp.float32), n * comp.CHUNK)
    shards = flat_.reshape(n, -1)
    codes, scales, _ = comp.quantize(shards.reshape(-1), comp.CHUNK)
    codes = codes.reshape(n, -1)
    scales = scales.reshape(n, -1)
    codes_x = jax.lax.all_to_all(codes, "data", 0, 0)
    scales_x = jax.lax.all_to_all(scales, "data", 0, 0)
    part = jnp.sum(codes_x.astype(jnp.float32)
                   * jnp.repeat(scales_x, comp.CHUNK, axis=-1), axis=0)
    return comp.quantize(part, comp.CHUNK)[0][None]

sm = lambda f, o: shard_map(f, mesh=mesh, in_specs=(P("data"),),
                            out_specs=o, check_rep=False)
f_approx, f_exact = sm(approx, P()), sm(exact, P())
out["psum_approx"] = np.asarray(f_approx(x))
out["psum_exact"] = np.asarray(f_exact(x))
out["psum_shard_codes"] = np.asarray(sm(shard_codes, P("data"))(x))
for name, f in (("psum", f_approx), ("allreduce", f_exact)):
    txt = jax.jit(f).lower(x).compile().as_text()
    out[name + "_bytes"] = json.dumps(hloparse.collective_summary(txt))

# the manual-DP step
unflat = {}
for key, v in flat.items():
    node = unflat
    *path, last = key.split("/")
    for p in path:
        node = node.setdefault(p, {})
    node[last] = v
cfg = dataclasses.replace(ARCHS["smollm-360m"].reduced(), **DP_CFG)
params = jax.tree.map(lambda a: jnp.asarray(a, cfg.param_dtype), unflat)
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "labels": jnp.asarray(inp["labels"])}
optimizer = opt.get_optimizer("adamw")
for compression in (None, "int8_ef"):
    st = steps.TrainState(params, optimizer.init(params),
                          jnp.zeros((), jnp.int32))
    fn, init_ef = steps.make_manual_dp_train_step(
        cfg, optimizer, mesh, compression=compression)
    fn = jax.jit(fn)
    ef = init_ef(params)
    ls, ns = [], []
    for i in range(DP_STEPS):
        st, ef, m = fn(st, ef, batch)
        ls.append(float(m["loss"]))
        ns.append(float(m["grad_norm"]))
    tag = compression or "fp32"
    out["dp_%s_loss" % tag] = np.array(ls)
    out["dp_%s_grad_norm" % tag] = np.array(ns)

# elastic: two steps on 4 devices, one on 2 with a fresh residual
st = steps.TrainState(params, optimizer.init(params),
                      jnp.zeros((), jnp.int32))
fn4, init_ef4 = steps.make_manual_dp_train_step(cfg, optimizer, mesh)
ef = init_ef4(params)
for _ in range(2):
    st, ef, m = jax.jit(fn4)(st, ef, batch)
st = jax.device_get(st)      # on the host, as a checkpoint restores it
mesh2 = make_mesh((2,), ("data",), devices=jax.devices()[:2])
fn2, init_ef2 = steps.make_manual_dp_train_step(cfg, optimizer, mesh2)
st, _, m = jax.jit(fn2)(st, init_ef2(st.params), batch)
out["resume_step"] = int(st.step)
out["resume_loss"] = float(m["loss"])

# context-parallel attention: 3 heads on a model axis of 2
acfg = dataclasses.replace(ARCHS["llama3.2-3b"].reduced(),
                           n_heads=CP["n_heads"], n_kv_heads=CP["n_kv_heads"],
                           param_dtype="float32", compute_dtype="float32")
ap = {w: {"w": jnp.asarray(inp["attn_" + w])} for w in ("wq", "wk", "wv",
                                                       "wo")}
ax = jnp.asarray(inp["attn_x"])
amesh = make_mesh((1, CP["tp"]), ("data", "model"),
                  devices=jax.devices()[:CP["tp"]])
from repro.distributed.sharding import context_parallel_factor
with flags.use_pallas(False), amesh, use_sharding(amesh, Plan(dp_axes=("data",))):
    out["attn_cp"] = int(context_parallel_factor(CP["n_heads"], CP["S"]))
    out["attn_out"] = np.asarray(jax.jit(
        lambda p, x: attn.attn_apply(p, x, acfg)[0])(ap, ax))
np.savez(os.path.join(data, "ref.npz"), **out)
"""


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v, dtype=np.float32)
    return out


def _inputs(data: Path) -> dict:
    """The inputs both sides read: seeded numpy, and the reference's
    parameters of the DP configuration (f32)."""
    rng = np.random.default_rng(0)
    cfg = _dp_cfg(JARCHS)
    acfg = dataclasses.replace(JARCHS["llama3.2-3b"].reduced(),
                              n_heads=CP["n_heads"],
                              n_kv_heads=CP["n_kv_heads"])
    d, dh = acfg.d_model, acfg.head_dim_
    w = lambda i, o: (rng.standard_normal((i, o)) * 0.05).astype(np.float32)
    inp = {
        "psum_x": rng.standard_normal((RANKS, 1, 4096)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
        "attn_wq": w(d, CP["n_heads"] * dh),
        "attn_wk": w(d, CP["n_kv_heads"] * dh),
        "attn_wv": w(d, CP["n_kv_heads"] * dh),
        "attn_wo": w(CP["n_heads"] * dh, d),
        "attn_x": rng.standard_normal((1, CP["S"], d)).astype(np.float32),
    }
    np.savez(data / "inputs.npz", **inp)
    params, _ = jtransformer.init_params(cfg, jax.random.PRNGKey(0))
    np.savez(data / "params.npz", **_flatten(params))
    return inp


def _ranks(task: str, world: int, data: Path, timeout: int = 300) -> list:
    """Run ``task`` on ``world`` rank processes; -> each rank's results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_ranks.py"), task,
         str(r), str(world), str(data)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(data / f"{task}.{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results and the port's, from the same inputs: the
    reference's subprocess and the port's 4 ranks run side by side, then
    the port's 2-rank resume."""
    data = tmp_path_factory.mktemp("multidevice")
    inp = _inputs(data)
    script = ("import os\n"
              "os.environ['XLA_FLAGS'] = "
              "'--xla_force_host_platform_device_count=4'\n"
              f"DP_STEPS = 4\nDP_CFG = {DP_CFG!r}\nCP = {CP!r}\n"
              + textwrap.dedent(REFERENCE))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref_proc = subprocess.Popen([sys.executable, "-c", script, str(data)],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    port = _ranks("collectives", RANKS, data)
    log = ref_proc.communicate(timeout=400)[0]
    assert ref_proc.returncode == 0, log
    resume = _ranks("resume", RANKS // 2, data)
    return {"inp": inp, "ref": dict(np.load(data / "ref.npz")),
            "port": port, "resume": resume}


# ---------------------------------------------------------------------------
# the quantizer (in process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,chunk", [((3, 1000), 1024), ((4096,), 1024),
                                         ((7, 33, 5), 64), ((2, 2048), 256)])
def test_quantizer_matches_the_reference(shape, chunk):
    rng = np.random.default_rng(sum(shape) + chunk)
    x = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 1, shape)
         ).astype(np.float32)
    x.reshape(-1)[:chunk] = 0.0    # an all-zero chunk: the 1e-30 floor
    r = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    jc, js, jn = jcomp.quantize(jnp.asarray(x), chunk)
    tc, ts, tn = comp.quantize(torch.from_numpy(x), chunk)
    assert tn == jn
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    jd = jcomp.dequantize(jc, js, jn, shape)
    td = comp.dequantize(tc, ts, tn, shape)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6 * float(np.abs(x).max()))
    jc, js, jr = jcomp.ef_compress(jnp.asarray(x), jnp.asarray(r), chunk)
    tc, ts, tr = comp.ef_compress(torch.from_numpy(x), torch.from_numpy(r),
                                  chunk)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-6 * float(np.abs(x).max()))


def test_rounding_is_half_to_even_and_clipped():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0, 3.0])
    codes, scales, n = comp.quantize(x, chunk=8)
    assert float(scales[0]) == 1.0 and n == 8
    assert codes.tolist() == [[127, 0, 2, 2, 0, -2, -127, 3]]


# ---------------------------------------------------------------------------
# the compressed all-reduce on 4 gloo ranks
# ---------------------------------------------------------------------------


def test_psum_compressed_matches_the_reference(runs):
    ref, port = runs["ref"], runs["port"]
    exact = runs["inp"]["psum_x"].sum(axis=0)            # (1, 4096)
    want = ref["psum_approx"].reshape(exact.shape)      # a device's (1, 1, 4096)
    top = float(np.abs(want).max())
    for r, out in enumerate(port):
        np.testing.assert_array_equal(out["psum_shard_codes"],
                                      ref["psum_shard_codes"][r])
        np.testing.assert_allclose(out["psum_approx"], want, rtol=0,
                                   atol=1e-6 * top)
        np.testing.assert_allclose(out["psum_exact"], exact, rtol=1e-5,
                                   atol=1e-5)
        rel = np.abs(out["psum_approx"] - exact).max() / np.abs(exact).max()
        assert rel < 0.05, rel


def test_collective_bytes_match_the_compiled_reference(runs):
    """The collectives the port's call issues against those in the
    reference's compiled HLO: the same kinds and operand bytes a rank
    (int8 codes and f32 scales: 4096 + 16 through the all-to-all, 1024 + 4
    through the all-gather)."""
    ref = json.loads(str(runs["ref"]["psum_bytes"]))
    ref_ar = json.loads(str(runs["ref"]["allreduce_bytes"]))
    for out in runs["port"]:
        got = json.loads(str(out["psum_bytes"]))
        assert got == ref == {"all-to-all": 4096 + 16, "all-gather": 1024 + 4}
        assert json.loads(str(out["allreduce_bytes"])) == ref_ar \
            == {"all-reduce": 4096 * 4}
    # the wire: f32 all-reduce over the int8 format's bytes
    assert (4096 * 4) / (4096 + 16 + 1024 + 4) == pytest.approx(3.19, 1e-2)
    vec = extract.collective_property_vector(got)
    assert vec == {"coll:all_to_all": 4112.0, "coll:all_gather": 1028.0}


def test_count_collectives_counts_nothing_without_a_collective():
    with extract.count_collectives() as seen:
        torch.ones(3).sum()
    assert seen == {}


# ---------------------------------------------------------------------------
# the manual-DP train step on 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag,rtol", [("fp32", 1e-4), ("int8_ef", 1e-3)])
def test_manual_dp_step_matches_the_reference(runs, tag, rtol):
    ref = runs["ref"]
    for out in runs["port"]:
        assert int(out[f"dp_{tag}_steps"]) == 4
        np.testing.assert_allclose(out[f"dp_{tag}_loss"],
                                   ref[f"dp_{tag}_loss"], rtol=rtol)
        np.testing.assert_allclose(out[f"dp_{tag}_grad_norm"],
                                   ref[f"dp_{tag}_grad_norm"], rtol=rtol)


def test_int8_ef_converges_like_fp32(runs):
    """The reference's bar (``tests/test_multidevice.py``): within 5 % of
    the fp32 losses at every step, and decreasing.  Every rank reports the
    same numbers; the step issues an all-to-all and an all-gather where the
    fp32 step issues all-reduces."""
    out = runs["port"][0]
    fp32, int8 = out["dp_fp32_loss"], out["dp_int8_ef_loss"]
    assert np.all(np.abs(fp32 - int8) / fp32 < 0.05), (fp32, int8)
    assert int8[-1] < int8[0]
    for other in runs["port"][1:]:
        np.testing.assert_array_equal(other["dp_int8_ef_loss"], int8)
    # a step's bytes a rank: the f32 gradients and loss all-reduced, against
    # each gradient padded to RANKS chunks of int8 codes and a f32 scale a
    # chunk (through the all-to-all whole, through the all-gather a
    # rank's shard) and the loss
    sizes = [t.numel() for t in ttransformer.param_shapes(
        _dp_cfg(TARCHS)).values()]
    unit = RANKS * comp.CHUNK
    padded = [-(-m // unit) * unit for m in sizes]
    assert json.loads(str(out["dp_fp32_bytes"])) == {
        "all-reduce": 4 * sum(sizes) + 4}
    assert json.loads(str(out["dp_int8_ef_bytes"])) == {
        "all-to-all": sum(p + 4 * p // comp.CHUNK for p in padded),
        "all-gather": sum(p // RANKS + 4 * p // unit for p in padded),
        "all-reduce": 4}


def test_elastic_resume_on_half_the_ranks(runs):
    """Two DP steps on 4 ranks, a checkpoint, then one step on 2 ranks from
    it with a fresh residual: step 3, a finite loss equal to the
    reference's 4 -> 2 device switch."""
    ref = runs["ref"]
    for out in runs["resume"]:
        assert int(out["restored_step"]) == 2 and int(out["step"]) == 3
        assert np.isfinite(float(out["loss"]))
        np.testing.assert_allclose(float(out["loss"]),
                                   float(ref["resume_loss"]), rtol=1e-4)
    assert int(ref["resume_step"]) == 3


def test_meshes_refuse_what_the_group_cannot_hold(runs):
    for r, out in enumerate(runs["port"]):
        assert json.loads(str(out["mesh"])) == [["data"], [RANKS], r]
        wrong_size, production, backend = json.loads(str(out["refusals"]))
        assert "needs 8 ranks" in wrong_size
        assert "needs 256 ranks" in production
        assert "nccl" in backend


# ---------------------------------------------------------------------------
# the context-parallel branch of attn_apply
# ---------------------------------------------------------------------------


def test_context_parallel_attention_matches_the_reference(runs, monkeypatch):
    """3 heads on a model axis of 2 (S 2048): the q range splits in two
    slices, each against the whole of k and v, as the reference's does."""
    inp, ref = runs["inp"], runs["ref"]
    cfg = dataclasses.replace(TARCHS["llama3.2-3b"].reduced(),
                              n_heads=CP["n_heads"],
                              n_kv_heads=CP["n_kv_heads"],
                              param_dtype="float32", compute_dtype="float32")
    block = tattn.Attention(cfg, torch.float32, "cpu",
                            torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(block, name).weight.copy_(
                torch.from_numpy(inp[f"attn_{name}"]).T)
    seen = []
    core = tattn.attention_core

    def spy(q, *a, **kw):
        seen.append((q.shape[1], kw.get("q_offset", 0)))
        return core(q, *a, **kw)
    monkeypatch.setattr(tattn, "attention_core", spy)
    mesh = type("Mesh", (), {"mesh_dim_names": ("data", "model"),
                             "shape": (1, CP["tp"])})()
    with torch.no_grad(), flags.use_kernels(False), \
            sharding.use_sharding(mesh, Plan(dp_axes=("data",))):
        assert sharding.context_parallel_factor(CP["n_heads"], CP["S"]) \
            == int(ref["attn_cp"]) == 2
        out, _ = tattn.attn_apply(block, torch.from_numpy(inp["attn_x"]),
                                  cfg)
    assert seen == [(1024, 0), (1024, 1024)]
    np.testing.assert_allclose(out.numpy(), ref["attn_out"], rtol=1e-5,
                               atol=1e-5)
