"""The port's kernel model and autotuner against the JAX package, on the
CPU: ``kernels/autotune.py``, the ``KernelModel`` registries of
``core/kernelmodel.py``, ``core/extract.pallas_props`` and the four
kernels' ``schedule_props`` (mirrors of ``tests/test_autotune.py`` and of
``tests/test_kernels.py``'s schedule test).

At the reference's grids and blocks, passed explicitly
(``kernelmodel.PALLAS_KERNELS``), every score and pick equals the
reference's at rtol 1e-12.  Over the CUDA registry (``KERNELS``): the
compiled scorer equals the interpreted one at 1e-12, the pick is in the top
3 of the exhaustive sweep, the grids list only tiles the CUDA sources build
(their Python mirrors, which ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold against the C queries on a card) under a block's
shared memory, and the SSD pick at zamba2's and mamba2's shapes under the
``gpu-h100`` seed is a tensor-core chunk.  ``"auto"`` through every
``ops`` wrapper on a CPU tensor runs the plain version, within the
reference's tolerance of the reference's ``"auto"`` kernel in interpret
mode.  Nothing here builds a CUDA source.
"""
from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kernelmodel as jkm
from repro.core import symcount as jsym
from repro.kernels import autotune as jat
from repro.kernels import flash_attention as jfa
from repro.kernels import matmul as jmm
from repro.kernels import ops as jops
from repro.kernels import ssd_scan as jssd
from repro.kernels import transpose as jtr
from repro_torch.core import extract, kernelmodel
from repro_torch.core import properties as props
from repro_torch.core.symcount import (
    CeilDiv, Const, Expr, FloorDiv, Max, Min, Piecewise, Var, as_expr,
    compile_vector, evaluate_vector,
)
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.kernels import transpose as ttr

torch.set_num_threads(1)

RTOL = 1e-12
PALLAS = kernelmodel.PALLAS_KERNELS

# the reference's shapes (tests/test_autotune.py)
SHAPES = {
    "matmul": {"M": 1024, "N": 512, "K": 2048, "bits": 16},
    "flash_attention": {"B": 2, "H": 8, "KVH": 2, "Sq": 2048, "Skv": 2048,
                        "dh": 64, "causal": True, "window": None,
                        "bits": 16},
    "ssd_scan": {"Bz": 2, "H": 8, "L": 2048, "P": 64, "N": 128, "bits": 16},
    "transpose": {"M": 2048, "N": 1024, "bits": 32},
}
KERNELS = sorted(SHAPES)

# the port's main paths and calibration, at the shapes the card runs
CARD_SHAPES = [
    ("matmul", {"M": 4096, "N": 4096, "K": 4096, "bits": 32}),
    ("matmul", {"M": 4096, "N": 4096, "K": 4096, "bits": 16}),
    ("matmul", {"M": 4096, "N": 4096, "K": 4096, "bits": 16, "va": False,
                "vb": True}),
    ("flash_attention", {"B": 4, "H": 24, "KVH": 8, "Sq": 2048,
                         "Skv": 2048, "dh": 128, "causal": True,
                         "window": None, "bits": 32}),
    ("flash_attention", {"B": 4, "H": 32, "KVH": 32, "Sq": 2048,
                         "Skv": 2048, "dh": 80, "causal": True,
                         "window": None, "bits": 16}),
    ("flash_attention", {"B": 4, "H": 24, "KVH": 24, "Sq": 2048,
                         "Skv": 2048, "dh": 64, "causal": True,
                         "window": None, "bits": 32}),
    ("ssd_scan", {"Bz": 4, "H": 80, "L": 2048, "P": 64, "N": 64,
                  "bits": 16, "tma": True}),
    ("ssd_scan", {"Bz": 4, "H": 32, "L": 2048, "P": 64, "N": 128,
                  "bits": 32, "tma": False}),
    ("transpose", {"M": 16384, "N": 16384, "bits": 32, "aligned": True}),
    ("transpose", {"M": 16384, "N": 16384, "bits": 16, "aligned": True}),
]
CARD_IDS = [f"{k}{i}" for i, (k, _) in enumerate(CARD_SHAPES)]


# ---------------------------------------------------------------------------
# (a) compiled ≡ interpreted on randomized expression trees
# ---------------------------------------------------------------------------

_VARS = ("x", "y", "z")


def _rand_expr(rng: random.Random, depth: int = 0) -> Expr:
    if depth > 4 or rng.random() < 0.25:
        if rng.random() < 0.5:
            return Const(rng.randint(1, 9))
        return Var(rng.choice(_VARS))
    op = rng.choice(["add", "sub", "mul", "fdiv", "cdiv", "max", "min",
                     "pow", "div", "pw"])
    a = _rand_expr(rng, depth + 1)
    b = _rand_expr(rng, depth + 1)
    if op == "add":
        return a + b
    if op == "sub":
        return a - b
    if op == "mul":
        return a * b
    if op == "fdiv":
        return FloorDiv(a, as_expr(rng.randint(1, 7)))
    if op == "cdiv":
        return CeilDiv(a, as_expr(rng.randint(1, 7)))
    if op == "max":
        return Max(a, b)
    if op == "min":
        return Min(a, b)
    if op == "pow":
        return a ** rng.choice([1, 2, 3])
    if op == "div":
        return a / as_expr(rng.randint(1, 7))
    return Piecewise([(a - 3, b)], a + b)


def test_compiled_matches_eval_randomized():
    rng = random.Random(1234)
    for _ in range(200):
        e = _rand_expr(rng)
        env = {v: rng.randint(1, 64) for v in _VARS}
        np.testing.assert_allclose(float(e.compile()(env)),
                                   float(e.eval(env)), rtol=RTOL)


def test_compiled_vectorized_matches_pointwise_eval():
    rng = random.Random(99)
    e = _rand_expr(rng)
    while not e.free_vars():
        e = _rand_expr(rng)
    n = 257
    envs = {v: np.asarray([rng.randint(1, 64) for _ in range(n)])
            for v in _VARS}
    arr = e.compile()(envs)
    pts = [e.eval({v: int(envs[v][i]) for v in _VARS}) for i in range(n)]
    np.testing.assert_allclose(np.asarray(arr, dtype=np.float64), pts,
                               rtol=RTOL)


def test_compile_vector_passthrough_constants():
    pv = {"a": Var("x") * 2, "b": 7.0}
    out = compile_vector(pv)({"x": 5})
    assert float(out["a"]) == 10.0 and out["b"] == 7.0


# ---------------------------------------------------------------------------
# (b) the reference's grids: every number equals the reference's
# ---------------------------------------------------------------------------


def _items(configs):
    return [tuple(sorted(c.items())) for c in configs]


@pytest.mark.parametrize("kernel", KERNELS)
def test_pallas_candidates_equal_the_reference(kernel):
    shape = SHAPES[kernel]
    got = autotune.candidate_configs(PALLAS[kernel], shape)
    assert got == jat.candidate_configs(kernel, shape)
    km, jk = PALLAS[kernel], jkm.get(kernel)
    assert km.budget == jkm.VMEM_BYTES * jkm.VMEM_BUDGET
    for c in km.candidates(shape):
        assert km.footprint(shape, c) == jk.vmem_bytes(shape, c)


@pytest.mark.parametrize("model", [None, "gpu-a100"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_scores_and_picks_equal_the_reference_at_its_grid(kernel, model):
    shape = SHAPES[kernel]
    cands = jat.candidate_configs(kernel, shape)
    np.testing.assert_allclose(
        autotune.score_configs(PALLAS[kernel], shape, cands, model),
        jat.score_configs(kernel, shape, cands, model), rtol=RTOL)
    np.testing.assert_allclose(
        autotune.score_configs_interpreted(PALLAS[kernel], shape, cands,
                                           model),
        jat.score_configs_interpreted(kernel, shape, cands, model),
        rtol=RTOL)
    got = autotune.rank_block_sizes(PALLAS[kernel], shape, model)
    want = jat.rank_block_sizes(kernel, shape, model)
    assert [c for _, c in got] == [c for _, c in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want],
                               rtol=RTOL)
    assert autotune.best_block_sizes(PALLAS[kernel], shape, model) \
        == jat.best_block_sizes(kernel, shape, model)


def test_compiled_matches_interpreted_on_the_reference_64_point_grid():
    """The reference's speed test's grid (``test_compiled_sweep_speedup_
    over_interpreted``): ≥ 64 matmul points, compiled equals interpreted
    to 1e-12.  The speedup itself is timed by ``chip_smoke.py``'s autotune
    phase, not asserted here."""
    shape = SHAPES["matmul"]
    cands = autotune.candidate_configs(PALLAS["matmul"], shape)
    assert len(cands) >= 64
    np.testing.assert_allclose(
        autotune.score_configs(PALLAS["matmul"], shape, cands),
        autotune.score_configs_interpreted(PALLAS["matmul"], shape, cands),
        rtol=RTOL)


@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["glm4-9b", "mamba2-370m", "zamba2-2.7b",
                                  "mixtral-8x7b"])
def test_workload_shapes_and_blocks_equal_the_reference(arch, phase):
    from repro.configs.registry import ARCHS as JARCHS
    from repro.core.workload import WorkloadSpec as JSpec
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.workload import WorkloadSpec
    kw = dict(phase=phase, global_batch=16, seq_len=1024)
    for dp, tp, mb in ((1, 1, 1), (4, 2, 2)):
        got = autotune.workload_kernel_shapes(
            ARCHS[arch], WorkloadSpec(**kw), dp=dp, tp=tp, microbatches=mb)
        want = jat.workload_kernel_shapes(
            JARCHS[arch], JSpec(**kw), dp=dp, tp=tp, microbatches=mb)
        assert got == want
        assert autotune.best_blocks_for_workload(
            ARCHS[arch], WorkloadSpec(**kw), dp=dp, tp=tp, microbatches=mb,
            kernels=PALLAS) == jat.best_blocks_for_workload(
            JARCHS[arch], JSpec(**kw), dp=dp, tp=tp, microbatches=mb)
        cuda = autotune.best_blocks_for_workload(
            ARCHS[arch], WorkloadSpec(**kw), "gpu-h100", dp=dp, tp=tp,
            microbatches=mb)
        assert cuda.keys() == got.keys()
        for kern, blocks in cuda.items():
            assert blocks in autotune.candidate_configs(kern, got[kern])


def test_vector_builders_default_to_the_reference_and_count_the_pipe():
    """``variant=None`` is the reference's vector; a CUDA variant counts its
    products on its pipe: ``mxu:16`` on ``wgmma``, ``mxu:32`` on the FP32
    pipes, whatever the input type, with the slots of a partly filled last
    wave paid for (the products times the waves' slots over the blocks),
    one ``group`` a wave and the waits of its walk as ``barrier``."""
    args = {
        "matmul_vector": ((512, 256, 1024), dict(block_m=64, block_n=128,
                                                 block_k=32)),
        "flash_attention_vector": ((2, 8, 2, 512, 512, 64),
                                   dict(block_q=64, block_k=128, window=96)),
        "ssd_scan_vector": ((2, 8, 512, 64, 128), dict(chunk=64)),
        "transpose_vector": ((512, 256), dict(block=32)),
    }
    pipes = {"matmul_vector": ("paper16", "fma128", "wgmma"),
             "flash_attention_vector": ("fma", "wgmma"),
             "ssd_scan_vector": ("fma", "wgmma"),
             "transpose_vector": ("scalar", "vec16")}
    blocks = {"matmul_vector": 8 * 2, "flash_attention_vector": 2 * 8 * 8,
              "ssd_scan_vector": 2 * 8, "transpose_vector": 16 * 8}
    for name, (pos, kw) in args.items():
        for bits in (16, 32):
            ev = jsym.evaluate_vector(
                getattr(jkm, name)(*pos, bits=bits, **kw), {})
            got = evaluate_vector(
                getattr(kernelmodel, name)(*pos, bits=bits, **kw), {})
            assert got == ev
            for variant in pipes[name]:
                with pytest.raises(ValueError, match="resident="):
                    getattr(kernelmodel, name)(*pos, bits=bits,
                                               variant=variant, **kw)
                for resident in (1, 2):
                    pv = evaluate_vector(getattr(kernelmodel, name)(
                        *pos, bits=bits, variant=variant, resident=resident,
                        **kw), {})
                    n = blocks[name]
                    per_sm = min(resident, -(-n // kernelmodel.SMS))
                    waves = -(-n // (kernelmodel.SMS * per_sm))
                    assert pv[props.GROUPS] == waves
                    assert pv[props.BARRIER] >= waves
                    if name == "transpose_vector":
                        per = 128 // bits if variant == "vec16" else 1
                        assert pv[props.mem_key("load", bits, "s1")] \
                            == pv[props.mem_key("store", bits, "s1")] \
                            == 512 * 256 / per
                        assert props.mxu_key(16) not in pv
                        continue
                    pipe = 16 if variant == "wgmma" else 32
                    assert props.mxu_key(pipe) in pv
                    assert props.mxu_key(48 - pipe) not in pv
                    slots = waves * kernelmodel.SMS * per_sm / n
                    if name != "ssd_scan_vector" or variant == "wgmma":
                        # chunk 64: one diagonal tile, the reference's count
                        np.testing.assert_allclose(
                            pv[props.mxu_key(pipe)],
                            ev[props.mxu_key(bits)] * slots, rtol=RTOL)
                    else:   # the FP32 kernel's strips, the same order
                        ratio = pv[props.mxu_key(pipe)] \
                            / (ev[props.mxu_key(bits)] * slots)
                        assert 0.5 < ratio < 2.0


# ---------------------------------------------------------------------------
# (b) the CUDA registry: the sources' tiles, under a block's shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel,shape", CARD_SHAPES, ids=CARD_IDS)
def test_cuda_compiled_scoring_matches_interpreted(kernel, shape):
    cands = autotune.candidate_configs(kernel, shape)
    for model in (None, "gpu-h100"):
        np.testing.assert_allclose(
            autotune.score_configs(kernel, shape, cands, model),
            autotune.score_configs_interpreted(kernel, shape, cands, model),
            rtol=RTOL)


@pytest.mark.parametrize("kernel,shape", CARD_SHAPES + [
    (k, s) for k, s in SHAPES.items()], ids=CARD_IDS + KERNELS)
def test_cuda_pick_in_top3_of_exhaustive(kernel, shape):
    for model in (None, "gpu-h100"):
        best = autotune.best_block_sizes(kernel, shape, model)
        cands = autotune.candidate_configs(kernel, shape)
        secs = autotune.score_configs_interpreted(kernel, shape, cands,
                                                  model)
        top3 = {tuple(sorted(cands[i].items()))
                for i in np.argsort(secs, kind="stable")[:3]}
        assert tuple(sorted(best.items())) in top3


@pytest.mark.parametrize("kernel,shape", CARD_SHAPES + [
    (k, s) for k, s in SHAPES.items()], ids=CARD_IDS + KERNELS)
def test_cuda_candidates_fit_a_block_and_are_served_as_asked(kernel, shape):
    """Every candidate fits ``kSmemLimit`` and is a tile the CUDA source
    serves the request with (the request is the tile that runs)."""
    km = kernelmodel.get(kernel)
    assert km.budget == kernelmodel.SMEM_LIMIT == 232448
    cands = autotune.candidate_configs(kernel, shape)
    assert cands and len(_items(cands)) == len(set(_items(cands)))
    for c in cands:
        assert km.footprint(shape, c) <= kernelmodel.SMEM_LIMIT
        if kernel == "matmul":
            t = kernelmodel._mm_tile(shape, c)
            assert (t.bm, t.bn, t.bk) == (c["block_m"], c["block_n"],
                                          c["block_k"])
        elif kernel == "flash_attention" and shape["bits"] == 32:
            assert tfa.pick_tiles(c["block_q"], c["block_k"], shape["dh"]) \
                == (c["block_q"], c["block_k"])
        elif kernel == "transpose":
            assert ttr.edge_rule(c["block"]) == c["block"]
        elif kernel == "ssd_scan":
            chunk = min(c["chunk"], shape["L"])
            assert tssd.tile_rule(shape["P"], shape["N"], chunk,
                                  km.variant(shape, c)).p_block \
                == c["p_block"]


@pytest.mark.parametrize("bits,va,vb,want", [
    (32, True, True, [(16, 16, 16), (128, 128, 32)]),
    (32, False, True, [(16, 16, 16), (128, 128, 16)]),
    (16, True, True, [(16, 16, 16), (128, 256, 64)]),
    (16, True, False, [(16, 16, 16), (128, 128, 32)]),
])
def test_matmul_grid_is_the_sources_kernels(bits, va, vb, want):
    shape = {"M": 1024, "N": 512, "K": 2048, "bits": bits, "va": va,
             "vb": vb}
    cands = autotune.candidate_configs("matmul", shape)
    assert [(c["block_m"], c["block_n"], c["block_k"]) for c in cands] \
        == want
    km = kernelmodel.get("matmul")
    variants = [km.variant(shape, c) for c in cands]
    assert variants == ["paper16", "wgmma" if bits == 16 and va and vb
                        else "fma128"]
    # a product too small for the 128 tile gets paper16 alone
    small = dict(shape, M=8, N=8)
    assert [km.variant(small, c)
            for c in autotune.candidate_configs("matmul", small)] \
        == ["paper16"]


@pytest.mark.parametrize("dh", [16, 48, 64, 80, 96, 112, 128])
def test_attention_grids(dh):
    shape = dict(CARD_SHAPES[3][1], dh=dh)
    f32 = autotune.candidate_configs("flash_attention", shape)
    want = dict.fromkeys(tfa.pick_tiles(q, k, dh) for q in tfa.TILES
                         for k in tfa.TILES)
    assert [(c["block_q"], c["block_k"]) for c in f32] == list(want)
    for c in f32:
        assert c["resident"] == kernelmodel.resident_blocks(
            *tfa.block_resources(32, c["block_q"], c["block_k"], dh),
            tfa.smem_bytes(c["block_q"], c["block_k"], dh))
    bf16 = autotune.candidate_configs("flash_attention",
                                      dict(shape, bits=16))
    # 128 keys at every head width since P_lo went through shared memory
    assert bf16 == [{"block_q": 128, "block_k": 128, "resident": 1}]


def test_bf16_attention_auto_builds_nothing():
    """One candidate: ``"auto"`` returns the CUDA source's tile without a
    score and without compiling the source."""
    built = dict(_build._libs)
    shape = dict(CARD_SHAPES[4][1])
    assert autotune.best_block_sizes("flash_attention", shape, "gpu-h100") \
        == {"block_q": 128, "block_k": 128, "resident": 1}
    assert _build._libs == built


@pytest.mark.parametrize("name,B,S", [("zamba2-2.7b", 4, 2048),
                                      ("mamba2-370m", 4, 2048),
                                      ("zamba2-2.7b", 2, 4096)])
def test_ssd_pick_on_the_main_paths_is_a_tensor_core_chunk(name, B, S):
    """Under the card's analytic seed, the chunk the main paths run is one
    ``ssd_wgmma_kernel`` is built for: its products count ``mxu:16``, the
    FP32 kernel's ``mxu:32`` at 1/15 of the rate."""
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS[name]
    shape = {"Bz": B, "H": cfg.ssm_heads, "L": S, "P": cfg.ssm.head_dim,
             "N": cfg.ssm.d_state, "bits": 16, "tma": True}
    best = autotune.best_block_sizes("ssd_scan", shape, "gpu-h100")
    assert best["chunk"] in tssd.WGMMA_CHUNKS
    assert kernelmodel.get("ssd_scan").variant(shape, best) == "wgmma"


@pytest.mark.parametrize("name,B,S", [("zamba2-2.7b", 2, 4096),
                                      ("mamba2-370m", 2, 4096),
                                      ("zamba2-2.7b", 4, 2048)])
def test_ssd_pick_under_autograd_is_a_tensor_core_chunk(name, B, S):
    """A training step calls the scan under autograd, where its bf16
    backward runs on the backward kernels, priced the same at every chunk:
    ``"auto"`` picks the forward kernel's own chunk, the pick without
    autograd, and ``pick_variant`` sends it to ``ssd_wgmma_kernel``, not
    the FP32 kernel."""
    from repro_torch.configs.registry import ARCHS
    cfg = ARCHS[name]
    shape = {"Bz": B, "H": cfg.ssm_heads, "L": S, "P": cfg.ssm.head_dim,
             "N": cfg.ssm.d_state, "bits": 16, "tma": True, "grad": True}
    best = autotune.best_block_sizes("ssd_scan", shape, "gpu-h100")
    alone = autotune.best_block_sizes("ssd_scan", dict(shape, grad=False),
                                      "gpu-h100")
    assert best == alone and best["chunk"] in tssd.WGMMA_CHUNKS
    assert kernelmodel.get("ssd_scan").variant(shape, best) == "wgmma"
    assert tssd.variant_rule(cfg.ssm.head_dim, cfg.ssm.d_state,
                             best["chunk"], True) == "wgmma"
    assert tssd.backward_rule(cfg.ssm.head_dim, cfg.ssm.d_state, S,
                              True) == "kernel"


def test_ssd_wgmma_tiles_at_chunk_256_fit_shared_memory():
    """Every tensor-core tile at chunk 256 is the chunk-128 instance's
    (its 128-row stage ring) and fits a block's shared memory; the CUDA
    registry's footprint and blocks an SM say the same."""
    km = kernelmodel.get("ssd_scan")
    for P in range(16, 129, 16):
        for N in range(16, 129, 16):
            t = tssd.tile_rule(P, N, 256, "wgmma")
            assert t == tssd.tile_rule(P, N, 128, "wgmma")
            assert t.smem <= tssd.SMEM_LIMIT
            shape = {"Bz": 2, "H": 8, "L": 4096, "P": P, "N": N, "bits": 16,
                     "tma": True}
            cands = {c["chunk"]: c for c in km.candidates(shape)}
            assert km.variant(shape, cands[256]) == "wgmma"
            assert km.footprint(shape, cands[256]) == t.smem
            assert cands[256]["resident"] == cands[128]["resident"] >= 1


def test_candidates_respect_the_budget_passed():
    shape = CARD_SHAPES[3][1]
    km = kernelmodel.get("flash_attention")
    cands = autotune.candidate_configs("flash_attention", shape, budget=1e5)
    assert cands and all(km.footprint(shape, c) <= 1e5 for c in cands)
    # nothing fits: the smallest footprint is kept
    one = autotune.candidate_configs("flash_attention", shape, budget=1)
    assert one == [min(km.candidates(shape),
                       key=lambda c: km.footprint(shape, c))]


def test_best_block_sizes_accepts_registry_name_and_model():
    from repro_torch.calibration.seeds import ANALYTIC_SEEDS
    for kernel, shape in CARD_SHAPES:
        assert autotune.best_block_sizes(kernel, shape, "gpu-h100") \
            == autotune.best_block_sizes(kernel, shape,
                                         ANALYTIC_SEEDS["gpu-h100"]())


# ---------------------------------------------------------------------------
# schedule_props and pallas_props against the reference's
# ---------------------------------------------------------------------------


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=RTOL)


def test_flash_attention_schedule_props_skip_count():
    """The reference's case (64 × 64, served as asked by the f32 kernel):
    the same vector, executed pairs ≈ half of all pairs."""
    kw = dict(block_q=64, block_k=64, bits=32)
    p_c = tfa.schedule_props(1, 1, 1, 512, 512, 64, causal=True, **kw)
    p_f = tfa.schedule_props(1, 1, 1, 512, 512, 64, causal=False, **kw)
    _close(p_c, jfa.schedule_props(1, 1, 1, 512, 512, 64, causal=True, **kw))
    _close(p_f, jfa.schedule_props(1, 1, 1, 512, 512, 64, causal=False,
                                   **kw))
    assert p_c[props.mxu_key(32)] < 0.6 * p_f[props.mxu_key(32)]
    assert p_c[props.BARRIER] == p_f[props.BARRIER]  # grid still walks


@pytest.mark.parametrize("dh,bq,bk,bits,causal,window", [
    (64, 32, 32, 32, True, None), (64, 128, 64, 32, True, 96),
    (64, 64, 128, 32, False, None), (128, 128, 64, 32, True, None),
    (64, 128, 128, 16, True, None), (80, 128, 128, 16, True, 256),
    (128, 128, 128, 16, True, None)])
def test_flash_attention_schedule_props_where_the_tile_is_the_request(
        dh, bq, bk, bits, causal, window):
    args = (2, 4, 2, 512, 512, dh)
    kw = dict(causal=causal, window=window, block_q=bq, block_k=bk,
              bits=bits)
    _close(tfa.schedule_props(*args, **kw), jfa.schedule_props(*args, **kw))


def test_flash_attention_schedule_props_count_the_served_tile():
    # bf16 at dh 128 runs 128 x 128 whatever the request
    got = tfa.schedule_props(2, 4, 2, 512, 512, 128, block_q=32,
                             block_k=32, bits=16)
    _close(got, jfa.schedule_props(2, 4, 2, 512, 512, 128, block_q=128,
                                   block_k=128, bits=16))


@pytest.mark.parametrize("req,served,bits", [
    ((16, 16, 16), (16, 16, 16), 32), ((128, 128, 32), (128, 128, 32), 32),
    ((128, 128, 128), (128, 128, 32), 32), ((512, 64, 8), (128, 128, 32), 32),
    ((128, 256, 64), (128, 256, 64), 16), ((64, 64, 64), (128, 256, 64), 16)])
def test_matmul_schedule_props(req, served, bits):
    M, N, K = 1024, 512, 2048
    got = tmm.schedule_props(M, N, K, block_m=req[0], block_n=req[1],
                             block_k=req[2], bits=bits)
    _close(got, jmm.schedule_props(M, N, K, block_m=served[0],
                                   block_n=served[1], block_k=served[2],
                                   bits=bits))


def test_matmul_schedule_props_bf16_on_the_fp32_pipes():
    got = tmm.schedule_props(1024, 512, 2048, block_m=16, block_n=16,
                             block_k=16, bits=16)
    want = jmm.schedule_props(1024, 512, 2048, block_m=16, block_n=16,
                              block_k=16, bits=16)
    assert got[props.mxu_key(32)] == want[props.mxu_key(16)]
    assert props.mxu_key(16) not in got
    assert got[props.local_key(16)] == want[props.local_key(16)]


@pytest.mark.parametrize("N,chunk,bits,tma,ref_bits", [
    (128, 64, 32, None, 32), (64, 256, 32, None, 32), (128, 64, 16, None, 16),
    (128, 128, 16, True, 16), (128, 32, 16, None, 32), (64, 256, 16, False, 32),
    (128, 128, 16, False, 32)])
def test_ssd_schedule_props(N, chunk, bits, tma, ref_bits):
    """On the kernel that runs the chunk: ``wgmma`` counts as the
    reference's bf16 vector, the FP32 kernel as its f32 one (one P slice a
    block here)."""
    args = (2, 8, 1024, 64, N)
    assert tssd.tile_rule(64, N, chunk, "fma").p_block == 64
    got = tssd.schedule_props(*args, chunk=chunk, bits=bits, tma=tma)
    _close(got, jssd.schedule_props(*args, chunk=chunk, bits=ref_bits))


@pytest.mark.parametrize("N", [64, 128])
def test_ssd_schedule_props_at_chunk_256_count_the_halves(N):
    """On ``wgmma`` a chunk of 256 runs as two halves of 128 rows: the
    reference's bf16 vector at chunk 128.  The CUDA vector's kernel keys
    equal chunk 128's; under autograd the backward kernels add their own
    keys, the same at both chunks, and their launches."""
    args = (2, 8, 1024, 64, N)
    got = tssd.schedule_props(*args, chunk=256, bits=16, tma=True)
    _close(got, jssd.schedule_props(*args, chunk=128, bits=16))
    vec = {c: evaluate_vector(kernelmodel.ssd_scan_vector(
        *args, chunk=c, bits=16, variant="wgmma", p_block=64, resident=1),
        {}) for c in (128, 256)}
    assert vec[256] == vec[128]
    assert vec[256][props.BARRIER] == 1 * (1024 // 128) \
        * tssd.WGMMA_SYNCS_PER_CHUNK
    bwd = {c: evaluate_vector(kernelmodel.ssd_scan_vector(
        *args, chunk=c, bits=16, variant="wgmma", p_block=64, resident=1,
        backward=True), {}) for c in (128, 256)}
    assert bwd[256][props.CONST1] == 1 + tssd.BACKWARD_LAUNCHES
    assert bwd[256] == bwd[128]
    kern = evaluate_vector(kernelmodel.ssd_backward_vector(*args), {})
    assert bwd[256] == {k: vec[256].get(k, 0) + kern.get(k, 0)
                        for k in set(vec[256]) | set(kern)}


@pytest.mark.parametrize("chunk", [64, 128, 256])
def test_ssd_backward_vector_does_not_grow_with_the_chunk(chunk):
    """Under autograd, bf16 with P, N multiples of 16 up to 128: the SSD
    vector adds ``ssd_backward_vector`` (the backward kernels' TF32
    products on the tensor cores, shared-memory reads, device-memory
    accesses and ``BACKWARD_LAUNCHES`` launches) and nothing that grows
    with the number of chunks; f32 keeps the plain path's recompute, 175
    dispatches a chunk."""
    args = (2, 80, 4096, 64, 64)
    kw = dict(chunk=chunk, p_block=64, resident=1)
    fwd = evaluate_vector(kernelmodel.ssd_scan_vector(
        *args, bits=16, variant="wgmma", **kw), {})
    bwd = evaluate_vector(kernelmodel.ssd_scan_vector(
        *args, bits=16, variant="wgmma", backward=True, **kw), {})
    kern = evaluate_vector(kernelmodel.ssd_backward_vector(*args), {})
    assert bwd[props.CONST1] == fwd[props.CONST1] + tssd.BACKWARD_LAUNCHES
    assert bwd == {k: fwd.get(k, 0) + kern.get(k, 0)
                   for k in set(fwd) | set(kern)}
    assert props.mxu_key(16) in kern and props.mxu_key(32) not in kern
    # products: at least four times the forward's count at chunk 64 (TF32
    # at half the bf16 rate, the backward's own products at least twice
    # the forward's), at most sixteen times
    Bz, H, L, P, N = args
    fwd64 = 2 * Bz * H * (L // 64) * (64 * 64 * (N + P) + 2 * 64 * P * N)
    assert 4 * fwd64 < kern[props.mxu_key(16)] < 16 * fwd64
    f32 = evaluate_vector(kernelmodel.ssd_scan_vector(
        *args, bits=32, variant="fma", backward=True, **kw), {})
    assert f32[props.CONST1] == 1 + (L // chunk) \
        * tssd.RECOMPUTE_DISPATCHES_PER_CHUNK


def test_ssd_prefill_picks_are_unchanged_by_the_backward():
    """Without autograd (the prefill paths) the SSD pick reads no
    backward: 128 at the prefill shapes of zamba2-2.7b and mamba2-370m
    (4 x 2048), 64 at zamba2's training shape."""
    from repro_torch.configs.registry import ARCHS
    for name, B, S, want in (("zamba2-2.7b", 4, 2048, 128),
                             ("mamba2-370m", 4, 2048, 128),
                             ("zamba2-2.7b", 2, 4096, 64)):
        cfg = ARCHS[name]
        shape = {"Bz": B, "H": cfg.ssm_heads, "L": S, "P": cfg.ssm.head_dim,
                 "N": cfg.ssm.d_state, "bits": 16, "tma": True}
        for grad in (None, False):
            sh = shape if grad is None else dict(shape, grad=grad)
            assert autotune.best_block_sizes("ssd_scan", sh, "gpu-h100")[
                "chunk"] == want, (name, B, S)


def test_ssd_schedule_props_count_the_p_slices():
    """At chunk 256 and N 128 the FP32 kernel splits P 64 into slices of
    16: four cells a (batch, head, chunk), each recomputing C·Bᵀ — as the
    reference's vector of four heads of P 16 counts them."""
    got = tssd.schedule_props(2, 8, 1024, 64, 128, chunk=256, bits=32)
    _close(got, jssd.schedule_props(2, 32, 1024, 16, 128, chunk=256,
                                    bits=32))
    # the CUDA vector's grid: a block a (batch, head, P slice), 64 of
    # them, one an SM, walking 4 chunks
    pv = evaluate_vector(kernelmodel.ssd_scan_vector(
        2, 8, 1024, 64, 128, chunk=256, bits=32, variant="fma",
        p_block=16, resident=1), {})
    assert pv[props.GROUPS] == 1
    assert pv[props.BARRIER] == 4 * (
        tssd.fma_syncs_per_chunk(256) + (kernelmodel.MEMORY_WAIT_BARRIERS - 1)
        * tssd.fma_memory_waits_per_chunk(256))


@pytest.mark.parametrize("block,served", [(16, 16), (32, 32), (64, 64),
                                          (256, 64), (48, 32)])
def test_transpose_schedule_props(block, served):
    _close(ttr.schedule_props(2048, 1024, block=block),
           jtr.schedule_props(2048, 1024, block=served))


@pytest.mark.parametrize("bits,per", [(32, 1), (16, 2), (8, 1)])
def test_pallas_props_equal_the_reference(bits, per):
    from repro.core import extract as jextract
    args = ((4, 8, 2), (128 * 64, 64 * 32), (128 * 32,))
    assert extract.pallas_props(*args, bits=bits, barriers_per_step=per) \
        == jextract.pallas_props(*args, bits=bits, barriers_per_step=per)


# ---------------------------------------------------------------------------
# (c) block_sizes="auto" through the wrappers vs the reference's "auto"
# ---------------------------------------------------------------------------


def _rng_tensor(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def test_auto_matmul_matches_ref():
    rng = np.random.default_rng(0)
    a, b = _rng_tensor(rng, (256, 512)), _rng_tensor(rng, (512, 384))
    o = tops.matmul(a, b, block_sizes="auto")
    assert torch.equal(o, tmm.matmul_reference(a, b))
    r = jops.matmul(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                    block_sizes="auto", interpret=True)
    np.testing.assert_allclose(_np(o), _np(r), atol=1e-3, rtol=1e-5)


def test_auto_flash_attention_matches_ref():
    rng = np.random.default_rng(7)
    q = _rng_tensor(rng, (2, 4, 256, 64))
    k, v = _rng_tensor(rng, (2, 2, 256, 64)), _rng_tensor(rng, (2, 2, 256, 64))
    o = tops.flash_attention(q, k, v, causal=True, block_sizes="auto")
    r = jops.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                             causal=True, block_sizes="auto", interpret=True)
    np.testing.assert_allclose(_np(o), _np(r), atol=3e-5, rtol=3e-5)


def test_auto_ssd_scan_matches_ref():
    rng = np.random.default_rng(3)
    Bz, H, G, L, P, N = 1, 2, 1, 256, 16, 16
    x = 0.5 * _rng_tensor(rng, (Bz, H, L, P))
    dt = torch.nn.functional.softplus(_rng_tensor(rng, (Bz, H, L)))
    A = -torch.exp(0.3 * _rng_tensor(rng, (H,)))
    B, C = (0.3 * _rng_tensor(rng, (Bz, G, L, N)) for _ in range(2))
    y, h = tops.ssd_scan(x, dt, A, B, C, block_sizes="auto")
    yr, hr = jops.ssd_scan(*(jnp.asarray(t.numpy())
                             for t in (x, dt, A, B, C)),
                           block_sizes="auto", interpret=True)
    np.testing.assert_allclose(_np(y), _np(yr), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(_np(h), _np(hr), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_auto_transpose_matches_ref(dtype):
    x = _rng_tensor(np.random.default_rng(5), (512, 256),
                    getattr(torch, dtype))
    o = tops.transpose(x, block_sizes="auto")
    r = jops.transpose(jnp.asarray(x.float().numpy()).astype(dtype),
                       block_sizes="auto", interpret=True)
    np.testing.assert_array_equal(_np(o), _np(r))


def test_ops_resolve_auto_once_per_layout_and_stay_bounded(monkeypatch):
    """``"auto"`` through ``ops`` is memoized per layout of the arguments
    (a hit does not ask the tuner again) and the memo is emptied at its
    bound."""
    calls = []
    best = autotune.best_block_sizes

    def counted(*a, **k):
        calls.append(a[0])
        return best(*a, **k)
    monkeypatch.setattr(autotune, "best_block_sizes", counted)
    monkeypatch.setattr(tops, "_AUTO", {})
    monkeypatch.setattr(tops, "_AUTO_MAX", 2)
    x = torch.zeros(64, 32)
    for _ in range(3):
        assert torch.equal(tops.transpose(x, block_sizes="auto"), x.t())
    assert calls == ["transpose"]
    for n in (48, 40, 64):   # 48 fills the memo, 40 empties it, 64 is new
        tops.transpose(torch.zeros(n, 32), block_sizes="auto")
    assert len(calls) == 4 and len(tops._AUTO) == 2
    # a model given as an object is scored on every call, as the reference
    from repro_torch.calibration.seeds import ANALYTIC_SEEDS
    m = ANALYTIC_SEEDS["gpu-h100"]()
    tops.transpose(x, block_sizes="auto", model=m)
    tops.transpose(x, block_sizes="auto", model=m)
    assert len(calls) == 6


def test_default_model_follows_the_tensor():
    assert tops.default_model(torch.zeros(1)) is None
    assert tops.default_model(torch.zeros(1, device="meta")) is None
    assert tops.CARD_MODEL == "gpu-h100"


# ---------------------------------------------------------------------------
# step composition — unchanged by the registry
# ---------------------------------------------------------------------------


def test_step_kernel_vectors_track_archcount_mxu():
    """The kernel-composed mxu total agrees with archcount's step count in
    the leading term, as in the reference."""
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core import archcount
    from repro_torch.core.symcount import add_vectors
    from repro_torch.core.workload import WorkloadSpec
    env = {"B": 8, "S": 4096, "M": 1}
    for arch in ("glm4-9b", "mamba2-370m", "mixtral-8x7b", "zamba2-2.7b"):
        cfg = ARCHS[arch]
        bits = 16 if "16" in cfg.compute_dtype else 32
        # the card's tiles are resolved at the spec's shape
        total = add_vectors(*kernelmodel.step_kernel_vectors(
            cfg, WorkloadSpec(phase="prefill", global_batch=8,
                              seq_len=4096)).values())
        kern = evaluate_vector(total, env)[props.mxu_key(bits)]
        step = archcount.forward_counts(cfg)[props.mxu_key(bits)].eval(env)
        assert kern == pytest.approx(step, rel=0.05), (arch, kern, step)


# ---------------------------------------------------------------------------
# the CUDA registry's picks against the card's times (a run of
# chip_smoke.py's autotune phase before this model, NVIDIA H100 80GB HBM3
# at 700 W: the median ms of every candidate, keyed by its request)
# ---------------------------------------------------------------------------

CARD_MS = {
    "llama-f32-attention": (
        {"B": 4, "H": 24, "KVH": 8, "Sq": 2048, "Skv": 2048, "dh": 128,
         "causal": True, "window": None, "bits": 32},
        {(32, 32): 5.2246, (32, 64): 5.1817, (32, 128): 7.9229,
         (64, 32): 4.2687, (64, 64): 5.3652, (64, 128): 5.1648,
         (128, 32): 4.3001, (128, 64): 4.3617}),
    "musicgen-f32-attention": (
        {"B": 4, "H": 24, "KVH": 24, "Sq": 2048, "Skv": 2048, "dh": 64,
         "causal": True, "window": None, "bits": 32},
        {(32, 32): 2.995, (32, 64): 2.7606, (32, 128): 3.1067,
         (64, 32): 2.2777, (64, 64): 2.2757, (64, 128): 3.3798,
         (128, 32): 2.3519, (128, 64): 2.3936, (128, 128): 2.5327}),
    # the f32 SSD rows: device-timed (the median of CUDA-graph replays)
    "zamba2-f32-ssd": (
        {"Bz": 4, "H": 80, "L": 2048, "P": 64, "N": 64, "bits": 32},
        {(16,): 2.4893, (32,): 1.577, (64,): 1.4031, (128,): 1.657,
         (256,): 2.7042}),
    "mamba2-f32-ssd": (
        {"Bz": 4, "H": 32, "L": 2048, "P": 64, "N": 128, "bits": 32},
        {(16,): 1.5726, (32,): 1.0895, (64,): 1.0681, (128,): 1.192,
         (256,): 4.6689}),
    # the bf16 SSD rows: a later run of the same phase, once chunk 256 ran
    # on the tensor-core kernel (two halves of 128 rows; before, on the
    # FP32 kernel: 2.68, 4.43 and 3.56 ms)
    "zamba2-bf16-ssd": (
        {"Bz": 4, "H": 80, "L": 2048, "P": 64, "N": 64, "bits": 16,
         "tma": True},
        {(16,): 2.2195, (32,): 1.6045, (64,): 0.2207, (128,): 0.1785,
         (256,): 0.1773}),
    "mamba2-bf16-ssd": (
        {"Bz": 4, "H": 32, "L": 2048, "P": 64, "N": 128, "bits": 16,
         "tma": True},
        {(16,): 1.5872, (32,): 1.0928, (64,): 0.0799, (128,): 0.0834,
         (256,): 0.0835}),
    "zamba2-train-bf16-ssd": (
        {"Bz": 2, "H": 80, "L": 4096, "P": 64, "N": 64, "bits": 16,
         "tma": True},
        {(16,): 2.5953, (32,): 1.6931, (64,): 0.2238, (128,): 0.2299,
         (256,): 0.231}),
    "transpose-f32": ({"M": 16384, "N": 16384, "bits": 32},
                      {(16,): 0.8037, (32,): 1.0839, (64,): 0.9509}),
    "transpose-bf16": ({"M": 16384, "N": 16384, "bits": 16},
                       {(16,): 0.6375, (32,): 0.9539, (64,): 0.728}),
}
KERNEL_OF = {"attention": "flash_attention", "ssd": "ssd_scan",
             "transpose": "transpose"}


def _pick_over_fastest(name):
    shape, ms = CARD_MS[name]
    kernel = next(v for k, v in KERNEL_OF.items() if k in name)
    pick = autotune.best_block_sizes(kernel, shape, "gpu-h100")
    req = (pick["block_q"], pick["block_k"]) if "block_q" in pick \
        else (pick["chunk"],) if "chunk" in pick else (pick["block"],)
    return pick, ms[req] / min(ms.values())


@pytest.mark.parametrize("name", ["llama-f32-attention", "zamba2-f32-ssd",
                                  "mamba2-f32-ssd", "transpose-f32",
                                  "transpose-bf16", "zamba2-bf16-ssd",
                                  "mamba2-bf16-ssd",
                                  "zamba2-train-bf16-ssd"])
def test_seed_picks_within_ten_percent_of_the_cards_fastest(name):
    """Under the analytic ``gpu-h100`` seed, the pick is within 10 % of the
    fastest candidate the card measured (a count of grid cells misranked
    the f32 SSD by 1.84x at zamba2's shape and 1.14x at mamba2's, the
    transposes by 1.18x / 1.14x: the card runs waves of blocks)."""
    pick, ratio = _pick_over_fastest(name)
    assert ratio <= 1.10, (pick, ratio)


def test_seed_pick_of_musicgen_f32_attention_within_ten_percent():
    """Once 128 x 128 at 1.11x the fastest: the FP32 attention's operand
    reads priced the largest register tile cheapest until the latency one
    8-warp block an SM leaves unhidden was counted
    (``kernelmodel._unhidden``); now 64 x 64, the card's fastest."""
    pick, ratio = _pick_over_fastest("musicgen-f32-attention")
    assert ratio <= 1.10, (pick, ratio)


def test_seed_pick_of_zamba2_f32_ssd_within_five_percent():
    """Once chunk 32 at 1.07-1.12x the fastest 64: the FP32 kernel's waits
    on its tiles (one a chunk, one a strip), each a round trip to device
    memory, were priced as plain barriers, so the waits chunk 32 makes
    beyond 64's (128 against 96 a block at L 2048) went unpriced
    (``kernelmodel.MEMORY_WAIT_BARRIERS``); now 64, the card's fastest."""
    pick, ratio = _pick_over_fastest("zamba2-f32-ssd")
    assert ratio <= 1.05, (pick, ratio)


def test_bf16_main_path_picks_are_the_tiles_they_run():
    """The bf16 main paths' picks: the attention's one tile
    (``tile_rule(dh)``) and the SSD's tensor-core chunk 128 at the prefill
    shapes.  The kernel alone at zamba2's training shape picks 64 (2
    blocks an SM, one wave, the card's fastest there); the training path
    calls it under autograd, where the backward kernels cost the same at
    every chunk, and picks 64 too (until the backward kernels, the
    chunk-by-chunk recompute made it 256: 3.0 s a step against 5.1 at 128
    and 8.8 at 64 on the card)."""
    for dh in (64, 80, 128):
        shape = dict(CARD_MS["llama-f32-attention"][0], dh=dh, bits=16)
        bq, bk = tfa.tile_rule(dh)[:2]
        assert autotune.best_block_sizes("flash_attention", shape,
                                         "gpu-h100") \
            == {"block_q": bq, "block_k": bk, "resident": 1}
    km = kernelmodel.get("ssd_scan")
    for name, chunk in (("zamba2-bf16-ssd", 128), ("mamba2-bf16-ssd", 128),
                        ("zamba2-train-bf16-ssd", 64)):
        shape = CARD_MS[name][0]
        pick = autotune.best_block_sizes("ssd_scan", shape, "gpu-h100")
        assert pick["chunk"] == chunk and km.variant(shape, pick) == "wgmma"
    train = dict(CARD_MS["zamba2-train-bf16-ssd"][0], grad=True)
    pick = autotune.best_block_sizes("ssd_scan", train, "gpu-h100")
    assert pick["chunk"] == 64 and km.variant(train, pick) == "wgmma"


def test_f32_ssd_leaves_chunk_256_at_zamba2():
    pick, _ = _pick_over_fastest("zamba2-f32-ssd")
    assert pick["chunk"] != 256


@pytest.mark.parametrize("threads,regs,smem,want", [
    # the CUDA occupancy calculator on the card, asked for instances the
    # sources build: threads, registers, shared memory -> blocks an SM
    (256, 44, 9216, 5), (256, 52, 9216, 4), (256, 32, 4608, 8),
    (256, 128, 68736, 2), (256, 128, 111744, 2), (256, 128, 197760, 1),
    (256, 106, 68736, 2), (160, 153, 93488, 2), (160, 191, 159024, 1),
    (384, 168, 169520, 1), (384, 168, 165000, 1), (256, 80, 46592, 3),
    (256, 64, 31744, 4), (256, 254, 176128, 1), (64, 16, 1024, 32),
    (32, 22, 512, 32), (256, 32, 16640, 8), (256, 72, 79360, 2),
    (256, 128, 116736 - 1024, 2), (256, 128, 116736, 1),
])
def test_resident_blocks_follow_the_occupancy_rule(threads, regs, smem,
                                                   want):
    assert kernelmodel.resident_blocks(threads, regs, smem) == want


def test_residency_mirrors_are_the_sources_launch_geometry():
    """Threads a block as the CUDA sources launch them, and a register
    count for every instance they build."""
    assert (tfa.F32_THREADS, tfa.WGMMA_THREADS) == (256, 384)
    assert tssd.FMA_THREADS == 256 and tssd.WGMMA_THREADS == {64: 160,
                                                              128: 384}
    assert tmm.THREADS == {"paper16": 256, "fma128": 256, "wgmma": 384}
    for dtype, per in ((torch.float32, 4), (torch.bfloat16, 8)):
        assert ttr.tile_rule(16, dtype, "vec16").threads == 16 * 16 // per
        assert ttr.tile_rule(64, dtype, "scalar").threads == 256
    assert set(tfa.F32_REGISTERS) == {(q, k, d) for q in tfa.TILES
                                      for k in tfa.TILES
                                      for d in (16, 32, 64, 128)
                                      if tfa.smem_bytes(q, k, d)
                                      <= tfa.SMEM_LIMIT}
    assert set(tssd.FMA_REGISTERS) == {(n, p) for n in (16, 32, 64, 128)
                                       for p in (16, 32, 64)}
    # the tensor-core kernel's instances by their chunk rows: chunk 256 runs
    # the chunk-128 instance in halves
    assert tssd.WGMMA_CHUNKS == (64, 128, 256)
    assert set(tssd.WGMMA_REGISTERS) == {(tssd.wgmma_rows(c), n)
                                         for c in tssd.WGMMA_CHUNKS
                                         for n in (64, 128)} \
        == {(c, n) for c in (64, 128) for n in (64, 128)}
    for n in (16, 64, 80, 128):
        assert tssd.block_resources("wgmma", 256, n, 64) \
            == tssd.block_resources("wgmma", 128, n, 64)
    # every candidate of the main shapes carries the blocks its kernel's
    # mirrors give
    for name, (shape, _) in CARD_MS.items():
        kernel = next(v for k, v in KERNEL_OF.items() if k in name)
        km = kernelmodel.get(kernel)
        for c in autotune.candidate_configs(kernel, shape):
            assert 1 <= c["resident"] <= kernelmodel.BLOCKS_PER_SM
            per_block = km.footprint(shape, c) \
                + kernelmodel.SMEM_RESERVED_PER_BLOCK
            assert c["resident"] * per_block <= kernelmodel.SMEM_PER_SM
