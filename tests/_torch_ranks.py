"""Rank bodies of ``tests/test_torch_multidevice.py``: one process per rank
on the CPU, a gloo group that meets through a ``FileStore``.

    python tests/_torch_ranks.py TASK RANK WORLD DATA_DIR

``DATA_DIR`` holds the inputs (``inputs.npz``, ``params.npz``) and gets
this rank's results (``TASK.<rank>.npz``).  Tasks:

* ``collectives`` (4 ranks): ``psum_compressed`` and the exact sum of one
  row each, their collective bytes; the manual-DP step of smollm-360m
  reduced, 4 steps without compression and under ``int8_ef``; two steps
  more that rank 0 checkpoints for ``resume``; the meshes' refusals.
* ``resume`` (2 ranks): the checkpoint restored, a fresh ``init_ef``, one
  step.
* ``gspmd`` (4 ranks, a (2, 2) ``data, model`` mesh): the DTensor-sharded
  steps of ``test_torch_gspmd.py`` (``GSPMD_CASES``), each from the
  reference's parameters (``params.<case>.npz``): two train steps, a
  prefill, or decode iterations; whole (replicated) results.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import store
from repro_torch.configs.registry import ARCHS
from repro_torch.core import extract
from repro_torch.distributed import compression as comp
from repro_torch.launch import mesh as lmesh
from repro_torch.models import convert, transformer
from repro_torch.optim import optimizers as opt
from repro_torch.runtime import steps

DP_STEPS = 4
#: the DP configuration of ``test_torch_multidevice.py``: smollm-360m
#: reduced, in f32
DP_CFG = dict(param_dtype="float32", compute_dtype="float32")


def _dp_cfg():
    return dataclasses.replace(ARCHS["smollm-360m"].reduced(), **DP_CFG)


def _model(cfg, params):
    model = transformer.init_params(cfg, device="cpu")
    model.load_state_dict(convert.params_from_reference(cfg, params))
    return model


def _state(cfg, params, optimizer):
    model = _model(cfg, params)
    return steps.TrainState(
        model, optimizer.init(dict(model.named_parameters())), 0)


def collectives(rank: int, world: int, data: str) -> dict:
    inp = np.load(os.path.join(data, "inputs.npz"))
    params = dict(np.load(os.path.join(data, "params.npz")))
    params = _unflatten(params)
    out = {}
    mesh = lmesh.make_mesh((world,), ("data",), device="cpu")
    group = mesh.get_group("data")

    # the compressed all-reduce of one row per rank, beside the exact sum
    x = torch.from_numpy(inp["psum_x"][rank])           # (1, 4096)
    with extract.count_collectives() as approx_bytes:
        approx = comp.psum_compressed(x, group)
    part = comp.reduce_scatter_compressed(x, group)
    codes, _, _ = comp.quantize(part)
    exact = x.clone()
    with extract.count_collectives() as exact_bytes:
        dist.all_reduce(exact, group=group)
    out.update(psum_approx=approx.numpy(), psum_exact=exact.numpy(),
               psum_shard_codes=codes.numpy(),
               psum_bytes=json.dumps(approx_bytes),
               allreduce_bytes=json.dumps(exact_bytes))

    # the manual-DP step, fp32 all-reduce and int8 error feedback
    cfg = _dp_cfg()
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    optimizer = opt.get_optimizer("adamw")
    for compression in (None, "int8_ef"):
        st = _state(cfg, params, optimizer)
        fn, init_ef = steps.make_manual_dp_train_step(
            cfg, optimizer, mesh, compression=compression)
        ef = init_ef(st.params)
        losses, norms = [], []
        for i in range(DP_STEPS):
            with extract.count_collectives() as step_bytes:
                st, ef, m = fn(st, ef, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        tag = compression or "fp32"
        out[f"dp_{tag}_loss"] = np.array(losses)
        out[f"dp_{tag}_grad_norm"] = np.array(norms)
        out[f"dp_{tag}_bytes"] = json.dumps(step_bytes)
        out[f"dp_{tag}_steps"] = st.step

    # two steps, then a checkpoint for the resume on half the ranks
    st = _state(cfg, params, optimizer)
    fn, init_ef = steps.make_manual_dp_train_step(cfg, optimizer, mesh)
    ef = init_ef(st.params)
    for _ in range(2):
        st, ef, m = fn(st, ef, batch)
    if rank == 0:
        store.save(os.path.join(data, "ckpt"), st.step, steps.state_tree(st))
    dist.barrier()

    # what the meshes refuse: a size that is not the world's, a backend
    # that is not the device's
    refusals = []
    for make in (lambda: lmesh.make_mesh((world * 2,), ("data",),
                                         device="cpu"),
                 lambda: lmesh.make_production_mesh(device="cpu"),
                 lambda: lmesh.make_mesh((world,), ("data",),
                                         device="cuda")):
        try:
            make()
            refusals.append("")
        except ValueError as e:
            refusals.append(str(e))
    out["refusals"] = json.dumps(refusals)
    out["mesh"] = json.dumps([list(mesh.mesh_dim_names), list(mesh.shape),
                              mesh.get_local_rank("data")])
    return out


def resume(rank: int, world: int, data: str) -> dict:
    inp = np.load(os.path.join(data, "inputs.npz"))
    params = _unflatten(dict(np.load(os.path.join(data, "params.npz"))))
    cfg = _dp_cfg()
    optimizer = opt.get_optimizer("adamw")
    mesh = lmesh.make_mesh((world,), ("data",), device="cpu")
    st = _state(cfg, params, optimizer)   # a template, overwritten below
    live = steps.state_tree(st)
    tree, _ = store.restore(os.path.join(data, "ckpt"), live)
    tree = store.load_into(live, tree)
    st = steps.TrainState(st.params, tree["opt_state"], tree["step"])
    restored_step = st.step
    fn, init_ef = steps.make_manual_dp_train_step(cfg, optimizer, mesh)
    batch = {"tokens": torch.from_numpy(inp["tokens"]),
             "labels": torch.from_numpy(inp["labels"])}
    st, _, m = fn(st, init_ef(st.params), batch)
    return {"restored_step": restored_step, "step": st.step,
            "loss": float(m["loss"])}


#: the sharded cases of ``test_torch_gspmd.py``: (architecture, changes to
#: its reduced f32 configuration, phase, plan changes)
GSPMD_CASES = {
    "train": ("smollm-360m", {}, "train", {}),
    "hybrid": ("zamba2-2.7b", {}, "prefill", {}),
    "decode": ("llama3.2-3b", {}, "decode", {}),
    "ep": ("mixtral-8x7b", {}, "prefill", {"moe_mode": "ep"}),
    "kvh": ("llama3.2-3b", {"n_kv_heads": 1}, "train", {}),
    "adafactor": ("smollm-360m", {"optimizer": "adafactor"}, "train", {}),
}
GSPMD_B, GSPMD_S, GSPMD_DECODE_STEPS = 4, 32, 4


def gspmd_cfg(case: str):
    arch, edit, _, _ = GSPMD_CASES[case]
    return dataclasses.replace(ARCHS[arch].reduced(), **DP_CFG, **edit)


def gspmd_plan(case: str):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.plan import plan_for
    _, _, phase, edit = GSPMD_CASES[case]
    shape = ShapeConfig(phase, GSPMD_S, GSPMD_B, phase)
    return shape, plan_for(gspmd_cfg(case), shape, tp_size=2,
                           hbm_budget=16e9).with_(**edit)


def gspmd(rank: int, world: int, data: str) -> dict:
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding
    from repro_torch.launch import specs
    inp = np.load(os.path.join(data, "inputs.npz"))
    mesh = lmesh.make_mesh((2, world // 2), ("data", "model"), device="cpu")
    out = {}
    for case, (_, _, phase, _) in GSPMD_CASES.items():
        cfg = gspmd_cfg(case)
        shape, plan = gspmd_plan(case)
        params = _unflatten(dict(np.load(os.path.join(
            data, f"params.{case}.npz"))))
        step_fn, _, in_sh, out_sh = specs.phase_cell(cfg, shape, mesh, plan)
        run = specs.sharded(step_fn, mesh, plan, in_sh, out_sh)
        tokens = torch.from_numpy(inp[f"{case}_tokens"])
        if phase == "train":
            optimizer = opt.get_optimizer(cfg.optimizer)
            if case == "train":
                # built straight into its shards, as a user on many ranks
                # builds it, then loaded with the reference's values
                model = transformer.init_params(cfg, device="cpu", mesh=mesh,
                                                plan=plan)
                built_sharded = all(sharding.is_dtensor(p)
                                    for p in model.parameters())
                want = convert.params_from_reference(cfg, params)
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        p.to_local().copy_(sharding.distribute_tensor_as(
                            want[n], mesh, p.placements).to_local())
                st = specs.shard_args(steps.TrainState(
                    model, optimizer.init(dict(model.named_parameters())),
                    0), in_sh[0], mesh)
                out[f"{case}_built_sharded"] = int(built_sharded and all(
                    sharding.is_dtensor(t) for t in st.opt_state["m"].values()
                ))
            else:
                st = specs.shard_args(_state(cfg, params, optimizer),
                                      in_sh[0], mesh)
            batch = {"tokens": tokens,
                     "labels": torch.from_numpy(inp[f"{case}_labels"])}
            # the gradients of the first step, pinned as the step pins them
            model = st.params
            named = dict(model.named_parameters())
            with sharding.use_sharding(mesh, plan), implicit_replication():
                loss, _ = transformer.loss_fn(
                    model, cfg, specs.shard_args(batch, in_sh[1], mesh))
                grads = dict(zip(named, torch.autograd.grad(
                    loss, list(named.values()))))
                raw = [type(p).__name__ for g in grads.values()
                       for p in g.placements]
                grads = sharding.constrain_like_params(
                    grads, transformer.param_axes(cfg))
                pinned = [type(p).__name__ for g in grads.values()
                          for p in g.placements]
            for n, g in grads.items():
                out[f"{case}_grad/{n}"] = g.full_tensor().numpy()
            out[f"{case}_raw_partial"] = int("Partial" in raw)
            out[f"{case}_pinned_partial"] = int("Partial" in pinned)
            losses, norms = [], []
            for i in range(2):
                with extract.count_collectives() as coll:
                    st, m = run(st, batch)
                losses.append(float(m["loss"].to_local()))
                norms.append(float(m["grad_norm"].to_local()))
            out[f"{case}_loss"] = np.array(losses)
            out[f"{case}_grad_norm"] = np.array(norms)
            out[f"{case}_bytes"] = json.dumps(coll)
            out[f"{case}_steps"] = st.step
            out[f"{case}_param_placements"] = json.dumps(sorted({
                str(p.placements) for p in st.params.parameters()}))
        elif phase == "prefill":
            model = specs.shard_args(_model(cfg, params), in_sh[0], mesh)
            with extract.count_collectives() as coll:
                logits = run(model, {"tokens": tokens})
            out[f"{case}_logits"] = logits.full_tensor().numpy()
            out[f"{case}_bytes"] = json.dumps(coll)
        else:
            model = specs.shard_args(_model(cfg, params), in_sh[0], mesh)
            state = specs.shard_args(transformer.init_decode_state(
                cfg, GSPMD_B, GSPMD_S, device="cpu"), in_sh[1], mesh)
            # the logits of each decode step, from the given tokens
            feed = torch.from_numpy(inp[f"{case}_feed"])
            logits = []
            with sharding.use_sharding(mesh, plan), implicit_replication(), \
                    torch.no_grad():
                for i in range(GSPMD_DECODE_STEPS):
                    tok = specs.shard_args(feed[:, i:i + 1], in_sh[2], mesh)
                    lg, state = transformer.decode_step(model, cfg, state,
                                                        tok)
                    logits.append(lg.full_tensor().numpy())
            out[f"{case}_logits"] = np.stack(logits)
            # sampled tokens through the sharded serve step
            state = specs.shard_args(transformer.init_decode_state(
                cfg, GSPMD_B, GSPMD_S, device="cpu"), in_sh[1], mesh)
            gen = torch.Generator().manual_seed(5)
            tok, toks = feed[:, :1], []
            for i in range(GSPMD_DECODE_STEPS):
                nxt, state = run(model, state, tok, gen)
                toks.append(nxt.numpy())
                tok = nxt[:, None]
            out[f"{case}_tokens"] = np.stack(toks)
    return out


def _unflatten(flat: dict) -> dict:
    """``a/b/c`` keys back into nested dicts."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def main(task: str, rank: int, world: int, data: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(data, f"store.{task}"),
                                     world),
        rank=rank, world_size=world)
    try:
        out = {"collectives": collectives, "resume": resume,
               "gspmd": gspmd}[task](rank, world, data)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(data, f"{task}.{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
