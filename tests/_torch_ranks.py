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
        out = {"collectives": collectives, "resume": resume}[task](
            rank, world, data)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(data, f"{task}.{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
