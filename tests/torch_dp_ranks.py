"""One rank of the port's data- and model-parallel checks (no jax, no
reference).

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        OMP_NUM_THREADS=1 PYTHONPATH=src python tests/torch_dp_ranks.py DIR [tp4]

as ``torchrun`` would start it.  Reads ``DIR/inputs.pt`` (numpy inputs
written by ``tests/test_torch_sharding.py``), joins the group through
``launch/mesh.py::init_distributed`` on the CPU, runs every check's port
side at P = world, and writes ``DIR/rank<r>.pt``:

- "psum": ``compressed_psum`` and ``tree_compressed_psum`` of this rank's
  gradients and errors;
- "cases": for each train case, the global losses of its steps, the
  gathered state after them (rank 0), each ZeRO-1 block's shape beside the
  one ``zero1_spec`` gives and whether it is the gathered state's block,
  the collective counts of its first step, the routings that overflowed
  an expert's capacity (moe);
- "ckpt": a save at P = world and a restore at P = world into a fresh
  state (bitwise against the live blocks), the first step's loss from
  each; the step every rank stopped at when one rank was preempted;
- "pipeline": the token pipeline's plan and first batches at P = world;
- "launcher": ``launch.train.main``'s losses;
- "serve": on a (data 1, model world) mesh, for each serving case the
  prefill and decode steps of ``launch/steps.py`` (tensor- and
  expert-parallel, the cache sharded along S): the logits of each step
  gathered over the vocabulary, the greedy picks, the collectives of the
  first decode step, the cache gathered after the last step, and the last
  logits of the same prompt prefilled in two chunks;
- "tp_cases": on the same (data 1, model world) mesh, each model-axis
  train case (tensor- or expert-parallel through ``models/tp.py``): the
  gradients of its first batch and the state after its steps gathered
  over both axes (rank 0), the global losses, each moment's block against
  ``zero1_spec`` and the first step's collectives;
- "tp_ckpt": a save on that mesh of one case's state, restored there into a
  fresh state (bitwise against the live blocks);
- "tp_launcher": ``launch.train.main(... --model-axis world)``'s losses,
  the dense family's and the moe family's with ``--moe-impl ep``.

With ``tp4`` (four ranks) it runs the (data 2, model 2) checks of
tests/test_torch_tp_train.py instead (``tp4_main``): the train step with
ZeRO-1 for each micro-batch count, the blocks, and a save and restore at
(2, 2).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.core.lower import ExecConfig
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.launch import mesh as M
from repro_torch.launch import steps, train
from repro_torch.models import lm, moe, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax, to_numpy
from repro_torch.optim import OptConfig, adamw, compression
from repro_torch.runtime import FTConfig, TrainDriver


def _t(tree):
    return lm.tree_map(torch.from_numpy, tree)


def _numpy(tree):
    return lm.tree_map(lambda t: t.detach().numpy().copy(), tree)


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def train_case(case: dict, mesh, overflow: list) -> dict:
    cfg = ModelConfig(**case["cfg"])
    ocfg = OptConfig(**case["ocfg"])
    model = params_from_jax(cfg, case["params"], device="cpu")
    params = model.tree()
    state = {"params": params, "opt": adamw.init_state(params, ocfg, mesh=mesh)}
    step = steps.make_train_step(cfg, ocfg, n_micro=case["n_micro"], mesh=mesh)
    losses, counts = [], None
    del overflow[:]
    for i, b in enumerate(case["batches"]):
        mesh.reset_counts()
        state, loss = step(state, _batch(b))
        losses.append(float(loss))
        if i == 0:
            counts = {k: dict(v) for k, v in mesh.counts.items()}
    opt_sh = adamw.state_shardings(
        mesh, sharding.param_shardings(cfg, mesh, params), params, ocfg)
    whole = sharding.gather_tree(state, {"opt": opt_sh}, mesh)
    blocks = {}
    for path, t in lm.leaves(state["opt"]["m"]):
        sp = sharding.spec_at(opt_sh["m"], path)
        want = sharding.shard(_at(whole["opt"]["m"], path), sp, mesh)
        blocks["/".join(path)] = {
            "shape": tuple(t.shape),
            "spec": sp,
            "zero1_shape": sharding.local_shape(tuple(_at(params, path).shape), sp, mesh),
            "is_block": bool(torch.equal(t, want))}
    return {"losses": losses, "counts": counts, "blocks": blocks,
            "overflow": list(overflow),
            "state": to_numpy(whole) if mesh.rank == 0 else None,
            "state_obj": (state, opt_sh, cfg, ocfg, step)}


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def ckpt_checks(live: tuple, batch: dict, ckpt_dir: str, mesh) -> dict:
    """Save the live state at P = world, restore it at P = world into a
    fresh state, and take one step from each."""
    state, opt_sh, cfg, ocfg, step = live
    sh = {"opt": opt_sh}
    drv = TrainDriver(FTConfig(ckpt_dir=ckpt_dir), state, step, mesh=mesh,
                      shardings=sh, metadata={"arch": cfg.name})
    drv.step = int(state["opt"]["step"])
    drv.save()
    drv.saver.wait()
    torch.distributed.barrier()
    fresh_model = lm.init_params(cfg, seed=9, device="cpu")
    fresh = {"params": fresh_model.tree(),
             "opt": adamw.init_state(fresh_model.tree(), ocfg, mesh=mesh)}
    again = TrainDriver(FTConfig(ckpt_dir=ckpt_dir), fresh, step, mesh=mesh,
                        shardings=sh)
    assert again.maybe_resume()
    same = all(torch.equal(a, b) for (_, a), (_, b)
               in zip(lm.leaves(fresh), lm.leaves(state)))
    _, live_loss = step(state, _batch(batch))
    _, restored_loss = step(fresh, _batch(batch))
    return {"step": again.step, "bitwise": same, "live_loss": float(live_loss),
            "restored_loss": float(restored_loss)}


def preemption(case: dict, ckpt_dir: str, mesh) -> dict:
    """Rank 1 alone is preempted after its second step: every rank stops at
    the same step and the one checkpoint is that step's."""
    cfg = ModelConfig(**case["cfg"])
    ocfg = OptConfig(**case["ocfg"])
    model = params_from_jax(cfg, case["params"], device="cpu")
    state = {"params": model.tree(),
             "opt": adamw.init_state(model.tree(), ocfg, mesh=mesh)}
    opt_sh = adamw.state_shardings(
        mesh, sharding.param_shardings(cfg, mesh, state["params"]),
        state["params"], ocfg)
    drv = TrainDriver(FTConfig(ckpt_dir=ckpt_dir, ckpt_every=100), state,
                      steps.make_train_step(cfg, ocfg, mesh=mesh), mesh=mesh,
                      shardings={"opt": opt_sh})

    def batches():
        for i in range(10):
            if i == 2 and mesh.rank == 1:
                drv._preempted = True
            yield _batch(case["batches"][0])

    res = drv.run(batches(), num_steps=10, log_fn=lambda *a: None)
    return {"steps": res["steps"], "latest": latest_step(ckpt_dir)}


def pipeline(inp: dict) -> dict:
    pipe = TokenPipeline(inp["corpus"], PipelineConfig(**inp["pcfg"]),
                         ExecConfig(device="cpu"))
    try:
        batches = [next(pipe) for _ in range(2)]
    finally:
        pipe.close()
    return {"doc_len": pipe.doc_len, "doc_seed": pipe.doc_seed,
            "doc_offset": pipe.doc_offset, "total_tokens": pipe.total_tokens,
            "bucket_stats": {k: np.asarray(v) for k, v in pipe.bucket_stats.items()},
            "batches": batches}


def tp_train_case(case: dict, mesh, ckpt_dir: str | None = None) -> dict:
    """One model-axis train case (module docstring): this rank's blocks of
    the case's weights through ``make_train_step(mesh=)``; with
    ``ckpt_dir`` also a save of the state after the steps and a restore
    into a fresh state."""
    cfg = ModelConfig(**case["cfg"])
    ocfg = OptConfig(**case["ocfg"])
    params = params_from_jax(cfg, case["params"], device="cpu", mesh=mesh).tree()
    pspecs = sharding.param_shardings(cfg, mesh, steps.model_param_specs(cfg))
    opt_sh = adamw.state_shardings(mesh, pspecs, steps.model_param_specs(cfg), ocfg)
    layout = {"params": pspecs, "opt": opt_sh}
    out = {}
    if case["n_micro"] == 1:
        _, g = steps.value_and_grad(steps.make_loss_fn(cfg, mesh=mesh), params,
                                    _batch(case["batches"][0]))
        whole = sharding.gather_tree(g, pspecs, mesh)
        out["grads"] = _numpy(whole) if mesh.rank == 0 else None
    state = {"params": params,
             "opt": adamw.init_state(params, ocfg, mesh=mesh, specs=pspecs)}
    step = steps.make_train_step(cfg, ocfg, n_micro=case["n_micro"], mesh=mesh)
    losses = []
    for i, b in enumerate(case["batches"]):
        mesh.reset_counts()
        state, loss = step(state, _batch(b))
        losses.append(float(loss))
        if i == 0:
            out["counts"] = {k: dict(v) for k, v in mesh.counts.items()}
    whole = sharding.gather_tree(state, layout, mesh)
    blocks = {}
    for path, t in lm.leaves(state["opt"]["m"]):
        sp = sharding.spec_at(opt_sh["m"], path)
        shape = sharding.shape_of(_at(steps.model_param_specs(cfg), path))
        blocks["/".join(path)] = {
            "shape": tuple(t.shape), "spec": sp,
            "zero1_shape": sharding.local_shape(shape, sp, mesh),
            "is_block": bool(torch.equal(t, sharding.shard(_at(whole["opt"]["m"], path),
                                                           sp, mesh)))}
    out |= {"losses": losses, "blocks": blocks,
            "state": to_numpy(whole) if mesh.rank == 0 else None}
    if ckpt_dir is not None:
        drv = TrainDriver(FTConfig(ckpt_dir=ckpt_dir), state, step, mesh=mesh,
                          shardings=layout, metadata={"arch": cfg.name})
        drv.step = int(state["opt"]["step"])
        drv.save()
        drv.saver.wait()
        torch.distributed.barrier()
        fresh = lm.init_params(cfg, seed=9, device="cpu", mesh=mesh).tree()
        fresh = {"params": fresh,
                 "opt": adamw.init_state(fresh, ocfg, mesh=mesh, specs=pspecs)}
        again = TrainDriver(FTConfig(ckpt_dir=ckpt_dir), fresh, step, mesh=mesh,
                            shardings=layout)
        assert again.maybe_resume()
        out["ckpt"] = {"step": again.step, "bitwise": all(
            torch.equal(a, b) for (_, a), (_, b) in zip(lm.leaves(fresh),
                                                          lm.leaves(state)))}
    return out


def tp4_main(out_dir: str) -> None:
    """The (data 2, model 2) checks (module docstring)."""
    world = M.init_distributed("cpu")
    mesh = M.make_local_mesh(model_axis=2)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    out = {"world": world, "backend": mesh.backend, "mesh": dict(mesh.shape),
           "coords": dict(mesh.coords), "cases": {}}
    for n in inp["micro"]:
        case = {"cfg": inp["cfg"], "ocfg": inp["ocfg"], "n_micro": n,
                "params": inp["params"], "batches": inp["batches"]}
        res = tp_train_case(case, mesh, inp["ckpt_dir"] if n == 1 else None)
        if n == 1:
            out["ckpt"] = res.pop("ckpt")
        out["cases"][n] = res
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


def serve_case(case: dict, mesh) -> dict:
    """One serving case on the model mesh (module docstring)."""
    cfg = ModelConfig(**case["cfg"])
    model = params_from_jax(cfg, case["params"], device="cpu", mesh=mesh)
    tp = mesh.groups["model"]

    def whole(logits):
        return (tp.all_gather(logits, dim=-1) if logits.shape[-1] != cfg.vocab
                else logits).numpy().copy()

    prompt = torch.from_numpy(case["prompt"])
    logits, caches = steps.make_prefill_step(cfg, case["max_seq"], mesh=mesh)(
        model, {"tokens": prompt})
    out = {"logits": [whole(logits)], "picks": [lm.greedy(logits, cfg, mesh).numpy()]}
    decode = steps.make_decode_step(cfg, mesh=mesh)
    for i, tok in enumerate(case["decode_tokens"]):
        mesh.reset_counts()
        logits, caches = decode(model, torch.from_numpy(tok)[:, None], caches)
        if i == 0:
            out["counts"] = {k: dict(v) for k, v in mesh.counts.items()}
        out["logits"].append(whole(logits))
        out["picks"].append(lm.greedy(logits, cfg, mesh).numpy())
    specs = sharding.cache_shardings(
        mesh, lm.init_cache_specs(cfg, prompt.shape[0], case["max_seq"]))
    out["cache"] = {name: {k: sharding.gather(caches[name][k], specs[name][k],
                                              mesh).numpy()
                           for k in ("k", "v")} for name in lm.stacks(cfg)}
    out["block"] = tuple(caches["block"])
    # the prompt in two chunks: the second attends over the first's rows
    chunks = lm.init_cache(cfg, prompt.shape[0], case["max_seq"], "cpu", mesh=mesh)
    cut = case["chunk"]
    lm.forward(model, prompt[:, :cut], cfg, caches=chunks, mesh=mesh)
    last, _, _ = lm.forward(model, prompt[:, cut:], cfg, caches=chunks, mesh=mesh,
                            q_offset=cut)
    out["chunked_last"] = whole(last[:, -1])
    return out


def main(out_dir: str) -> None:
    world = M.init_distributed("cpu")
    mesh = M.make_local_mesh()
    rank = mesh.rank
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    out = {"world": world, "backend": mesh.backend, "mesh": dict(mesh.shape)}

    ps = inp["psum"]
    g_mean, new_err = compression.compressed_psum(
        torch.from_numpy(ps["g"][rank]), torch.from_numpy(ps["err"][rank]), mesh.dp)
    tg, te = compression.tree_compressed_psum(
        _t(ps["tree_g"][rank]), _t(ps["tree_err"][rank]), mesh.dp)
    out["psum"] = {"g_mean": g_mean.numpy(), "new_err": new_err.numpy(),
                   "tree_g": _numpy(tg), "tree_err": _numpy(te)}

    # every routing's largest expert count beside its capacity
    overflow: list = []
    route = moe.route

    def counted_route(p, xt, cfg, group=None):
        r = route(p, xt, cfg, group)
        if int(r.counts.max()) > r.C:
            overflow.append((int(r.counts.max()), r.C))
        return r
    moe.route = counted_route

    out["cases"] = {}
    live = None
    for case in inp["cases"]:
        res = train_case(case, mesh, overflow)
        obj = res.pop("state_obj")
        if case["name"] == inp["ckpt_case"]:
            live = obj
        out["cases"][case["name"]] = res
    moe.route = route

    ckpt_case = next(c for c in inp["cases"] if c["name"] == inp["ckpt_case"])
    out["ckpt"] = ckpt_checks(live, ckpt_case["batches"][0], inp["ckpt_dir"], mesh)
    out["preemption"] = preemption(ckpt_case, inp["preempt_dir"], mesh)
    out["pipeline"] = pipeline(inp["pipeline"])
    res = train.main(inp["launcher"])
    out["launcher"] = {"losses": res["losses"], "steps": res["steps"]}
    model_mesh = M.make_local_mesh(model_axis=world)
    out["serve_mesh"] = dict(model_mesh.shape)
    out["serve"] = {case["name"]: serve_case(case, model_mesh)
                    for case in inp["serve"]}
    tp = inp["tp"]
    out["tp_cases"] = {}
    for case in tp["cases"]:
        res = tp_train_case(case, model_mesh,
                            tp["ckpt_dir"] if case["name"] == tp["ckpt_case"] else None)
        if "ckpt" in res:
            out["tp_ckpt"] = res.pop("ckpt")
        out["tp_cases"][case["name"]] = res
    out["tp_launcher"] = {}
    for kind, argv in tp["launcher"].items():
        res = train.main(argv)
        out["tp_launcher"][kind] = {"losses": res["losses"], "steps": res["steps"]}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    (tp4_main if sys.argv[2:] == ["tp4"] else main)(sys.argv[1])
