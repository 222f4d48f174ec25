"""Training launcher: --arch <id> on one device, or over a (data, model)
mesh of the ranks ``torchrun`` starts.

The port of the reference package's ``launch/train.py``, the dense, moe,
ssm, hybrid and vlm families: the arch config -> the local mesh ->
parameters and AdamW state laid out by ``cell_shardings`` -> the HiFrames
token pipeline -> the fault-tolerant driver (asynchronous checkpoints,
preemption, straggler statistics).  On the card by default; on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --reduced --device cpu --steps 4 --batch 2 --seq 32

and data-parallel over two ranks (gloo on the CPU; on cards NCCL when each
rank has its own, gloo when they share one, ``launch/mesh.py``):

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.train --arch qwen3-0.6b --reduced --device cpu

There every rank starts from rank 0's weights (broadcast), builds the same
global batches and trains on its rows of each (``steps.make_train_step``);
the AdamW moments are ZeRO-1 blocks (``OptConfig.zero1``); rank 0 writes
the checkpoints.  Without ``torchrun`` the world is one process.

``--model-axis M`` lays the ranks out as (data world/M, model M)
(``make_local_mesh``; a world M does not divide raises ``ValueError``):
the dense and moe families train tensor- and expert-parallel on "model",
each rank holding its blocks of the parameters and of the moments,
data-parallel over "data":

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch qwen3-0.6b --reduced \
        --device cpu --model-axis 2

``--production-mesh`` asks for the reference's 16 x 16 mesh
(``make_production_mesh``, which raises unless the world holds 256
ranks).  ``--moe-impl`` sets the config's ``moe_impl`` as the reference
does: "ep" is ``moe._moe_block_ep`` on a model axis and the gspmd block at
model axis 1.  The ssm, hybrid and vlm families on a model axis raise
``NotImplementedError`` (ROADMAP.md §1 item 11.7c).

``--resume`` continues from the latest checkpoint in ``--ckpt-dir`` (saved
at any mesh; the blocks are gathered and rank 0 writes whole leaves).  The
vlm family trains on the reference's stand-in batches: zero bf16
``inputs_embeds`` and positions counting up on all three M-RoPE streams,
no tokens.  The encdec family exits as the reference's does (a
whisper-specific driver).  ``run`` is the body, for callers with their own
corpus.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from .. import configs
from ..core.lower import ExecConfig
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..data.synth import token_corpus
from ..configs import ShapeSpec
from ..models import lm, sharding
from ..models.config import ModelConfig
from ..optim import OptConfig, adamw
from ..runtime import FTConfig, TrainDriver
from . import mesh as M
from . import steps as S


def _require_trainable(cfg: ModelConfig) -> None:
    lm.require_ported(cfg)
    if cfg.family == "encdec":
        raise SystemExit("use whisper-specific driver for encdec training demo")


def run(cfg: ModelConfig, ocfg: OptConfig, corpus: dict, *, steps: int,
        batch: int, seq: int, micro: int = 1, ckpt_dir: str,
        resume: bool = False, device="cuda", ckpt_every: int = 50,
        log_every: int = 5, mesh=None) -> dict:
    """Train ``cfg`` for ``steps`` steps on batches of ``batch`` x ``seq``
    tokens from ``corpus`` (``synth.token_corpus``'s table) on ``device``,
    from random weights (seed 0), checkpointing every ``ckpt_every`` steps
    with the arch's name as metadata.  On a ``mesh`` (``make_local_mesh``
    over the initialised group) the steps are data-parallel over its data
    ranks (``batch`` is the global batch) and tensor- and expert-parallel
    over its model ranks, each holding its blocks of rank 0's weights.

    Returns the driver's result ({"steps", "losses", "stragglers",
    "mean_step_s"}) with "driver" (the TrainDriver: its state, step times
    and saver records), "pipeline" (the closed TokenPipeline: its plan's
    outputs), "pipeline_s" (its construction's wall: ingest, the relational
    stages and their host copies), "resumed_at" (the step resumed from,
    or None) and "cell" (on a mesh, ``cell_shardings``' specs: "params",
    "opt_sh"; else None)."""
    _require_trainable(cfg)
    lm.require_servable(cfg, mesh)
    dev = lm.device_of(device)
    exec_cfg = ExecConfig(device=dev.type)
    if mesh is not None and M.mesh_chip_count(mesh) == 1:
        mesh = None
    cell = None if mesh is None else S.cell_shardings(
        cfg, ShapeSpec("cli", "train", seq, batch), mesh, ocfg)
    model = lm.init_params(cfg, seed=0, device=dev)
    params = model.tree()
    if mesh is not None:
        # every rank starts from rank 0's draw, as DDP does, and keeps its
        # blocks of it
        for _, t in lm.leaves(params):
            mesh.world.broadcast(t.data)
        if mesh.shape.get("model", 1) > 1:
            model = lm.LM(cfg, sharding.shard_params(params, mesh))
            params = model.tree()
    state = {"params": params, "opt": adamw.init_state(
        params, ocfg, mesh=mesh, specs=cell and cell["params"])}
    step_fn = S.make_train_step(cfg, ocfg, n_micro=micro, mesh=mesh)
    t0 = time.perf_counter()
    pipe = TokenPipeline(corpus, PipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), exec_cfg)
    pipeline_s = time.perf_counter() - t0
    try:
        driver = TrainDriver(FTConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every),
                             state, step_fn, metadata={"arch": cfg.name},
                             mesh=mesh, shardings=cell and {"params": cell["params"],
                                                            "opt": cell["opt_sh"]})
        resumed = None
        if resume and driver.maybe_resume():
            resumed = driver.step
            print(f"resumed at step {driver.step}")

        def batches():
            for b in pipe:
                out = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                if cfg.family == "vlm":
                    n, sq = out["tokens"].shape
                    out["inputs_embeds"] = torch.zeros(
                        (n, sq, cfg.d_model), dtype=torch.bfloat16, device=dev)
                    out["positions"] = torch.arange(
                        sq, dtype=torch.int32, device=dev).expand(3, n, sq)
                    out["tokens"] = None
                yield out

        res = driver.run(batches(), num_steps=steps, log_every=log_every)
    finally:
        pipe.close()
    return {**res, "driver": driver, "pipeline": pipe, "pipeline_s": pipeline_s,
            "resumed_at": resumed, "cell": cell}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--moe-impl", default=None, choices=["gspmd", "ep"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = configs.get_reduced(args.arch) if args.reduced \
        else configs.get_config(args.arch)
    if args.moe_impl:
        cfg = cfg.replace(moe_impl=args.moe_impl)
    _require_trainable(cfg)
    if args.model_axis > 1 or args.production_mesh:
        lm.require_servable(cfg, M.Mesh({"data": 1, "model": 2}))
    started = not torch.distributed.is_initialized()
    M.init_distributed(args.device)
    try:
        mesh = (M.make_production_mesh() if args.production_mesh
                else M.make_local_mesh(model_axis=args.model_axis))
    except BaseException:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        raise
    print(f"device {args.device}; mesh {dict(mesh.shape)} "
          f"({mesh.backend or 'one process'}); model {cfg.name} "
          f"{cfg.param_count()/1e6:.1f}M params")
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    try:
        res = run(cfg, ocfg, token_corpus(2_000, cfg.vocab), steps=args.steps,
                  batch=args.batch, seq=args.seq, micro=args.micro,
                  ckpt_dir=args.ckpt_dir, resume=args.resume, device=args.device,
                  mesh=mesh)
    finally:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if res["losses"]:
        print(f"done: {res['steps']} steps, loss {res['losses'][0]:.3f} -> "
              f"{res['losses'][-1]:.3f}, {res['mean_step_s']*1e3:.0f} ms/step")
    else:
        print(f"done: at step {res['steps']}, no step to run")
    return res


if __name__ == "__main__":
    main()
