"""Training launcher of the port (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --mode fsdp --steps 6 --seq-len 2048 --batch 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --mode pipeline --schedule 1f1b --n-microbatches 2 --steps 4 \
        --seq-len 2048 --batch 2
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --arch stablelm-1.6b --reduced \
        --mesh 2,2 --mode fsdp --device cpu --backend gloo --steps 3 \
        --seq-len 64 --batch 4

With ``--mesh D,M`` other than 1,1 the launcher runs as one of D x M ranks
started by ``torch.distributed.run`` (which sets the rank and world in the
environment): it lays a ``(data, model)`` mesh over them on ``--backend``
(gloo, or nccl with a card per rank), every rank draws the same synthetic
global batch and takes its rows, and rank 0 alone prints and writes the
checkpoint.  On the card each rank uses card ``LOCAL_RANK`` modulo the
card count (ranks beyond it share cards, which gloo allows and nccl
refuses).

Runs on the card unless ``--device cpu``; the config is cast to float32, the
step runs with remat at a constant ``--lr`` (the JAX launcher builds a cosine
schedule it never uses, and so does this one), and the data is the
synthetic pipeline with seed 0.  At ``--seq-len`` >= 2048 every attention
layer goes through the flash kernel.  ``main(argv)`` returns the losses.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import save
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import batches_for
from repro_torch.dist import api as A
from repro_torch.launch.mesh import init_mesh
from repro_torch.optim.adamw import adamw_init, cosine_schedule


def main(argv=None, *, on_step=None, on_setup=None):
    """Train and return the per-step losses.  ``on_step(step, loss,
    seconds)``, if given, is called after each step with its wall time
    (the loss is read back, so the step has finished on the device);
    ``on_setup(runner, params, opt)`` once the parameters and the AdamW
    state are made, before the first step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="fsdp",
                    choices=["fsdp", "semantic", "pipeline"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="1,1",
                    help="data,model (more than one rank: run under "
                         "torch.distributed.run)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="process-group backend of a mesh of several ranks")
    ap.add_argument("--schedule", default="gspmd",
                    choices=["gspmd", "gpipe", "1f1b"],
                    help="pipeline mode: gspmd (the microbatched loss) or "
                         "the explicit gpipe / 1f1b stage graph")
    ap.add_argument("--n-microbatches", type=int, default=0,
                    help="pipeline microbatch count (0: mesh 'model' size)")
    ap.add_argument("--memory-budget", type=int, default=0,
                    help="gpipe: cap on saved in-flight microbatches "
                         "(0: unbounded)")
    ap.add_argument("--expert-parallel", action="store_true",
                    help="MoE with an explicit schedule: experts split over "
                         "'model', tokens exchanged by all-to-alls")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override d_model (with --reduced)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
        if args.d_model:
            cfg = cfg.replace(d_model=args.d_model)
    cfg = cfg.replace(dtype="float32")

    dims = tuple(int(x) for x in args.mesh.split(","))
    mesh, device = dims, args.device
    if math.prod(dims) > 1:
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            device = f"cuda:{local % torch.cuda.device_count()}"
            torch.cuda.set_device(device)
        mesh = init_mesh(dims, backend=args.backend, device=device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)

    runner = A.build_runner(
        cfg, args.mode, mesh,
        n_microbatches=args.n_microbatches or None,
        schedule=args.schedule if args.mode == "pipeline" else "gspmd",
        memory_budget=args.memory_budget or None,
        expert_parallel=args.expert_parallel, device=device)
    rcfg = runner.cfg
    if args.mode == "pipeline":
        say("schedule:", runner.schedule_stats(args.batch, args.seq_len),
              flush=True)
    params = runner.init(seed=0)
    opt = adamw_init(params)
    if on_setup is not None:
        on_setup(runner, params, opt)

    # built and never used, as in the JAX launcher: the step runs at --lr
    sched = cosine_schedule(  # noqa: F841
        args.lr, warmup=max(args.steps // 20, 1), total=args.steps)
    step_fn = A.make_train_step(runner, lr=args.lr, remat=True)

    data = batches_for(rcfg, seq_len=args.seq_len, global_batch=args.batch)
    dev = runner.device
    losses = []
    t0 = time.time()
    for step in range(args.steps):
        ts = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        params, opt, loss = step_fn(params, opt, batch)
        losses.append(float(loss))
        if on_step is not None:
            on_step(step, losses[-1], time.perf_counter() - ts)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"({dt / (step + 1):.2f}s/step)", flush=True)
    if args.ckpt:
        save(f"{args.ckpt}/step_{args.steps}.npz", params, step=args.steps,
             specs=runner.specs, mesh=runner.mesh)
        say(f"checkpoint -> {args.ckpt}/step_{args.steps}.npz")
    say(f"first-10 mean {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean {np.mean(losses[-10:]):.4f}")
    return losses


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
