"""Count the aten ops the dry run dispatches in one rank's train step of
jamba-1.5-large-398b ``train_4k``, cut to one superblock and one
microbatch, on the production mesh (16 x 16, one pod) at each
``--seq-len`` (the shape's global batch kept): ``launch.dryrun.dryrun_rank``
on rank 0 with the sweep's runner settings.  A meta trace's host time
follows this count (about 0.1-0.5 ms an op), so it says what a full run
of the sweep costs.

    PYTHONPATH=src python scripts/count_dryrun_ops.py --seq-len 512,1024
    # another tree of the port (a parent commit unpacked by git archive)
    python scripts/count_dryrun_ops.py --src build/parent/src ...

Prints one JSON line per sequence length: the op count and the trace's
wall seconds.  Touches no device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ARCH, SHAPE = "jamba-1.5-large-398b", "train_4k"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq-len", default="512,1024")
    ap.add_argument("--src", default=str(pathlib.Path(__file__)
                                         .resolve().parents[1] / "src"))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs.base import get_config
    from repro_torch.dist import api as A
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import fake_mesh, make_production_mesh

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, fn, types, a=(), kw=None):
            Count.n += 1
            return fn(*a, **(kw or {}))

    cfg = get_config(ARCH)
    cfg = cfg.replace(n_layers=len(cfg.pattern))          # one superblock
    for seq in (int(s) for s in args.seq_len.split(",")):
        shape = dataclasses.replace(D.INPUT_SHAPES[SHAPE], seq_len=seq)
        with fake_mesh(make_production_mesh().dims, rank=0) as mesh:
            # run_dryrun's runner for jamba: the pipeline, its 16 experts
            # split over the expert-parallel axis
            runner = A.build_runner(cfg, D.default_mode(ARCH), mesh,
                                    n_microbatches=1, device="meta",
                                    expert_parallel=True)
            Count.n = 0
            t0 = time.perf_counter()
            with Count():
                D.dryrun_rank(runner, shape, opt_dtype=D.opt_dtype_for(cfg))
            print(json.dumps(dict(arch=ARCH, shape=SHAPE, seq_len=seq,
                                  src=args.src, aten_ops=Count.n,
                                  seconds=round(time.perf_counter() - t0,
                                                1))), flush=True)


if __name__ == "__main__":
    main()
