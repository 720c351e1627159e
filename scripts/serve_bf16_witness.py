"""Read bf16 serving across ranks against f32: is its difference rounding?

    python scripts/serve_bf16_witness.py [--out FILE]          # on the card
    python scripts/serve_bf16_witness.py --device cpu --reduced   # rehearse

``chip_smoke.py``'s ``serve_multi`` part serves in f32, where its gates can
sit far below a bf16 rounding; bf16 across ranks is not gated there.  This
script is the witness for that choice.  For every serve_multi part (flash-
decoding A and B on (2, 1), the LAYER and SEMANTIC arms on (1, 2)) it makes
three runs fed the same tokens: one process in f32 (the reference, whose
greedy tokens every run is fed), one process in bf16, and two gloo ranks of
this script in bf16 on the one device, as the ``multi`` world runs them.
Each bf16 run's logits are read against the f32 run's, call by call: the
largest |difference| over the largest |logit|, and whether the greedy
tokens are equal.  If the ranks read as the one process does, the bf16
difference across ranks is rounding, not a fault of the ranks' path.  It
prints one JSON object and gates nothing.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402

WORLD = 2
TIMEOUT_S = 900


def _reading(want: torch.Tensor):
    """A call-by-call reading of logits against ``want`` [calls, B, vocab]
    (f32, host): worst relative difference and greedy tokens equal."""
    st = dict(rel=[], same=[])

    def check(i, logits):
        w = want[i].to(logits.device)
        got = logits.float()
        top = w.abs().max().clamp_min(1e-30)
        st["rel"].append(float((got - w).abs().max() / top))
        st["same"].append(bool((got.argmax(-1) == w.argmax(-1)).all()))
    return st, check


def one_process(dev, workdir: pathlib.Path, reduced: bool, dtype: str):
    """Each part's runner on a 1 x 1 mesh in ``dtype``, fed the f32 run's
    tokens, read against its logits."""
    from repro_torch.dist import api as A
    parts, fd, steps, inp = CS._serve_parts(reduced, dtype)
    out = {}
    for part, cfg, mode, _, _, b, cache_len in parts:
        CS._free()
        ref = torch.load(workdir / f"serve_{part}.pt")
        runner = A.build_runner(cfg, mode, device=dev)
        params = runner.init(seed=0)
        cache = CS._seeded_cache(cfg, b, cache_len, fd["B"][3], dev) \
            if part == "B" else runner.init_cache(b, cache_len)
        st, check = _reading(ref["logits"])
        CS._serve_calls(runner, params, cache, inp, part, fd=fd,
                        arm_steps=steps, feed=ref["fed"].numpy(),
                        on_logits=check)
        out[part] = dict(worst_rel=max(st["rel"]),
                         median_rel=float(np.median(st["rel"])),
                         tokens_same=sum(st["same"]), calls=len(st["same"]))
        del runner, params, cache, ref
    CS._free()
    return out


def rank_main(rank: int, workdir: pathlib.Path, device: str,
              reduced: bool) -> int:
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world = dict(backend="gloo", device=dev, rank=rank, world_size=WORLD,
                 timeout_s=120,
                 store=dist.FileStore(str(workdir / "store"), WORLD))
    runs = CS.serve_multi_worker(rank, workdir, dev, reduced, world,
                                 dtype="bfloat16")
    dist.barrier()
    dist.destroy_process_group()
    (workdir / f"rank{rank}.json").write_text(json.dumps(runs))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args.rank, pathlib.Path(args.dir), args.device,
                         args.reduced)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    workdir = pathlib.Path(tempfile.mkdtemp(prefix="bf16_witness_"))
    CS.serve_multi_refs(dev, workdir, args.reduced)        # f32, one process
    one = one_process(dev, workdir, args.reduced, "bfloat16")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    child = "cuda:0" if dev.type == "cuda" else "cpu"
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
           "--dir", str(workdir), "--device", child] + \
        (["--reduced"] if args.reduced else [])
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(WORLD)]
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        print(f"serve_bf16_witness: ranks exited with {rcs}", file=sys.stderr)
        return 1
    rank0 = json.loads((workdir / "rank0.json").read_text())
    ranks = {part: dict(worst_rel=r["worst_rel"],
                        tokens_same=r["tokens_same"], calls=r["calls"])
             for part, r in rank0.items()}
    out = dict(card=CS.gpu_name_and_limit() if dev.type == "cuda" else "cpu",
               reduced=args.reduced, against="f32 one process",
               bf16_one_process=one, bf16_ranks=ranks,
               wall_s=time.perf_counter() - t0)
    text = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
