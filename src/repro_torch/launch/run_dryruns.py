"""The port's dry-run sweep: every (arch x shape) on the
single-pod mesh AND the 2-pod mesh (``repro.launch.run_dryruns``).  Each
run is a subprocess of ``python -m repro_torch.launch.dryrun`` (a fresh
fake world); records land in ``experiments/dryrun_torch/*.json``.  Nothing
touches a device.

    PYTHONPATH=src python -m repro_torch.launch.run_dryruns [--skip-existing] \
        [--arch yi-34b] [--shape train_4k] [--pods 1,2] [--jobs 8]

``--jobs`` runs that many subprocesses at once (1, the reference's way, by
default); each run's ``trace_s`` is then taken beside the others'.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parents[3]
OUT = REPO / "experiments" / "dryrun_torch"

ARCHS = [
    "phi3.5-moe-42b-a6.6b", "yi-34b", "gemma2-27b", "qwen2-moe-a2.7b",
    "jamba-1.5-large-398b", "whisper-base", "stablelm-1.6b", "xlstm-125m",
    "internvl2-26b", "starcoder2-15b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
SKIP = {("whisper-base", "long_500k")}  # DESIGN.md §5


def tag_for(arch, shape, multi_pod, mode):
    return f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}__{mode}"


def default_mode(arch):
    return "fsdp" if arch == "whisper-base" else "pipeline"


def _run(arch, shape, pod, mode, mode_given, timeout):
    """One dry run in its own process: (tag, ok, seconds, output tail)."""
    tag = tag_for(arch, shape, pod == 2, mode)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape]
    if mode_given or mode != default_mode(arch):
        cmd += ["--mode", mode]
    if pod == 2:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    t0 = time.time()
    try:
        r = subprocess.run(cmd, cwd=REPO, timeout=timeout, env=env,
                           capture_output=True, text=True)
        ok, tail = r.returncode == 0, (r.stdout[-1500:], r.stderr[-3000:])
    except subprocess.TimeoutExpired:
        ok, tail = False, ("", f"timed out after {timeout} s")
    return tag, ok, time.time() - t0, tail


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--pods", default="1,2")
    ap.add_argument("--mode", default=None)
    ap.add_argument("--timeout", type=int, default=1800)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else SHAPES
    pods = [int(p) for p in args.pods.split(",")]

    todo = []
    for arch in archs:
        for shape in shapes:
            if (arch, shape) in SKIP:
                print(f"SKIP {arch} x {shape} (DESIGN.md §5)", flush=True)
                continue
            for pod in pods:
                mode = args.mode or default_mode(arch)
                tag = tag_for(arch, shape, pod == 2, mode)
                if args.skip_existing and (OUT / f"{tag}.json").exists():
                    print(f"skip existing {tag}", flush=True)
                    continue
                todo.append((arch, shape, pod, mode))

    results = []
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        runs = [pool.submit(_run, *t, args.mode is not None, args.timeout)
                for t in todo]
        for fut in runs:
            tag, ok, dt, (out, err) = fut.result()
            print(f"{'OK  ' if ok else 'FAIL'} {tag}  ({dt:.0f}s)", flush=True)
            if not ok:
                print(out, flush=True)
                print(err, flush=True)
            results.append((tag, ok))
    n_ok = sum(1 for _, ok in results if ok)
    print(f"\n{n_ok}/{len(results)} dry-runs OK")
    if n_ok < len(results):
        sys.exit(1)


if __name__ == "__main__":
    main()
