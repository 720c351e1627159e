"""Dry run of the port: one rank of the production mesh, traced on the
meta device, for every (arch x input shape) (``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape decode_32k --multi-pod

The reference lowers and compiles each step on 256 (or 512, two pods)
devices forced on the host, over ``ShapeDtypeStruct`` inputs, and reads
XLA's memory and cost analyses.  The port has no compiler, so it runs the
step itself, as one rank of that mesh: this process plays the rank in a
``"fake"`` world of the mesh's size (``launch.mesh.fake_mesh``), whose
collectives move nothing, and the rank's parameters, AdamW state, batch
and cache are meta tensors, which hold shapes and no memory.  No device is
touched and nothing is allocated.  The step is the one a user calls: the
train step (``make_train_step``: ``value_and_grad`` and AdamW), the
prefill (``runner.prefill_step``) or the serve step (``make_serve_step``
over ``runner.init_cache``).  The serve step runs at ``cache_index =
seq_len - 1``: the reference lowers it at an abstract index, the port's
steps take a Python int, and at that index every slot of the cache is
valid (the decode kernel's full length, the work XLA's static shapes
count).

While the step runs, a dispatch-mode tracker (:class:`StorageTracker`)
counts the aten ops' flops (by ``FlopCounterMode``'s formulas, its
``flop_registry``), the bytes every op reads and writes and the bytes of
live storage, ``dist.comm.COMM_STATS`` the
collectives, and the kernels' wrappers, which on meta tensors check,
allocate and count what a launch would (``kernels.cost``; the predicted
launches in the wrappers' ``dry_launches`` and the launchers'
``DRY_PATH_LAUNCHES``), the kernels' launches, flops and bytes.  The
record keeps the reference's keys where they mean the same thing:

- ``flops``: the aten ops' and the kernels' (``aten_flops``,
  ``kernel_flops``); ``bytes_accessed``: each op's inputs and outputs
  (views and bare allocations move nothing) and the kernels' bytes;
- ``argument_bytes``: what the rank holds when the step starts, under the
  specs (``param_bytes`` + ``opt_bytes`` + ``batch_bytes``, its rows of
  the batch, + ``cache_bytes``);
- ``output_bytes``: new storage the step returns (updated parameters,
  moments and caches are written in place);
- ``peak_bytes``: the most live storage during the step, arguments
  included (and the whole batch, which the port's runners take and cut
  into their rows); ``temp_bytes``: the peak less what was live at the
  start;
- ``param_count``, ``active_param_count``.

In place of ``lower_s`` and ``compile_s`` there is one ``trace_s`` (the
step's wall time), and in place of the HLO text, per collective op the
calls and bytes a rank puts in (``collectives``) and the kernels'
launches by path (``kernels``).  There is no ``generated_code_bytes``.
Where ranks of a layout hold different shapes (the stages: the first
embeds, the last runs the head), each distinct rank is traced and the one
of the largest peak is recorded; every rank of the gspmd, fsdp and
semantic layouts holds the same shapes, so rank 0 stands for them.
Records go to ``experiments/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import resource
import time
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import get_config
from repro_torch.dist import api as A
from repro_torch.dist import comm
from repro_torch.dist import sharding as SH
from repro_torch.kernels import _flash_launch, _gemm_launch, cost
from repro_torch.kernels.block_diag_matmul import block_diag_matmul
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import moe_gmm_ragged
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.models.model import INPUT_SHAPES, InputShape, input_specs
from repro_torch.optim.adamw import AdamWState, adamw_init

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"

# Archs where splitting a <100M model over 256 chips is counterproductive
# (DESIGN.md §5): baseline mode is fsdp.
FSDP_BASELINE = {"whisper-base"}

# long_500k policy (DESIGN.md §5): whisper skipped; full-attention archs run
# the documented sliding-window serving variant.
LONG_SKIP = {"whisper-base"}
SWA_WINDOW = 8192
SUBQUADRATIC = {"xlstm-125m"}          # no attention KV at all

#: aten ops that allocate without reading or writing data
_NO_DATA = {torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default,
            torch.ops.aten.new_empty.default,
            torch.ops.aten.new_empty_strided.default}
#: the kernels on the dry run's path
KERNELS = {"flash_attention": (flash_attention,
                                 _flash_launch.DRY_PATH_LAUNCHES),
           "decode_attention": (decode_attention, None),
           "block_diag_matmul": (block_diag_matmul,
                                 _gemm_launch.DRY_PATH_LAUNCHES),
           "moe_gmm_ragged": (moe_gmm_ragged,
                              _gemm_launch.DRY_PATH_LAUNCHES)}
#: the paths each kernel counts where two share a launcher's counter
_PATHS_OF = {"block_diag_matmul": ("wgmma", "tiled", "mma_skinny", "skinny"),
             "moe_gmm_ragged": ("ragged_decode", "ragged_prefill")}


def default_mode(arch: str) -> str:
    return "fsdp" if arch in FSDP_BASELINE else "pipeline"


def window_for(cfg, shape_name: str):
    if shape_name != "long_500k":
        return None
    if cfg.family in ("ssm",):
        return None
    return SWA_WINDOW


def opt_dtype_for(cfg) -> str:
    # fp32 (m,v) for a 398B model does not fit 256 chips (DESIGN.md §8)
    return "bfloat16" if cfg.param_count() > 100e9 else "float32"


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under a tree's tensors."""
    seen = WeakIdKeyDictionary()
    for t in _tensors(tree):
        st = t.untyped_storage()
        if st not in seen:
            seen[st] = st.nbytes()
    return sum(seen.values())


def _flat_tensors(xs, out: list) -> list:
    """The tensors among ``xs`` and the lists and tuples in it (an op's
    arguments and results)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            _flat_tensors(x, out)
    return out


class StorageTracker(TorchDispatchMode):
    """The storages live while its block runs (those :meth:`hold` names and
    every op's outputs, each counted once and dropped when its last tensor
    goes) with their peak; the bytes every op reads and writes (views and
    bare allocations excepted); and the flops of the ops
    ``FlopCounterMode`` counts, by its formulas."""

    def __init__(self):
        super().__init__()
        self._seen = WeakIdKeyDictionary()
        self.live = self.peak = self.bytes_accessed = 0
        self.flops = 0

    def hold(self, tree) -> None:
        for t in _tensors(tree):
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _flat_tensors(out if isinstance(out, (list, tuple))
                             else (out,), [])
        if not func.is_view and func not in _NO_DATA:
            self.bytes_accessed += sum(map(_nbytes, _flat_tensors(
                (args, tuple(kwargs.values())), list(outs))))
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for t in outs:
            self._add(t)
        return out


def pod_moments(runner, opt_dtype: str = "float32"):
    """AdamW moments split further over 'pod' (``pod_shard_opt_specs``), as
    ``make_train_step(opt_specs=)`` takes them: (state, specs), each leaf
    the rank's slice of the whole leaf, zeros on the runner's device."""
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[opt_dtype]
    whole = runner.model.param_tree()             # meta, whole leaves
    o_specs = SH.pod_shard_opt_specs(SH.make_opt_specs(runner.specs), whole,
                                     runner.mesh)
    sizes = dict(runner.mesh.shape)
    zeros = lambda leaf, spec: torch.zeros(
        SH.shard_shape(tuple(leaf.shape), spec, sizes), dtype=dt,
        device=runner.device)
    return AdamWState(0, SH.tree_map(zeros, whole, o_specs.m),
                      SH.tree_map(zeros, whole, o_specs.v)), o_specs


def _reset_counters() -> Dict:
    comm.reset_stats()
    cost.reset_dryrun()
    for fn, _ in KERNELS.values():
        fn.dry_launches = 0
    return {k: dict(paths) for k, (_, paths) in KERNELS.items()
            if paths is not None}


def _kernel_counts(paths_before: Dict) -> Dict:
    out = {}
    for name, (fn, paths) in KERNELS.items():
        out[name] = {"launches": fn.dry_launches}
        if paths is not None:
            out[name]["paths"] = {p: paths[p] - paths_before[name][p]
                                  for p in _PATHS_OF.get(name, paths)
                                  if paths[p] != paths_before[name][p]}
    return out


def _collectives() -> Dict:
    stats = dict(comm.COMM_STATS)
    ops = sorted({k[:-len("_calls")] for k in stats if k.endswith("_calls")})
    return {op: {"calls": int(stats[f"{op}_calls"]),
                 "bytes": int(stats.get(f"{op}_bytes", 0))} for op in ops}


def rank_arguments(runner, shape: InputShape, *,
                   window: Optional[int] = None, opt_dtype: str = "float32",
                   pod_opt: bool = False) -> Dict:
    """What the rank of ``runner`` (built on the meta device) holds when
    its step at ``shape`` starts, nothing traced: ``params``; for train
    ``opt`` (moments in ``opt_dtype``, split over 'pod' too with
    ``pod_opt``, their specs in ``opt_specs``); ``batch`` (the global
    batch, as the runners take it); for decode ``cache`` (``seq_len`` slots,
    a ring of ``window``); and ``parts``, the bytes of each under the specs
    (the batch's: this rank's rows)."""
    rcfg, mesh = runner.cfg, runner.mesh
    params = runner.init()
    opt = o_specs = cache = None
    if shape.kind == "train":
        if pod_opt:
            opt, o_specs = pod_moments(runner, opt_dtype)
        else:
            opt = adamw_init(params, opt_dtype)
    batch = input_specs(rcfg, shape)
    if shape.kind == "decode":
        cache = runner.init_cache(shape.global_batch, shape.seq_len, window)
    parts = {
        "param_bytes": storage_bytes(params),
        "opt_bytes": storage_bytes(opt),
        "batch_bytes": SH.bytes_per_rank(batch, A.batch_specs(
            rcfg, mesh, batch), mesh),
        "cache_bytes": storage_bytes(cache)}
    return dict(params=params, opt=opt, opt_specs=o_specs, batch=batch,
                cache=cache, parts=parts)


def dryrun_rank(runner, shape: InputShape, *, window: Optional[int] = None,
                remat: bool = False, opt_dtype: str = "float32",
                pod_opt: bool = False) -> Dict:
    """Trace one step of ``runner`` (built on the meta device, on a fake
    mesh or on one device) at ``shape``: the train step (AdamW moments in
    ``opt_dtype``, split over 'pod' too with ``pod_opt``), the prefill, or
    the serve step over a cache of ``shape.seq_len`` slots (a ring of
    ``window``) at ``cache_index = seq_len - 1``.  Returns the record's
    measured keys (see the module docstring)."""
    t0 = time.perf_counter()
    a = rank_arguments(runner, shape, window=window, opt_dtype=opt_dtype,
                       pod_opt=pod_opt)
    setup_s = time.perf_counter() - t0
    params, opt, batch, cache = args = (a["params"], a["opt"], a["batch"],
                                        a["cache"])
    before = _reset_counters()
    tracker = StorageTracker()
    tracker.hold(args)
    at_start = tracker.live
    t0 = time.perf_counter()
    with tracker:
        if shape.kind == "train":
            step = A.make_train_step(runner, remat=remat,
                                     opt_specs=a["opt_specs"])
            out = step(params, opt, batch)
        elif shape.kind == "prefill":
            out = runner.prefill_step(params, batch)
        else:
            step = A.make_serve_step(runner, window_override=window)
            out = step(params, cache, batch, shape.seq_len - 1)
    trace_s = time.perf_counter() - t0
    held = WeakIdKeyDictionary()
    for t in _tensors(args):
        held[t.untyped_storage()] = True
    output_bytes = storage_bytes([t for t in _tensors(out)
                                  if t.untyped_storage() not in held])
    aten_flops = tracker.flops
    return {
        "trace_s": round(trace_s, 3), "setup_s": round(setup_s, 3),
        "flops": float(aten_flops + cost.DRYRUN["flops"]),
        "aten_flops": float(aten_flops),
        "kernel_flops": float(cost.DRYRUN["flops"]),
        "bytes_accessed": float(tracker.bytes_accessed
                                + cost.DRYRUN["bytes"]),
        "kernel_bytes": float(cost.DRYRUN["bytes"]),
        "argument_bytes": sum(a["parts"].values()), **a["parts"],
        "output_bytes": int(output_bytes),
        "temp_bytes": int(tracker.peak - at_start),
        "peak_bytes": int(tracker.peak),
        "collectives": _collectives(),
        "kernels": _kernel_counts(before),
        "window": window, "cache_index": shape.seq_len - 1
        if shape.kind == "decode" else None, "remat": remat}


def _stage_ranks(runner) -> bool:
    """True when the ranks of the runner's 'model' axis hold different
    shapes: the explicit stage graph, or stages serving a split stack."""
    if not isinstance(runner, A.PipelineRunner) or runner.n_stages == 1:
        return False
    return runner._use_stage_graph() or runner._staged()


def run_dryrun(arch: str, shape_name: str, *, mode: str = None,
               multi_pod: bool = False, save: bool = True,
               n_micro: int = None, verbose: bool = True,
               variant: str = "", runner_kw: dict = None):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mode = mode or default_mode(arch)
    if shape_name == "long_500k" and arch in LONG_SKIP:
        raise SystemExit(f"{arch} x long_500k skipped (DESIGN.md §5)")

    dims = make_production_mesh(multi_pod=multi_pod).dims
    kw = dict(runner_kw or {})
    if mode == "pipeline" and cfg.moe is not None \
            and cfg.moe.n_experts % 16 == 0 and "expert_parallel" not in kw:
        kw["expert_parallel"] = True  # production default: EP is numerically
        # identical to dense dispatch and 5.9x lighter on collectives (§Perf)
    pod_opt = shape.kind == "train" and multi_pod \
        and cfg.param_count() > 100e9
    window = window_for(cfg, shape_name)

    def trace(rank: int):
        with fake_mesh(dims, rank=rank) as mesh:
            runner = A.build_runner(cfg, mode, mesh, n_microbatches=n_micro,
                                    device="meta", **kw)
            rec = dryrun_rank(runner, shape, window=window,
                              opt_dtype=opt_dtype_for(cfg), pod_opt=pod_opt)
            return rec, runner

    rec, runner = trace(0)
    ranks = {0: rec}
    if _stage_ranks(runner):
        last = runner.n_stages - 1          # data 0, pod 0, last stage
        ranks[last] = trace(last)[0]
    rank = max(ranks, key=lambda r: ranks[r]["peak_bytes"])
    record = {
        "arch": arch, "shape": shape_name, "mode": mode, "variant": variant,
        "multi_pod": multi_pod, "n_devices": int(torch.tensor(dims).prod()),
        "rank": rank, **ranks[rank],
        "ranks": {str(r): {k: v[k] for k in ("peak_bytes", "argument_bytes",
                                              "flops", "trace_s")}
                  for r, v in ranks.items()},
        "param_count": int(cfg.param_count()),
        "active_param_count": int(cfg.active_param_count()),
        # the tracing process's own peak resident memory on the host
        "host_max_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss // 1024,
    }
    if verbose:
        print(json.dumps(record, indent=2))
    if save:
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}__{mode}"
        if variant:
            tag += f"__{variant}"
        (OUT_DIR / f"{tag}.json").write_text(json.dumps(record, indent=2))
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--mode", default=None,
                    choices=[None, "fsdp", "semantic", "pipeline"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--n-micro", type=int, default=None)
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--no-zero-data", action="store_true")
    ap.add_argument("--ep", action="store_true")
    ap.add_argument("--flash-decode", action="store_true",
                    help="shard attention KV cache length over 'data'")
    args = ap.parse_args(argv)
    kw = {}
    if args.no_zero_data:
        kw["zero_data"] = False
    if args.ep:
        kw["expert_parallel"] = True
    if args.flash_decode:
        kw["shard_cache_len"] = True
    run_dryrun(args.arch, args.shape, mode=args.mode,
               multi_pod=args.multi_pod, save=not args.no_save,
               n_micro=args.n_micro, variant=args.variant, runner_kw=kw)


if __name__ == "__main__":
    main()
