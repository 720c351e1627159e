"""repro_torch.dist — the paper's split strategies as training runners, on
one device or on a mesh of ranks over ``torch.distributed`` (``repro.dist``):
:mod:`repro_torch.dist.api` (``build_runner``, ``make_train_step`` and the
spec re-exports), :mod:`repro_torch.dist.sharding` (the reference's
partition specs), :mod:`repro_torch.dist.pipeline` (microbatching, the
stage graph over point-to-point sends, the expert-parallel substrate) and
:mod:`repro_torch.dist.comm` (the collectives)."""
from repro_torch.dist.api import (  # noqa: F401
    batch_specs,
    build_runner,
    make_opt_specs,
    make_serve_step,
    make_train_step,
    pod_shard_opt_specs,
)
