"""repro_torch.dist — the paper's split strategies as training runners on
one device (``repro.dist`` without its meshes and sharding specs):
:mod:`repro_torch.dist.api` (``build_runner``, ``make_train_step``) and
:mod:`repro_torch.dist.pipeline` (microbatching for the layer split)."""
from repro_torch.dist.api import build_runner, make_train_step  # noqa: F401
