"""The gang path on recurrent models: ``TorchBackend(decode="auto")`` on
reduced xlstm-125m and jamba-1.5-large (one superblock each) falls back to
the gang path, prefills prompts token by token, and emits the tokens and
counters of ``JaxBackend(decode="auto")`` on the same weights, on both
arms.  The harness and its margins are ``tests/test_torch_legacy.py``'s.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.engine import LAYER, SEMANTIC  # noqa: E402

from test_torch_legacy import _cfg, _check, _run_both  # noqa: E402


@pytest.mark.parametrize("arm", [LAYER, SEMANTIC], ids=["layer", "semantic"])
@pytest.mark.parametrize("name,seed", [("xlstm-125m", 10),
                                       ("jamba-1.5-large-398b", 5)])
def test_recurrent_gang_path_matches_jax_backend(monkeypatch, tiny_mesh,
                                                 name, seed, arm):
    jb, tb, jw, tw = _run_both(monkeypatch, tiny_mesh, _cfg(name), arm,
                               decode="auto", seed=seed)
    _check(jb, tb, arm, jw, tw)
    assert tb.extra_metrics()["prefill_calls"] == 0
    assert tb.decode_steps == jb.decode_steps > 0
