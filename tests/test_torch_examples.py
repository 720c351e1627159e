"""The port's twins of the JAX package's examples run on the CPU at a tiny
size, each in a process of its own where ``jax`` and ``repro`` cannot be
imported: ``examples/serve_splitplace_torch.py`` (UCB on ``TorchBackend``,
the paged path's assertions) and ``examples/train_100m_torch.py`` (the
train launcher, its checkpoint written)."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUN = ("import runpy, sys\n"
       "sys.modules['jax'] = None\n"
       "sys.modules['repro'] = None\n"
       "sys.argv = {argv!r}\n"
       "runpy.run_path({path!r}, run_name='__main__')\n")


def run_example(name, args):
    path = str(ROOT / "examples" / name)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(argv=[path] + args, path=path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_serve_splitplace_twin_runs_on_cpu():
    """One batch of two requests: both complete on the paged path, whose
    assertions (chunks per join wave, tokens per dispatch, no block left
    in use) hold."""
    out = run_example("serve_splitplace_torch.py", [
        "--device", "cpu", "--batches", "1", "--batch-size", "2"])
    assert "'completed': 2" in out
    assert "paged decode: " in out


def test_train_100m_twin_runs_on_cpu(tmp_path):
    """One step of the reduced stablelm through the twin's flags: its loss
    is printed and the checkpoint written."""
    out = run_example("train_100m_torch.py", [
        "--device", "cpu", "--arch", "stablelm-1.6b", "--steps", "1",
        "--ckpt", str(tmp_path)])
    assert "step     0 loss" in out
    assert (tmp_path / "step_1.npz").exists()
