"""End-to-end training on the PyTorch port: a ~100M-param decoder trained
for a few hundred steps on the synthetic pipeline, in any of the three
execution modes, through ``repro_torch.launch.train``.

    PYTHONPATH=src python examples/train_100m_torch.py --steps 300
    PYTHONPATH=src python examples/train_100m_torch.py --mode pipeline  # layer split
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu \
        --arch stablelm-1.6b --steps 20         # a quick run on the CPU

The checkpoint goes to ``--ckpt`` (by default ``repro_torch_ckpt`` in the
temporary directory).
"""
import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--mode", default="fsdp",
                    choices=["fsdp", "semantic", "pipeline"])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    args = ap.parse_args(argv)
    # xlstm-125m at full config IS ~100M-class; train a reduced variant wide
    # enough to be non-trivial but CPU-feasible for a few hundred steps.
    return train_main(["--arch", args.arch, "--reduced", "--steps",
                       str(args.steps), "--seq-len", "128", "--batch", "8",
                       "--mode", args.mode, "--lr", "1e-3", "--ckpt",
                       args.ckpt, "--log-every", "20", "--device",
                       args.device])


if __name__ == "__main__":
    main()
