"""The paper's evaluation (Table I) on the PyTorch port's placement engine.

Poisson arrivals of ResNet50V2/MobileNetV2/InceptionV3 jobs with SLA
deadlines run against the vectorized ``SimBackend``: the paper's 10
RPi-class hosts by default, thousands with ``--hosts``.  Compares the
compression baseline against SplitPlace (MAB + A3C) and the two fixed-arm
ablations.  A3C's networks run on ``--device`` (the card by default); the
simulator is host numpy.

    PYTHONPATH=src python examples/edge_simulation_torch.py [--intervals 3000]
    PYTHONPATH=src python examples/edge_simulation_torch.py --device cpu \\
        --hosts 1000 --rate 60 --intervals 300     # scale-out run
"""
import argparse

from repro_torch.engine import (LAYER, SEMANTIC, CompressionPolicy,
                                FixedPolicy, MABPolicy, PlacementEngine,
                                PoissonSource)
from repro_torch.engine.sim_backend import SimBackend
from repro_torch.sched.a3c import A3CPlacement


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--intervals", type=int, default=3000)
    ap.add_argument("--hosts", type=int, default=10)
    ap.add_argument("--rate", type=float, default=0.6,
                    help="mean arrivals per interval")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where A3C's networks run")
    args = ap.parse_args()

    def a3c():
        return A3CPlacement(n_hosts=args.hosts, device=args.device)

    policies = [
        ("baseline (compression+A3C)", lambda: CompressionPolicy(a3c())),
        ("SplitPlace (UCB MAB+A3C)",
         lambda: MABPolicy(bandit="ucb", placement=a3c())),
        ("SplitPlace (Thompson)",
         lambda: MABPolicy(bandit="thompson", placement=a3c())),
        ("always-layer", lambda: FixedPolicy(LAYER, a3c())),
        ("always-semantic", lambda: FixedPolicy(SEMANTIC, a3c())),
    ]
    print(f"{'policy':30s} {'reward':>7s} {'SLAviol':>8s} {'acc':>6s} "
          f"{'energy':>7s} {'resp_s':>7s} {'sem%':>5s}")
    for name, mk in policies:
        backend = SimBackend(n_hosts=args.hosts, seed=args.seed)
        source = PoissonSource(rate=args.rate, seed=args.seed + 2,
                               sla_range=(0.5, 3.0))
        eng = PlacementEngine(mk(), backend)
        m = eng.run(source, args.intervals)
        print(f"{name:30s} {m['reward']:7.4f} {m['sla_violation']:8.4f} "
              f"{m['accuracy']:6.4f} {m['energy_wh']:7.2f} "
              f"{m['mean_response_s']:7.3f} "
              f"{m['decisions_semantic_frac']*100:5.1f}")


if __name__ == "__main__":
    main()
