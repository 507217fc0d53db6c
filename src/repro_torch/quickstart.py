"""Quickstart: RELAY vs Random selection on a simulated FL population.

Runs two short federated campaigns on the speech-like benchmark (non-IID,
dynamic availability), with the SAA server step through the CUDA kernel,
and prints the resource-to-accuracy comparison — the paper's headline
metric.  Needs a GPU (``--device cpu`` runs the plain PyTorch path).

  PYTHONPATH=src python -m repro_torch.quickstart
"""
import argparse

from repro_torch.sim import SimConfig, Simulator

COMMON = dict(n_learners=100, rounds=60, eval_every=15, seed=0,
              mapping="label_uniform", dynamic_availability=True,
              use_agg_kernel=True)
CAMPAIGNS = {
    "Random": dict(selector="random"),
    "RELAY": dict(selector="priority", saa=True, apt=True,
                  scaling_rule="relay"),
}


def run_campaigns(device=None, progress: bool = True, **overrides) -> dict:
    """Run both campaigns; returns {name: Accounting}."""
    out = {}
    for name, kw in CAMPAIGNS.items():
        if progress:
            print(f"=== {name} ===")
        cfg = SimConfig(**{**COMMON, **kw, **overrides})
        out[name] = Simulator(cfg, device=device).run(progress=progress)
    return out


def table(accts: dict) -> str:
    r, s = accts["Random"].summary(), accts["RELAY"].summary()
    lines = ["--- resource-to-accuracy ---",
             f"{'':14s}{'accuracy':>10s}{'resources':>12s}{'waste':>8s}{'unique':>8s}"]
    for name, m in (("Random", r), ("RELAY", s)):
        lines.append(f"{name:14s}{m['final_accuracy']:10.3f}"
                     f"{m['resource_used']:11.0f}s{m['waste_fraction']:8.1%}"
                     f"{m['unique_participants']:8d}")
    save = 1 - s["resource_used"] / r["resource_used"]
    lines.append(f"\nRELAY used {save:.0%} fewer learner resources.")
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, required)")
    args = ap.parse_args()
    print(table(run_campaigns(device=args.device)))


if __name__ == "__main__":
    main()
