"""Federated transformer-LM training through the fused round pipeline:
the same round API every benchmark uses (port of
``examples/federated_lm.py``).

The LM is a model-zoo entry (``SimConfig(model="transformer")``,
``repro_torch.learners``): selection, staleness-aware aggregation (the SAA
server step through the CUDA kernels, replayed from the round's CUDA
graph), K-round chunks and telemetry all come along, and a round's
host-to-device traffic stays one block of indices.  With ``--race`` the
same cell re-runs under several selection strategies on a shared
substrate (matched seeds).  Needs a GPU (``--device cpu`` runs the plain
PyTorch path).

  PYTHONPATH=src python -m repro_torch.federated_lm [--rounds 30]
  PYTHONPATH=src python -m repro_torch.federated_lm --race random,oort,flips
  PYTHONPATH=src python -m repro_torch.federated_lm --rounds 6 --parity
"""
import argparse
import dataclasses
import time

from repro_torch.sim import SimConfig, Simulator, Substrate

MODEL_PARAMS = (("n_layers", 2), ("d_model", 64), ("n_heads", 2),
                ("d_ff", 128))


def cell_config(selector: str, rounds: int, seed: int, **overrides):
    """The example's cell: ``tokens_skew``, 32 learners, a budget of 6,
    two local steps of 4 sequences, SAA through the kernels.  Static
    availability: every learner checks in every round, so the budget
    forces a real selection decision."""
    return SimConfig(**{**dict(
        benchmark="tokens_skew", model="transformer",
        model_params=MODEL_PARAMS, selector=selector, n_learners=32,
        rounds=rounds, eval_every=max(rounds // 4, 1), n_target=6,
        local_steps=2, local_batch=4, saa=True, use_agg_kernel=True,
        dynamic_availability=False, seed=seed), **overrides})


def run_cell(selector: str, rounds: int, seed: int, substrate=None,
             fused=True, device=None, **overrides):
    """One cell's run: (its substrate, a row of its results)."""
    cfg = cell_config(selector, rounds, seed, **overrides)
    if not fused:
        cfg = dataclasses.replace(cfg, fused_rounds=False)
    sub = substrate if substrate is not None else Substrate.build(cfg)
    t0 = time.time()
    acct = Simulator(cfg, substrate=sub, device=device).run()
    s = dict(acct.summary())
    losses = [r.loss for r in acct.records if r.loss == r.loss]
    return sub, {"selector": selector,
                 "eval_loss": losses[-1] if losses else float("nan"),
                 "accuracy": s["final_accuracy"],
                 "resource": s["resource_used"],
                 "wall_s": time.time() - t0,
                 "summary": s}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--race", default=None, metavar="A,B",
                    help="comma list of selectors to race under matched "
                         "seeds (see python -m repro_torch.sweeps "
                         "--list-selectors)")
    ap.add_argument("--parity", action="store_true",
                    help="rerun the first cell on the per-stage flat path "
                         "(fused_rounds=False) and require an equal summary")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, required)")
    args = ap.parse_args(argv)

    selectors = args.race.split(",") if args.race else ["random"]
    sub, rows = None, []
    for sel in selectors:
        sub, row = run_cell(sel, args.rounds, args.seed, substrate=sub,
                            device=args.device)
        rows.append(row)
        print(f"{row['selector']:>10s}  eval_loss={row['eval_loss']:.4f}  "
              f"acc={row['accuracy']:.4f}  resource={row['resource']:.1f}  "
              f"({row['wall_s']:.0f}s)")
    if len(rows) > 1:
        best = min(rows, key=lambda r: r["eval_loss"])
        print(f"# best at equal budget: {best['selector']} "
              f"(eval loss {best['eval_loss']:.4f})")
    if args.parity:
        _, flat = run_cell(selectors[0], args.rounds, args.seed,
                           substrate=sub, fused=False, device=args.device)
        assert flat["summary"] == rows[0]["summary"], \
            "fused/flat LM summary divergence"
        print("# parity: fused == flat (equal summary)")
    return rows


if __name__ == "__main__":
    main()
