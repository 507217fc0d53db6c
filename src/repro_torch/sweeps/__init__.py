"""Scenario sweeps (port of ``repro.sweeps``): declarative grids of FL
simulations run as lockstep batches on both substrates.

  grid    — named axes (policy, SAA, hardware, availability, mapping,
            seeds) expanded to concrete ``SimConfig`` cells with
            shared-seed pairing
  runner  — the lockstep batched executor: packed training with per-row
            models, one server-step launch for a round's groups, batched
            evaluation; per-cell metrics bit for bit a serial run's
  results — struct-of-arrays metric accumulation per cell
  report  — paper-style resource-to-accuracy tables (text / markdown)
  sharding — sweep-axis cell placement over a round mesh of ranks and the
            row migration of a repack

``python -m repro_torch.sweeps [--smoke] [--device cpu]`` runs a demo
grid, asserts that the batched metrics equal serial runs', and prints the
table; ``--sharded`` / ``--participant-shards N`` shard it over the ranks
of a process group.
"""
from repro_torch.sweeps.grid import (AXES, POLICIES, Cell, SweepSpec,  # noqa: F401
                                     axis_updates, register_axis)
from repro_torch.sweeps.results import CellResult, SweepResults  # noqa: F401
from repro_torch.sweeps.runner import (SweepRunner, assert_parity,  # noqa: F401
                                       compat_key, resume_sweep, run_batched,
                                       run_serial, summaries_equal)
