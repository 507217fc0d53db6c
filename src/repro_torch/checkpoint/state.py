"""Crash-safe run snapshots (port of ``repro.checkpoint.state``).

``repro_torch.checkpoint.checkpoint`` stores one parameter tree; this module
stores everything a *run* needs to resume bit for bit: each simulation's
host state (RNG stream, selector, APT, accounting, forecaster banks, busy
clocks), its model and YoGi rows, its stale-cache rows in insertion order,
the device counters not yet in its accounting, the round to resume at
and, for a sweep, the finished cells' accountings.

The contract: snapshots come only at round boundaries (the per-stage flat
path) or chunk boundaries (the fused pipeline), so a resumed run walks the
decisions and the chunks the uninterrupted run walks:
run(2R) == run(R) -> crash -> resume(R), bit for bit, at any
``rounds_per_dispatch``.  A telemetry session resumed into the crashed
run's directory joins the contract: its round log (``rounds.jsonl``) is
truncated to the snapshot's byte offset and the resumed rounds re-emit the
rest, byte for byte the uninterrupted run's log.

A snapshot carries its fault plan, restored without its crash
(``FaultPlan.without_crash``): the corruption, drops, replays and attacks
replay as scheduled, the crash does not fire again.

Format: one pickle file of the port's own objects, written atomically (a
temporary file, then ``os.replace``), so a crash while writing leaves the
previous snapshot whole.  The reference's snapshots are not read: they
hold the JAX package's objects.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import torch

SNAPSHOT_VERSION = 1


class SnapshotError(ValueError):
    """The snapshot file is missing, unreadable, or from another format."""


def save_snapshot(path: str, payload: dict) -> None:
    """Atomic pickle write: the previous snapshot survives a crash here."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(payload, fh, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_snapshot(path: str) -> dict:
    if not os.path.exists(path):
        raise SnapshotError(f"no snapshot at {path!r}")
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    if not isinstance(payload, dict) or "version" not in payload:
        raise SnapshotError(f"{path!r} is not a run snapshot")
    if payload["version"] != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"{path!r}: snapshot version {payload['version']} "
            f"(this build reads {SNAPSHOT_VERSION})")
    return payload


# ---------------------------------------------------------------------------
# The per-stage flat path's snapshots (one Simulator between rounds)
# ---------------------------------------------------------------------------


def _host(t):
    return None if t is None else t.detach().cpu().numpy()


def engine_snapshot(sim, next_round: int) -> dict:
    """Snapshot a flat-path Simulator between rounds; ``next_round`` is the
    first round the resumed loop runs."""
    opt = sim.flat_opt_state
    return {"version": SNAPSHOT_VERSION, "kind": "engine",
            "next_round": int(next_round),
            "sim": {"cfg": dataclasses.asdict(sim.cfg),
                    "state": sim.capture_state(),
                    "fault_plan": sim.fault_plan,
                    "flat_params": _host(sim.flat_params),
                    "flat_opt_state": None if opt is None else
                    {k: _host(v) for k, v in opt.items()}}}


def save_engine_snapshot(path: str, sim, next_round: int) -> None:
    save_snapshot(path, engine_snapshot(sim, next_round))


def _restore_sim(ps: dict, substrate_cache: Optional[dict] = None,
                 device=None):
    """One Simulator rebuilt from its snapshot payload on ``device`` (the
    GPU unless named).  The substrate is rebuilt from the config's seed
    (it is never stored), then the captured state goes on top; the fault
    plan comes back without its crash."""
    from repro_torch.sim.engine import (SimConfig, Simulator, Substrate,
                                        substrate_key)
    cfg = SimConfig(**ps["cfg"])
    key = substrate_key(cfg)
    if substrate_cache is not None and key in substrate_cache:
        sub = substrate_cache[key]
    else:
        sub = Substrate.build(cfg)
        if substrate_cache is not None:
            substrate_cache[key] = sub
    fp = ps.get("fault_plan")
    sim = Simulator(cfg, substrate=sub, device=device,
                    fault_plan=None if fp is None else fp.without_crash())
    sim.restore_state(ps["state"])
    sim.flat_params = torch.as_tensor(ps["flat_params"],
                                      device=sim.device).clone()
    if ps.get("flat_opt_state") is not None:
        sim.flat_opt_state = {k: torch.as_tensor(v, device=sim.device).clone()
                              for k, v in ps["flat_opt_state"].items()}
    return sim


# ---------------------------------------------------------------------------
# The fused pipeline's snapshots (``RoundPipeline.snapshot``)
# ---------------------------------------------------------------------------


def build_resumed_pipeline(payload: dict, progress: bool = False, *,
                           device=None, checkpoint_path: Optional[str] = None,
                           checkpoint_every: int = 0, checkpoint_wrap=None,
                           telemetry=None, mesh=None):
    """A RoundPipeline rebuilt mid-run from a ``kind == "pipeline"``
    snapshot.  Its params, YoGi state and counters come from the restored
    Simulators (and fill an idle graph workspace's buffers, as any new
    pipeline's do, before the first replay); the cache takes the
    snapshot's capacity, so the rounds reuse the graphs of that capacity,
    and each stale row goes back into a slot in its saved order (slot ids
    never reach a value).  A ``telemetry`` session logging into the
    crashed run's directory is truncated back to the snapshot's round-log
    offset first; the cells keep their labels.

    A sharded pipeline (``mesh``, or the cells' ``shard_participants``)
    is rebuilt on every rank from the same snapshot: the slot accounts
    take its capacity, each stale row a slot on its cell's s-shard and on
    the p-shard that held it (p-shard 0 when the snapshot came from
    another participant split), and each rank keeps its own shard's rows.
    A snapshot of a sharded run resumes unsharded, and one of an
    unsharded run sharded: no value depends on where a row lives."""
    from repro_torch.sim.pipeline import RoundPipeline
    sub_cache: dict = {}
    sims = [_restore_sim(ps, sub_cache, device) for ps in payload["sims"]]
    if telemetry is not None:
        telemetry.restore(payload.get("telemetry"))
    pipe = RoundPipeline(sims, progress=progress,
                         checkpoint_path=checkpoint_path,
                         checkpoint_every=checkpoint_every,
                         checkpoint_wrap=checkpoint_wrap,
                         start_round=int(payload["next_round"]),
                         telemetry=telemetry, labels=payload.get("labels"),
                         mesh=mesh)
    pipe.done = list(payload["done"])
    cache, capacity = pipe.cache, pipe.cache.capacity
    entries = [f for sim in sims for f in sim.stale_cache]
    if pipe.mesh is None:
        cache.reserve(int(payload["cache_capacity"]))
        slots = cache.alloc(len(entries))
        rows = [f.delta for f in entries]
        for f, slot in zip(entries, slots):
            f.delta = int(slot)
    else:
        slots, rows = _reseat_sharded(pipe, payload)
    if cache.capacity != capacity and pipe.graphs is not None:
        cache.rows = pipe.graphs.cache_rows(cache.rows)   # as _schedule does
    if slots:
        cache.put(slots, torch.stack(rows))
    return pipe


def _reseat_sharded(pipe, payload) -> tuple:
    """Give every stale row of ``payload`` a slot in ``pipe``'s sharded
    accounts (see ``build_resumed_pipeline``); returns (this rank's slots,
    their rows)."""
    mesh, acc = pipe.mesh, pipe.accounts
    acc.reserve(int(payload["cache_capacity"]))
    same_p = payload.get("mesh") is not None and payload["mesh"][1] == mesh.n_p
    slots, rows = [], []
    for i, (sim, ps) in enumerate(zip(pipe.sims, payload["sims"])):
        shards = ps.get("stale_shards") if same_p else None
        for k, f in enumerate(sim.stale_cache):
            flat = (pipe.placement.shard_of[i] * mesh.n_p
                    + (shards[k] % mesh.n_p if shards else 0))
            slot = acc.alloc(flat, 1)[0][0]
            if flat == mesh.rank:
                slots.append(slot)
                rows.append(f.delta)
            f.delta = (flat, slot)
    pipe.cache.reserve(acc.capacity)
    return slots, rows


def resume_run(path: str, progress: bool = False, *, device=None,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: int = 0, telemetry=None):
    """Resume a run from its snapshot on ``device`` (the GPU unless
    named), with its spans and round log in ``telemetry``.  Returns the
    finalized Accounting (a list of them for a pipeline of several
    cells), bit for bit the uninterrupted run's."""
    payload = load_snapshot(path)
    if payload["kind"] == "engine":
        sim = _restore_sim(payload["sim"], device=device)
        return sim._run_loop(int(payload["next_round"]), progress,
                             checkpoint_path, checkpoint_every,
                             telemetry=telemetry)
    if payload["kind"] == "pipeline":
        pipe = build_resumed_pipeline(payload, progress=progress,
                                      device=device,
                                      checkpoint_path=checkpoint_path,
                                      checkpoint_every=checkpoint_every,
                                      telemetry=telemetry)
        accts = pipe.run()
        return accts[0] if len(accts) == 1 else accts
    raise SnapshotError(f"{path!r}: unknown snapshot kind "
                        f"{payload['kind']!r}")
