"""What the dry-run grid tests share, and what their spawned ranks run
(``repro_torch.sim.participant_sharding.run_ranks`` imports these
functions by name; pytest collects nothing here).

- ``reduced_record``: one (arch, shape) of the dry run's grid on a REDUCED
  config, placed on a fake (2, 4) mesh: its model axis of 4 splits the
  REDUCED GQA configs' 2 kv groups unevenly, as the full configs' 8 kv
  groups split over 16;
- ``placed_vs_plain``: a REDUCED fp32 config's prefill, decode step and
  train step (both cohorts) placed as DTensors on a host mesh over the
  current process group, each against the same call on plain tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

# the grid's four shapes, cut to the REDUCED configs: the train batch keeps
# the vmap cohort's 16 participants two sequences each; prompt and cache
# are long enough that their attention outweighs what 2 N T counts and a
# REDUCED step does not compute (the LM head at every prompt position, a
# decode step's embedding rows and vision frontend), which at full width
# is a small share
SHAPES = {"train_4k": (32, 32, "train"), "prefill_32k": (256, 4, "prefill"),
          "decode_32k": (256, 4, "decode"), "long_500k": (256, 1, "decode")}


def check_record(rec, shape):
    """A grid record counted, with FLOPs and bytes above 0, ``useful_ratio``
    in (0, 1.05] (a count under the model's own FLOPs has left work out),
    and a train step's collective bytes above 0."""
    assert rec["step"] == "counted", rec.get("error")
    assert rec["chips"] == 8 and rec["counted_on"] == "2x4"
    assert rec["flops_per_chip"] > 0 and rec["bytes_per_chip"] > 0
    assert 0 < rec["roofline"]["useful_ratio"] <= 1.05, rec["roofline"]
    if shape == "train_4k":
        assert rec["cohort"] == "vmap"
        assert rec["collectives"]["total"] > 0


def reduced_record(monkeypatch, arch: str, shape: str) -> dict:
    """``dryrun.lower_one`` on ``arch``'s REDUCED config at ``SHAPES[shape]``
    on a fake (2, 4) group (nothing saved)."""
    from repro_torch.configs import base, get_reduced
    from repro_torch.launch import dryrun, mesh
    monkeypatch.setattr(mesh, "POD", ((2, 4), ("data", "model")))
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", {
        k: base.InputShape(k, *v) for k, v in SHAPES.items()})
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    return dryrun.lower_one(arch, shape, save=False, verbose=False,
                            stream_participants=2)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _leaves(tree):
    from repro_torch.launch.shardings import leaves
    return [_full(t) for t in leaves(tree)]


def _compare(got, want) -> dict:
    """{"bitwise", "max_abs", "max_rel_excess"} of two lists of tensors:
    ``max_rel_excess`` is the largest |got - want| - rtol |want| at rtol
    1e-5, to be held under atol 1e-6."""
    bitwise, max_abs, excess = True, 0.0, -1.0
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        if a.dtype in (torch.float32, torch.float64):
            d = (a - b).abs()
            max_abs = max(max_abs, float(d.max()) if d.numel() else 0.0)
            excess = max(excess, float((d - 1e-5 * b.abs()).max()) if d.numel() else -1.0)
            bitwise &= bool(torch.equal(a, b))
        else:
            bitwise &= bool(torch.equal(a, b))
            excess = max(excess, 0.0 if torch.equal(a, b) else float("inf"))
    return {"bitwise": bitwise, "max_abs": max_abs, "max_rel_excess": excess}


@contextlib.contextmanager
def row_split(m: int):
    """The plain model with its row-parallel products (the attention's
    output projection and the MLP's down projection, split over the model
    axis' ``m`` ranks) summed as ``m`` contiguous partial products added in
    rank order, as a placed step's all-reduce adds them: the plain step
    with a placed step's order of sums."""
    import torch.nn.functional as F

    from repro_torch.models import attention, layers
    real = attention._project_out, layers.mlp

    def split(x, w):
        k = x.shape[-1] // m
        out = x[..., :k] @ w[:k]
        for r in range(1, m):
            out = out + x[..., r * k:(r + 1) * k] @ w[r * k:(r + 1) * k]
        return out

    def project_out(out, w):
        B, S, width = out.shape
        return split(out.reshape(B * S, width), w).reshape(B, S, w.shape[-1])

    def mlp(params, x):
        return split(F.silu(x @ params["w_gate"]) * (x @ params["w_up"]),
                     params["w_down"])
    attention._project_out, layers.mlp = project_out, mlp
    try:
        yield
    finally:
        attention._project_out, layers.mlp = real


def placed_vs_plain(arch: str, mesh_shape=(1, 1), kinds=("prefill", "decode",
                                                          "stream", "vmap"),
                    overrides=None, split_sums=False) -> dict:
    """For each of ``kinds``, the REDUCED fp32 ``arch``'s step placed on a
    ``mesh_shape`` (data, model) mesh over the current gloo group (the
    params by ``param_pspecs``, the batch on "data", the pod layout's pins
    on) against the plain step on the same seeded inputs: ``_compare`` of
    their outputs.  ``overrides`` replace config fields (``mla_absorb``).
    With ``split_sums`` the plain prefill and decode also run under
    ``row_split`` (the model axis' size), and their record holds that
    comparison, with the unsplit one's largest difference as
    ``unsplit_max_abs``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import base, get_reduced
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import init_params, shard_hints
    from repro_torch.models.transformer import (decode_step, init_decode_state,
                                                prefill)
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_reduced(arch), param_dtype=torch.float32,
                              **(overrides or {}))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data", "model"))
    specs = sh.param_pspecs(cfg, params, mesh)
    dparams = sh.distribute(params, specs, mesh)
    g = torch.Generator().manual_seed(1)
    tok = lambda *s: torch.randint(0, cfg.vocab_size, s, generator=g, dtype=torch.int32)

    def batch_of(lead, b, s):
        out = {"tokens": tok(*lead, b, s), "labels": tok(*lead, b, s)}
        if cfg.frontend == "vision":
            out["frontend_embeds"] = torch.randn(
                *lead, b, cfg.n_frontend_tokens, cfg.d_frontend, generator=g)
        return out

    out = {}
    hints = dict(batch_axes=("data",), model_axis="model")
    for kind in kinds:
        if kind == "prefill":
            batch = batch_of((), 2, 16)
            db = sh.distribute(batch, {k: sh.P("data", *([None] * (v.dim() - 1)))
                                       for k, v in batch.items()}, mesh)
            run = lambda: prefill(cfg, params, batch)
            with torch.no_grad():
                with shard_hints.hints(**hints), implicit_replication():
                    got = prefill(cfg, dparams, db)
        elif kind == "decode":
            shape = base.InputShape("decode", 16, 2, "decode")
            state = init_decode_state(cfg, 2, 16, device="cpu")
            spec = sh.input_specs(cfg, shape, mesh)
            args = {"state": state, "tokens": tok(2),
                    "position": torch.tensor([3, 7], dtype=torch.int32)}
            dargs = {k: (sh.distribute(v, spec.arg_specs[k], mesh) if k == "state"
                         else sh.distribute({"x": v}, {"x": spec.arg_specs[k]}, mesh)["x"])
                     for k, v in args.items()}
            run = lambda: decode_step(cfg, params, args["state"], args["tokens"],
                                      args["position"])
            with torch.no_grad():
                with shard_hints.hints(**hints), implicit_replication():
                    got = decode_step(cfg, dparams, dargs["state"], dargs["tokens"],
                                      dargs["position"])
        else:
            batch = batch_of((4,), 2, 8)
            lead = sh.P("data", None, None) if kind == "vmap" else sh.P(None, "data", None)
            db = sh.distribute(batch, {k: sh.P(*lead, *([None] * (v.dim() - 3)))
                                       for k, v in batch.items()}, mesh)
            fresh = torch.tensor([True, False, True, True])
            tau = torch.tensor([0, 2, 0, 0], dtype=torch.int32)
            run = lambda: make_fl_train_step(cfg, cohort=kind)(params, batch, fresh, tau)
            with shard_hints.hints(batch_axes=("data",) if kind == "stream" else None,
                                   model_axis="model"):
                got = make_fl_train_step(cfg, cohort=kind, param_specs=specs)(
                    dparams, db, fresh, tau)
        got = _leaves(list(got))
        with torch.no_grad() if kind in ("prefill", "decode") else contextlib.nullcontext():
            want = _leaves(list(run()))
            if split_sums and kind in ("prefill", "decode"):
                with row_split(mesh_shape[1]):
                    split = _leaves(list(run()))
                out[kind] = dict(_compare(got, split),
                                 unsplit_max_abs=_compare(got, want)["max_abs"])
            else:
                out[kind] = _compare(got, want)
    return out


def placed_rank(rank: int, cases) -> list:
    """``placed_vs_plain(arch, mesh_shape, kinds, split_sums=True)`` for
    each case on one rank of a spawned gloo group."""
    return [placed_vs_plain(arch, tuple(m), tuple(kinds), split_sums=True)
            for arch, m, kinds in cases]
