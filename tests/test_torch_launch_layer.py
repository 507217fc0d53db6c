"""The pod launch layer (``repro_torch.launch.mesh``, ``.shardings``,
``.dryrun``), ``shape_params`` and the placed train step, held against the
JAX package's ``repro.launch.shardings`` and within the port.

- ``param_pspecs`` leaf for leaf ``==`` the reference's, all ten archs on
  both production meshes (duck-typed meshes, as
  ``tests/test_shardings.py``), from ``shape_params`` against
  ``jax.eval_shape(init_params)``: same key paths, shapes and dtypes;
- ``input_specs``: every arch x shape x mesh x cohort, the meta stand-ins'
  shapes and dtypes and their specs ``==`` the reference's
  ``ShapeDtypeStruct``s and ``PartitionSpec``s, and the per-chip argument
  bytes ``==`` the same arithmetic on the reference's specs;
- placements on a real ``DeviceMesh`` (fake backend, in a subprocess):
  DTensor local shards of the shapes ``shard_shape`` gives, and the dry
  run on a REDUCED config on a fake (2, 2) mesh, the group destroyed after;
- the train step with ``param_specs`` on a one-rank gloo (1, 1) mesh ``==``
  the unplaced step on the CPU, bit for bit (the same local ops on the
  same values: a one-rank redistribute moves nothing).

``repro.launch.dryrun`` is not imported here: it sets ``XLA_FLAGS`` when
imported.
"""
import dataclasses
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import adapt_for_shape as jadapt
from repro.configs import get_config as jget_config
from repro.launch import shardings as jsh
from repro.models import init_params as jinit_params
from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, adapt_for_shape,
                                 get_config, get_reduced)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import axis_sizes, batch_axes, mesh_shape
from repro_torch.models.transformer import shape_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


class FakeMesh:
    """Duck-typed mesh: shape dict + axis_names, no devices needed."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"pod": FakeMesh({"data": 16, "model": 16}),
          "multipod": FakeMesh({"pod": 2, "data": 16, "model": 16})}
_JSHAPES = {}


def _jshapes(arch):
    if arch not in _JSHAPES:
        cfg = jget_config(arch)
        _JSHAPES[arch] = jax.eval_shape(lambda k: jinit_params(cfg, k),
                                        jax.random.PRNGKey(0))
    return _JSHAPES[arch]


def _jpaths(tree, is_leaf=None):
    """{path string: leaf} of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            leaf for p, leaf in flat}


def _tpaths(tree):
    out = {}
    sh.map_tree(lambda p, leaf: out.__setitem__("/".join(map(str, p)), leaf),
                tree)
    return out


def _is_p(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _dtype(d):
    return str(d).replace("torch.", "")


def _jbytes(shapes, specs, mesh):
    """The per-chip bytes arithmetic on the reference's specs."""
    sizes = axis_sizes(mesh)
    total = 0
    for path, leaf in _jpaths(shapes).items():
        spec = _jpaths(specs, is_leaf=_is_p)[path]
        total += math.prod(sh.shard_shape(leaf.shape, tuple(spec), sizes)) \
            * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(arch, mesh):
    m = MESHES[mesh]
    jshapes = _jshapes(arch)
    tshapes = shape_params(get_config(arch))
    jleaves, tleaves = _jpaths(jshapes), _tpaths(tshapes)
    assert list(jleaves) == sorted(jleaves) and set(jleaves) == set(tleaves)
    for path, leaf in jleaves.items():
        assert tuple(tleaves[path].shape) == tuple(leaf.shape), path
        assert _dtype(tleaves[path].dtype) == str(leaf.dtype), path
        assert tleaves[path].device.type == "meta"
    jspecs = _jpaths(jsh.param_pspecs(jget_config(arch), jshapes, m),
                     is_leaf=_is_p)
    tspecs = _tpaths(sh.param_pspecs(get_config(arch), tshapes, m))
    assert {p: tuple(s) for p, s in tspecs.items()} == \
        {p: tuple(s) for p, s in jspecs.items()}
    assert all(isinstance(s, sh.PartitionSpec) for s in tspecs.values())


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch, shape_name, mesh):
    m = MESHES[mesh]
    shape = INPUT_SHAPES[shape_name]
    jcfg = jadapt(jget_config(arch), JSHAPES[shape_name])
    tcfg = adapt_for_shape(get_config(arch), shape)
    cohorts = ("vmap", "stream") if shape.kind == "train" else ("vmap",)
    for cohort in cohorts:
        js = jsh.input_specs(jcfg, JSHAPES[shape_name], m, cohort=cohort)
        ts = sh.input_specs(tcfg, shape, m, cohort=cohort)
        assert (ts.kind, ts.n_participants) == (js.kind, js.n_participants)
        assert set(ts.args) == set(js.args)
        for name in js.args:
            jl = _jpaths(js.args[name])
            tl = _tpaths(ts.args[name]) if isinstance(ts.args[name], (dict, list)) \
                else {"": ts.args[name]}
            assert set(jl) == set(tl), name
            for path, leaf in jl.items():
                assert tuple(tl[path].shape) == tuple(leaf.shape), (name, path)
                assert _dtype(tl[path].dtype) == str(leaf.dtype), (name, path)
            jspec = _jpaths(js.arg_specs[name], is_leaf=_is_p)
            tspec = _tpaths(ts.arg_specs[name]) if not isinstance(
                ts.arg_specs[name], sh.PartitionSpec) else {"": ts.arg_specs[name]}
            assert {p: tuple(s) for p, s in tspec.items()} == \
                {p: tuple(s) for p, s in jspec.items()}, name
            assert sh.shard_bytes(ts.args[name], ts.arg_specs[name], m) == \
                _jbytes(js.args[name], js.arg_specs[name], m), name


def test_mesh_helpers():
    assert mesh_shape(False) == ((16, 16), ("data", "model"))
    assert mesh_shape(True) == ((2, 16, 16), ("pod", "data", "model"))
    assert batch_axes(MESHES["pod"]) == ("data",)
    assert batch_axes(MESHES["multipod"]) == ("pod", "data")
    sizes = axis_sizes(MESHES["multipod"])
    assert sh.shard_shape((64, 30, 7), sh.P(("pod", "data"), "model", None),
                          sizes) == (2, 2, 7)


def _run(code: str, timeout: int = 300):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_placements_give_the_shard_shapes():
    """DTensors distributed by ``placements`` on a fake 2 x 16 x 16 group
    hold rank 0's shard of the shape ``shard_shape`` gives."""
    code = """
import torch, torch.distributed as dist
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import fake_group, make_production_mesh, axis_sizes
with fake_group(512):
    mesh = make_production_mesh(multi_pod=True)
    sizes = axis_sizes(mesh)
    for shape, spec in [((64, 48, 32), sh.P(("pod", "data"), "model", None)),
                        ((96, 32), sh.P(None, "model")),
                        ((30, 20), sh.P("data", None)),
                        ((8,), sh.P(None))]:
        t = sh.distribute({"x": torch.empty(shape, device="meta")},
                          {"x": spec}, mesh)["x"]
        assert tuple(t.to_local().shape) == sh.shard_shape(shape, spec, sizes), (
            shape, spec, t.to_local().shape)
    try:
        with fake_group(4):
            raise SystemExit("a second group was allowed")
    except RuntimeError:
        pass
assert not dist.is_initialized()
print("ok")
"""
    assert _run(code).strip().endswith("ok")


def test_dryrun_reduced_config_on_a_fake_2x2_mesh(tmp_path):
    """The dry run's step on a REDUCED config on a fake (2, 2) mesh, in a
    subprocess: the three kinds and both train cohorts counted, records
    written, the group gone after each."""
    code = f"""
import json, dataclasses, torch.distributed as dist
from repro_torch.launch import dryrun, mesh
from repro_torch.configs import base, get_reduced
mesh.POD = ((2, 2), ("data", "model"))
dryrun.OUT_DIR = {str(tmp_path)!r}
dryrun.INPUT_SHAPES = {{
    "train_4k": base.InputShape("train_4k", 32, 4, "train"),
    "prefill_32k": base.InputShape("prefill_32k", 32, 4, "prefill"),
    "decode_32k": base.InputShape("decode_32k", 32, 4, "decode")}}
dryrun.get_config = lambda arch: get_reduced(arch)
recs = []
for shape, cohort in [("train_4k", "stream"), ("train_4k", "vmap"),
                      ("prefill_32k", "auto"), ("decode_32k", "auto")]:
    recs.append(dryrun.lower_one("internlm2-1.8b", shape, cohort=cohort,
                                 stream_participants=2, verbose=False))
    assert not dist.is_initialized()
print(json.dumps([{{k: r.get(k) for k in ("shape", "cohort", "step", "chips",
    "flops_per_chip", "bytes_per_chip", "collectives", "arg_bytes_per_chip",
    "model_flops", "n_rep", "depth_counted")}} for r in recs]))
"""
    recs = json.loads(_run(code, timeout=600).strip().splitlines()[-1])
    by = {(r["shape"], r["cohort"]): r for r in recs}
    assert len(recs) == len(by) == 4
    for key in [("train_4k", "stream"), ("train_4k", "vmap"),
                ("prefill_32k", "-"), ("decode_32k", "-")]:
        r = by[key]
        assert r["step"] == "counted" and r["chips"] == 4, r
        assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0
        assert r["arg_bytes_per_chip"]["total"] > r["arg_bytes_per_chip"]["params"]
        assert set(r["collectives"]) >= {"all-gather", "all-reduce",
                                         "reduce-scatter", "all-to-all"}
    # the stream step pins its gradients to the params' placements, the
    # vmap step all-reduces its fresh average and aggregate over "data"
    for cohort in ("stream", "vmap"):
        assert by[("train_4k", cohort)]["collectives"]["total"] > 0
    # the two train records share a file name: the vmap one is the last
    assert len(list(tmp_path.glob("*.json"))) == 3


def test_placed_train_step_equals_unplaced_on_one_rank():
    """``make_fl_train_step(param_specs=...)`` on a one-rank gloo (1, 1)
    mesh, params and batch as DTensors: new params and metrics bit for bit
    the unplaced step's, both cohorts."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import make_fl_train_step
    from repro_torch.models import init_params
    assert not dist.is_initialized()
    cfg = dataclasses.replace(get_reduced("internlm2-1.8b"),
                              param_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 2, 8), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    fresh = torch.tensor([True, False])
    tau = torch.tensor([0, 2], dtype=torch.int32)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh("cpu")
        specs = sh.param_pspecs(cfg, params, mesh)
        dparams = sh.distribute(params, specs, mesh)
        bspec = {k: sh.P(None, ("data",), None) for k in batch}
        dbatch = sh.distribute(batch, bspec, mesh)
        for cohort in ("vmap", "stream"):
            plain = make_fl_train_step(cfg, cohort=cohort)
            placed = make_fl_train_step(cfg, cohort=cohort, param_specs=specs)
            new_p, m_p = plain(params, batch, fresh, tau)
            new_d, m_d = placed(dparams, dbatch, fresh, tau)
            flat_p = _tpaths(new_p)
            for path, leaf in _tpaths(new_d).items():
                assert isinstance(leaf, DTensor)
                assert torch.equal(leaf.full_tensor(), flat_p[path]), path
            for k in ("loss", "weights"):
                v = m_d[k].full_tensor() if isinstance(m_d[k], DTensor) else m_d[k]
                assert torch.equal(v, m_p[k]), k
        with pytest.raises(TypeError, match="DTensor"):
            make_fl_train_step(cfg, param_specs=specs)(params, batch, fresh, tau)
    finally:
        dist.destroy_process_group()
