"""A step's FLOPs, bytes and collective bytes, counted from torch's
dispatch: the port's counterpart of ``repro.roofline.hlo_cost`` (which
walks XLA's compiled HLO text, of which eager torch has none) and of
``repro.roofline.analysis.collective_bytes_from_hlo``.

``CostCounter`` is a ``TorchDispatchMode``: every aten op that reaches the
dispatcher inside it is counted once, with

  - flops: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention; other ops count none, as they weigh little beside them);
  - bytes: every tensor operand plus every result of the op (views,
    other aliasing ops and allocations move nothing and count none).  Eager torch does not
    fuse, so this is an upper bound: XLA's count leaves out what stays
    inside a fusion, which here goes through memory between two ops;
  - collective bytes by kind (all-gather, all-reduce, reduce-scatter,
    all-to-all): the result bytes of each c10d op, functional
    (``_c10d_functional``, as DTensor's redistributions emit them) or
    in-place (``c10d``, as ``torch.distributed`` calls emit them); they
    also count as bytes, as in the reference.

On a DTensor step the mode lets DTensor run first (it returns
``NotImplemented`` for DTensor ops, as ``CommDebugMode`` does) and counts
the local shards' ops and the redistributions DTensor runs, so every
number is one chip's share, as the reference's per-chip SPMD program is.  The
tensors may be ``meta`` tensors: nothing is computed, and a full-width
step is counted on a host without the memory to run it.

A hand-written kernel's launch is a ctypes call the dispatcher never sees:
``add`` puts in its work (``analysis.swa_cost`` / ``wkv_cost``).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all")

# op name (without namespace and overload) -> collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out":
    "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_reduce": "all-reduce",
    "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
}


# ops that move no data: reshapes that return an alias, allocations, waits
_FREE = {"_unsafe_view", "wait_tensor", "_wrap_tensor_autograd", "empty",
         "empty_strided", "empty_like", "new_empty", "new_empty_strided"}


def _tensors(x):
    """The tensors in ``x``, an op's arguments or results (tensors, lists
    and tuples of them, dicts, scalars)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it (see the module docstring).
    ``totals()`` gives {"flops", "bytes", "coll_<kind>", "coll_total"}
    and ``by_op`` the flops and bytes of each op name."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
        self.by_op = defaultdict(lambda: [0.0, 0.0])

    def add(self, flops: float = 0.0, nbytes: float = 0.0,
            name: str = "kernel") -> None:
        """Count work the dispatcher does not see (a kernel launch)."""
        self.flops += flops
        self.bytes += nbytes
        self.by_op[name][0] += flops
        self.by_op[name][1] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor run first: it desugars into the local shards' ops
            # and its redistributions, which come back here to be counted
            return NotImplemented
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        if any(isinstance(t, FakeTensor) for t in ins):
            # DTensor's shape inference on the global shapes, not the step
            return out
        name = func._schema.name.split("::")[-1]
        kind = _COLLECTIVES.get(name)
        if kind is not None:
            moved = _nbytes(_tensors(out))
            self.coll[kind] += moved
            self.add(0.0, moved, name)
            return out
        if func.is_view or name in _FREE:
            return out
        packet = func._overloadpacket
        flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                 if packet in flop_registry else 0)
        self.add(float(flops), _nbytes(ins) + _nbytes(_tensors(out)), name)
        return out

    def totals(self) -> dict:
        out = {"flops": self.flops, "bytes": self.bytes}
        out.update({f"coll_{k}": v for k, v in self.coll.items()})
        out["coll_total"] = sum(self.coll.values())
        return out
