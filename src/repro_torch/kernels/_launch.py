"""The lean checked launch that every wrapper of the SAA and trimmed-mean
families (kernels 1-7) goes through.

``Checked`` memoises a wrapper's operand checks.  The checks (shapes,
types, contiguity, one device, 16-byte rows, the kernel's size limits, the
scaling rule and the variant) run in full the first time a signature of
operands is seen, and what they return (the plan: the device, None for the
CPU, and the sizes) is kept under that signature.  A later call whose
operands repeat it costs one signature and one dict lookup.  The signature
holds each tensor's shape, dtype, device, contiguity and whether it starts
on a 16-byte boundary, beside the wrapper's other checked arguments, so an
operand that changes any of them misses, is checked in full and raises as
before.  Only a check that passed is kept.

``CEntry`` binds a library's plain-C entry point at its first call, and
``launch`` calls it on the current stream of the operands' device (read as
a raw pointer, with no ``torch.cuda.Stream`` object), raises on a non-zero
return and counts the launch in ``LAUNCHES``, under the kernel's name and,
for a kernel with variants, under ``<name>:<variant>`` too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build

SEEN_LIMIT = 1024     # signatures a wrapper keeps; past it the memo starts over


def signature(tensors) -> tuple:
    """What a wrapper's checks read of each operand."""
    return tuple((t.shape, t.dtype, t.device, t.is_contiguous(),
                  t.data_ptr() % 16 == 0) for t in tensors)


class Checked:
    """``check(*tensors, *args)`` memoised by the operands' signature and
    ``args`` (hashable): it raises ``ValueError`` on bad operands, else
    returns the plan the wrapper launches by."""

    def __init__(self, check):
        self.check = check
        self.seen: dict = {}

    def __call__(self, tensors, *args):
        key = (signature(tensors), args)
        plan = self.seen.get(key)
        if plan is None:
            plan = self.check(*tensors, *args)
            if len(self.seen) >= SEEN_LIMIT:
                self.seen.clear()
            self.seen[key] = plan
        return plan


class CEntry:
    """Entry point ``name`` of library ``library``: ``n_ptr`` pointers,
    then ``n_int`` ints, then the stream; returns a CUDA error code."""

    def __init__(self, library: str, name: str, n_ptr: int, n_int: int):
        self.library, self.name = library, name
        self.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                         + [ctypes.c_void_p])
        self.fn = None

    def bind(self):
        if self.fn is None:
            fn = getattr(_build.library(self.library), self.name)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self.fn = fn
        return self.fn


def launch_key(kernel: str, variant: str) -> str:
    """The ``LAUNCHES`` key that counts ``kernel``'s launches of one
    variant."""
    return f"{kernel}:{variant}"


def launch(kernel: str, entry: CEntry, index: int, args, tag=None,
           errors=None) -> None:
    """Call ``entry`` with ``args`` (data pointers as ints, then ints) on
    the current stream of CUDA device ``index`` and count one launch of
    ``kernel`` (and of ``kernel:tag``).  The caller holds the tensors
    behind the pointers through the call; the caching allocator orders any
    reuse of their memory after the launch on this stream.  ``errors``
    names the entry point's own (negative) error codes."""
    fn = entry.fn or entry.bind()
    if torch._C._cuda_getDevice() == index:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        why = (errors or {}).get(err)
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}"
                           + (f": {why}" if why else ""))
    LAUNCHES[kernel] += 1
    if tag is not None:
        LAUNCHES[launch_key(kernel, tag)] += 1
