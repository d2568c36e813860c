"""What a dry run counts, op by op and collective by collective: the
counterpart of ``src/repro/launch/hlo.py``.

The reference parses the optimized HLO of a compiled program and
estimates each collective's wire bytes by the ring algorithm.  Here
there is no HLO to parse: the port's step runs eagerly, one controller
driving every mesh entry, and its collectives are the functions of
``launch.mesh`` that move tensors from entry to entry (``place``,
``gather``, ``psum``, ``all_gather``, ``gather_entry``,
``reduce_scatter``) and the moves the ring and the sequence-sharded
decode's merge make themselves.  Each charges what it moves to the
active ``launch.mesh.Tally``, by source and destination entry, so
:func:`collective_stats` counts what the port's code actually moves:
``psum`` of ``k`` parts brings ``k - 1`` of them into one entry, where
a ring all-reduce would move ``2 (k - 1) / k`` of the result through
every entry.  :func:`ring_wire_bytes` gives the reference's ring
estimate (the table of ``hlo.py``) for the same logical collective, so
the two can be read side by side:

  op                  wire bytes per device (k = participant group size)
  ------------------  --------------------------------------------------
  all-gather          result * (k - 1) / k          (receives all shards)
  all-reduce          2 * result * (k - 1) / k      (RS + AG ring)
  reduce-scatter      result * (k - 1)              (operand = k * result)
  all-to-all          result * (k - 1) / k
  collective-permute  result                        (one hop)

Every other op is counted by :class:`Counting`, a ``TorchDispatchMode``:
its FLOPs by ``torch.utils.flop_counter``'s formulas (those of
``FlopCounterMode``: matrix products and convolutions; elementwise ops
count nothing there, and here), its bytes as its inputs read and its
outputs written (views and allocations move none; an op writing into an
argument, a scatter into a cache, moves its other inputs' bytes, not the
whole argument: ``_op_bytes``), and the tensors it
makes as live on the working entries until freed (their peak is a dry
run's temp memory).  A kernel of the port charges its own cost instead
of its ops (``launch.mesh.kernel_cost``: flash_decode by
``kernels.flash_decode.kernel.cost``).  The backward of an op made
inside an entry's work is that entry's work too: :class:`Counting` tags
each autograd node made there, and the node enters the work when the
engine runs it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import mesh as M

#: Queries of a tensor's layout: neither work nor a tensor made.
_QUERIES = {torch.ops.aten.sym_is_contiguous.default,
            torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default, torch.ops.prim.layout.default,
            torch.ops.prim.device.default}

#: Ops that allocate and write nothing a step reads.
_ALLOCATIONS = {"aten.empty", "aten.empty_like", "aten.empty_strided",
                "aten.new_empty", "aten.new_empty_strided"}


@functools.lru_cache(maxsize=None)
def _aliases(func) -> tuple:
    """Per output of ``func``: whether it aliases an input (a view, an
    in-place or ``out=`` op)."""
    return tuple(r.alias_info is not None for r in func._schema.returns)


def _on_host(tree) -> bool:
    """Whether an op reads only host tensors (and at least one): host
    work, or a copy of a host constant to the device."""
    ts = [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]
    return bool(ts) and all(x.device.type == "cpu" for x in ts)


@functools.lru_cache(maxsize=None)
def _written(func) -> tuple:
    """The names of the arguments ``func`` writes into (in place, or
    ``out=``)."""
    return tuple(a.name for a in func._schema.arguments
                 if a.alias_info is not None and a.alias_info.is_write)


def _op_bytes(func, name: str, args, kwargs, outs) -> int:
    """An op's bytes: its inputs read and its outputs written; a view or
    an allocation none; an op that writes into an argument (a scatter
    into a cache, ``copy_``, an in-place add) reads its other inputs and
    writes as many bytes as they hold (all of the argument where they
    hold none), not the whole argument it writes into."""
    if func.is_view or name in _ALLOCATIONS:
        return 0
    into = _written(func)
    if not into:
        return _nbytes((args, kwargs)) + _nbytes(outs)
    named = dict(zip((a.name for a in func._schema.arguments), args))
    named.update(kwargs)
    written = _nbytes([v for k, v in named.items() if k in into])
    read = _nbytes([v for k, v in named.items() if k not in into])
    return 2 * written if not read else read + min(read, written)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_flatten(tree)[0]
               if isinstance(x, torch.Tensor))


class Counting(TorchDispatchMode):
    """Each aten op's FLOPs and bytes charged to the working entries of
    the active tally, and the tensors it makes tracked (module doc)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        t = M._TALLY
        packet = func._overloadpacket
        if packet not in flop_registry and not t.quiet:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not t.quiet and not (t.host_skip and _on_host((args, kwargs))):
            name = str(packet)
            flops = flop_registry[packet](*args, **kwargs, out_val=out) \
                if packet in flop_registry else 0
            t.charge(name, flops, _op_bytes(func, name, args, kwargs, outs))
        aliases = _aliases(func)
        for i, x in enumerate(outs):
            if isinstance(x, torch.Tensor):
                t.made(x, fresh=not (aliases[i] if i < len(aliases)
                                     else False))
        return out


class _Tagging(TorchFunctionMode):
    """Tags each autograd node made inside an entry's work, so that the
    engine runs its backward as that work (:class:`Counting`): every node
    between a call's outputs and its inputs' nodes (a composite call such
    as ``matmul`` makes several).  A call that returns one of its inputs
    (``.to`` a tensor's own device, an in-place op) tags nothing."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        t = M._TALLY
        if t.work is t.base or not torch.is_grad_enabled():
            return out
        ins = [x for x in tree_flatten((args, kwargs))[0]
               if isinstance(x, torch.Tensor)]
        stop = {id(x.grad_fn) for x in ins if x.grad_fn is not None}
        seen = {id(x) for x in ins}
        todo = [x.grad_fn for x in (out if isinstance(out, (tuple, list))
                                    else (out,))
                if isinstance(x, torch.Tensor) and id(x) not in seen and
                x.grad_fn is not None]
        while todo:
            node = todo.pop()
            if id(node) in stop or type(node).__name__ == "AccumulateGrad":
                continue
            stop.add(id(node))
            node.register_prehook(functools.partial(_enter, t, t.work))
            node.register_hook(functools.partial(_leave, t))
            todo.extend(n for n, _ in node.next_functions if n is not None)
        return out


def _enter(t, work, grad_outputs):
    t.stack.append(t.work)
    t.work = work


def _leave(t, grad_inputs, grad_outputs):
    t.work = t.stack.pop()


class counted:
    """``with counted(n, device) as tally:`` every op of the block counted
    on a :class:`launch.mesh.Tally` of ``n`` entries (module doc;
    ``alike`` as ``launch.mesh.counting`` takes it).  A step on another
    device than the CPU (``device``: the meta device, a card) counts no
    op that reads only host tensors: host work, or a host constant
    copied to the device once."""

    def __init__(self, n: int, device="meta", alike: bool = False) -> None:
        self.n, self.alike = n, alike
        self.host = torch.device(device).type != "cpu"

    def __enter__(self) -> "M.Tally":
        self._ctx = M.counting(self.n, self.alike, self.host)
        tally = self._ctx.__enter__()
        self._modes = (_Tagging(), Counting())
        for m in self._modes:
            m.__enter__()
        return tally

    def __exit__(self, *exc) -> None:
        for m in reversed(self._modes):
            m.__exit__(*exc)
        self._ctx.__exit__(*exc)


@dataclasses.dataclass
class CollectiveStats:
    """The reference's fields, from what the port's collectives moved:
    ``wire_bytes`` the largest entry's bytes in, or out where larger;
    ``result_bytes`` every byte moved between two entries; ``counts``
    calls by op; ``by_op_bytes`` by op, the largest entry's bytes in or
    out."""
    wire_bytes: float = 0.0
    result_bytes: float = 0.0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    by_op_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)


def collective_stats(tally: "M.Tally") -> CollectiveStats:
    stats = CollectiveStats(counts=dict(tally.calls))
    into, out = np.zeros(tally.n), np.zeros(tally.n)
    for op, (i, o) in sorted(tally.moved.items()):
        into += i
        out += o
        stats.by_op_bytes[op] = float(np.maximum(i, o).max())
    stats.wire_bytes = float(np.maximum(into, out).max())
    stats.result_bytes = float(into.sum())
    return stats


def collective_seconds(tally: "M.Tally") -> float:
    """The least time the largest entry's traffic takes: bytes within a
    node over NVLink, bytes between nodes over its NIC, each way at its
    own rate, the two links at once."""
    (ni, no), (wi, wo) = tally.link["nvlink"], tally.link["net"]
    per_entry = np.maximum(np.maximum(ni, no) / M.NVLINK_BW,
                           np.maximum(wi, wo) / M.NET_BW)
    return float(per_entry.max())


#: The reference's collective each port collective stands for.
RING_KIND = {"psum": "all-reduce", "all_gather": "all-gather",
             "gather": "all-gather", "gather_entry": "all-gather",
             "reduce_scatter": "reduce-scatter", "place": "all-to-all",
             "merge": "all-gather", "ring": "collective-permute",
             "dispatch": "all-to-all", "pmax": "all-reduce",
             "pmin": "all-reduce"}


def ring_wire_bytes(op: str, result_bytes: float, k: int) -> float:
    """The reference's ring-algorithm wire bytes a device (module doc)
    for collective ``op`` (an HLO name, or a port op of
    :data:`RING_KIND`) over ``k`` participants with a result of
    ``result_bytes``."""
    kind = RING_KIND.get(op, op)
    if k <= 1:
        return 0.0
    if kind == "all-gather":
        return result_bytes * (k - 1) / k
    if kind == "all-reduce":
        return 2.0 * result_bytes * (k - 1) / k
    if kind == "reduce-scatter":
        return float(result_bytes) * (k - 1)
    if kind == "all-to-all":
        return result_bytes * (k - 1) / k
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {op!r}")


def count_ops(tally: "M.Tally") -> Dict[str, int]:
    """Aten ops by name, and the port's kernels' launches (``flash_decode``),
    summed over the entries."""
    return dict(sorted(tally.ops.items(), key=lambda kv: -kv[1]))


__all__ = ["CollectiveStats", "Counting", "RING_KIND", "collective_seconds",
           "collective_stats", "count_ops", "counted", "ring_wire_bytes"]
