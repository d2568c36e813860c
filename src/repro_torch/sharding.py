"""Logical-axis sharding rules (port of ``repro.sharding``).

Every parameter, cache and optimizer leaf carries a *logical* spec (a
tuple of logical axis names, ``()`` for a replicated leaf); ``resolve``
maps the names onto mesh axes through a rule table.  The two tables are
the reference's:

* ``FSDP_TP`` -- weights: matrix dims split (fsdp -> "data") x (tensor
  -> "model"); optimizer state inherits; batch over ("pod", "data").
* ``TP_ONLY`` -- serving: weights tensor-split only, batch over
  ("pod", "data").

``resolve`` keeps the reference's rules exactly: a name the table lacks
replicates, a composite rule drops the axes the mesh lacks (and
collapses to one name when one is left), and a single axis the mesh
lacks replicates.

In the reference these specs are hints that XLA's partitioner acts on.
Here one controller drives every entry of a mesh, so the paths that lay
tensors out do it by hand, each by its specs:

* the sequence-sharded decode cache (``transformer.init_cache(...,
  mesh=)``, ``cache_specs``: ``cache_seq`` -> ``model``);
* the tensor-parallel serve path of the LMs (``transformer.place_params``
  by ``param_specs``: ``heads``, ``mlp``, ``vocab`` and ``experts`` ->
  ``model``; the residual stream by ``act_spec`` through
  :func:`shard_act`);
* FSDP training of the LM and DIEN train cells on arguments laid out by
  ``launch.steps``' ``place_args`` through ``FSDP_TP`` (``embed`` ->
  ``data`` too; each entry gathers its view of a layer, the gradients
  reduce-scattered: ``launch.mesh.ShardGrads``), the new parameters and
  AdamW state laid out as the arguments;
* the ZeRO optimizer state (``optimizer.place_state``, ``state_specs``);
* DIEN's row-sharded tables (``dien.place_params``: ``table_rows`` ->
  ``model``);
* the ring-partitioned Equiformer-v2 (``models.gnn.ring``: node blocks
  over ``data``, edge buckets over ``("data", "model")``).

``constraint`` and ``shard_act`` (inside :func:`activation_sharding`)
lay a tensor out by its spec (``launch.mesh.place``) when the spec names
an axis of the mesh, and return it unchanged where none applies: the
reference's ``with_sharding_constraint`` changes a layout, never a
value, and so does a layout here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping, Sequence

from repro_torch.launch.mesh import (Mesh, NamedSharding, PartitionSpec,
                                     Placed, gather, place)

# Rule tables: logical name -> mesh axis (or tuple, or None = replicate).
FSDP_TP: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",        # fsdp dimension of weight matrices
    "act_seq": "model",     # sequence-parallel residual stream
    "mlp": "model",
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "expert_embed": "data",
    "layers": None,
    "kv_lora": None,
    "cache_seq": "model",   # decode caches: sequence-sharded (flash decode)
    "nodes": None,
    "edges": ("data", "model"),
    "channels": "model",
    "qbatch": ("pod", "data"),
    "table_rows": "model",  # embedding tables row-sharded
    "feat": None,
    "ring_nodes": "data",   # ring-partitioned GNN node blocks
    "ring_cols": "model",   # ring bucket model columns
}

TP_ONLY = dict(FSDP_TP, embed=None, expert_embed=None)


def drop_pod(rules: Mapping[str, Any]) -> dict[str, Any]:
    """Single-pod variant: the "pod" axis dropped from composite rules."""
    out = {}
    for k, v in rules.items():
        if isinstance(v, tuple):
            v = tuple(a for a in v if a != "pod")
            v = v[0] if len(v) == 1 else (v or None)
        out[k] = v
    return out


def is_spec(x) -> bool:
    """A logical spec leaf: ``None`` or a plain tuple of names and
    ``None`` (``()`` included); a named tuple is a node of the tree."""
    return x is None or (isinstance(x, tuple) and not hasattr(x, "_fields")
                         and all(isinstance(e, (str, type(None)))
                                 for e in x))


def map_specs(fn: Callable, specs):
    """``fn`` over every spec leaf of ``specs`` (dicts, lists, tuples,
    named tuples and dataclasses such as ``GraphBatch``), rebuilt in the
    same structure.  A dataclass field holding an ``int`` (``n_node``,
    ``n_graph``: the reference's ``static=True`` fields) is kept as it
    is."""
    if is_spec(specs):
        return fn(specs)
    if dataclasses.is_dataclass(specs) and not isinstance(specs, type):
        return dataclasses.replace(specs, **{
            f.name: map_specs(fn, getattr(specs, f.name))
            for f in dataclasses.fields(specs)
            if not isinstance(getattr(specs, f.name), int)})
    if isinstance(specs, dict):
        return {k: map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, v) for v in specs))
    if isinstance(specs, (list, tuple)):
        return type(specs)(map_specs(fn, v) for v in specs)
    raise TypeError(f"not a spec tree: {specs!r}")


def resolve(spec: Sequence[str | None] | None, rules: Mapping[str, Any],
            mesh: Mesh) -> NamedSharding:
    """Logical spec tuple -> :class:`NamedSharding` on ``mesh``."""
    if spec is None:
        return NamedSharding(mesh, PartitionSpec())
    axes = []
    for name in spec:
        if name is None:
            axes.append(None)
            continue
        axis = rules.get(name, None)
        if isinstance(axis, tuple):
            axis = tuple(a for a in axis if a in mesh.axis_names) or None
            if axis is not None and len(axis) == 1:
                axis = axis[0]
        elif axis is not None and axis not in mesh.axis_names:
            axis = None
        axes.append(axis)
    return NamedSharding(mesh, PartitionSpec(*axes))


def resolve_tree(specs, rules: Mapping[str, Any], mesh: Mesh):
    """A tree of logical specs -> the same tree of NamedShardings."""
    return map_specs(lambda s: resolve(s, rules, mesh), specs)


def constraint(x, spec, rules: Mapping[str, Any], mesh: Mesh):
    """The reference's ``with_sharding_constraint`` through the table:
    ``x`` (a tensor or a :class:`Placed`) laid out by the resolved spec
    when it names a mesh axis, else returned as it is (module doc).  A
    placed ``x`` already in that layout is returned as it is; in
    another, it is gathered and placed anew."""
    sharding = resolve(spec, rules, mesh)
    if not any(sharding.spec):
        return x
    if isinstance(x, Placed):
        if x.sharding == sharding:
            return x
        x = gather(x)
    return place(x, sharding)


# -------------------------------------------------------------------------
# Activation-sharding context: model code may call ``shard_act(x, spec)``
# unconditionally; the launch layer activates the (rules, mesh) pair for
# the duration of a call.  Outside the context it is the identity; inside
# it is :func:`constraint` under the active pair.
# -------------------------------------------------------------------------
_ACT_CTX: list = []


@contextlib.contextmanager
def activation_sharding(rules: Mapping[str, Any], mesh: Mesh):
    _ACT_CTX.append((rules, mesh))
    try:
        yield
    finally:
        _ACT_CTX.pop()


def active_rules():
    """The rule table of the innermost :func:`activation_sharding`
    context, or ``None`` outside every context."""
    return _ACT_CTX[-1][0] if _ACT_CTX else None


def shard_act(x, spec):
    """Lay an activation out by a logical spec (module doc); the
    identity outside the context."""
    if not _ACT_CTX:
        return x
    rules, mesh = _ACT_CTX[-1]
    return constraint(x, spec, rules, mesh)


def wrap_with_activation_sharding(fn, rules, mesh):
    def wrapped(*args, **kwargs):
        with activation_sharding(rules, mesh):
            return fn(*args, **kwargs)
    return wrapped


__all__ = ["FSDP_TP", "TP_ONLY", "activation_sharding", "active_rules",
           "constraint",
           "drop_pod", "is_spec", "map_specs", "resolve", "resolve_tree",
           "shard_act", "wrap_with_activation_sharding"]
