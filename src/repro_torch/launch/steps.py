"""Step bundles (port of ``repro.launch.steps``): one (step fn, abstract
inputs, logical sharding specs) triple per (architecture x input shape)
cell.

The same builders serve the smoke runs (small real tensors through the
step) and the full-size cells, which are built abstractly: every leaf of
``abstract_args`` is a tensor on the meta device, of the shape and
dtype of the reference's ``jax.ShapeDtypeStruct`` (``jax.eval_shape``
there, the models' own initialisers on ``device="meta"`` here, which
draw nothing), so a full-size bundle allocates nothing.  ``arg_specs``
are the reference's logical spec trees (``repro_torch.sharding``).

``model_flops`` is the *useful-work* term a share of the peak divides
by, the reference's formulas to the float:
  LM      6 * N_active * tokens  (+ 12 * L * H * dh * T^2 * B attention)
  GNN     documented per-family op counts
  recsys  dominated by GRU/AUGRU matmuls: 2 * 6 * H * (D + H) * T * B
  dspc    op-count proxy (label-merge ops); flagged in ``notes``

Where the port's trees differ from the reference's:

* the GNNs are ``nn.Module``s: their parameters (and AdamW moments) are
  the module's ``named_parameters()`` by name, replicated (``()``); the
  step puts them into a module of the bundle built on the parameters'
  device (``torch.func.functional_call``), whose buffers (CG tables,
  index maps) are its own.  On arguments laid out by ``place_args``
  (``FSDP_TP``: the edges over ``("data", "model")``, the labels of the
  sampled and molecule cells over ``data``) the step is edge-sharded
  (:meth:`GNNModules.call`); its losses add each label block's terms
  where the block lies, the blocks in order, and divide by the whole
  count;
* ``GraphBatch`` indexes with int64 (``graph.batch_spec``);
* the DSPC ``Graph`` keeps ``m2`` as a host int: the abstract graph
  carries ``2 * m``, the high-water mark ``from_edges`` gives a graph of
  the shape's ``m`` edges, and its spec stays ``()``.

:func:`load_reference_args` carries the reference's ``make_host_args``
output (as numpy) into the port's trees; :func:`make_host_args` draws
the port's own (parameters from a seeded ``torch.Generator``, data from
the port's numpy pipelines, which equal the reference's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.func
from torch import nn

from repro_torch import sharding as SH
from repro_torch.configs import get as get_arch
from repro_torch.configs.common import ArchSpec, ShapeSpec
from repro_torch.core.graph import resolve_device
from repro_torch.launch.mesh import (Placed, map_tree, entry_view, gather,
                                     local_tree, place_tree, psum)
from repro_torch.models import dien as dien_mod
from repro_torch.models import transformer as tf
from repro_torch.models.common import cross_entropy_terms, load_tree
from repro_torch.models.gnn.egnn import EGNN
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2
from repro_torch.models.gnn.graph import (EdgeShards, GraphBatch, ModuleCall,
                                          batch_spec, replicated_specs)
from repro_torch.models.gnn.nequip import NequIP
from repro_torch.models.gnn.pna import PNA
from repro_torch.models.gnn.sampler import sample_block_caps
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import make_train_step_fn


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Optional[Callable]            # mesh-independent step
    mesh_fn: Optional[Callable]       # mesh -> step (the mesh paths)
    abstract_args: tuple              # trees of tensors on the meta device
    arg_specs: tuple                  # logical sharding spec trees
    model_flops: float
    notes: str = ""

    def get_fn(self, mesh=None, rules=None):
        """The step: ``mesh_fn(mesh)`` where the cell needs a mesh, else
        ``fn``, run inside ``sharding.activation_sharding(rules, mesh)``
        when both are given.  Given arguments laid out by
        :meth:`place_args`, an LM prefill or decode cell runs the
        tensor-parallel serve path (``TP_ONLY``; ``models.transformer``),
        an LM or DIEN train cell the FSDP step (``FSDP_TP``;
        ``train.loop``) and a GNN train cell the edge-sharded step
        (:meth:`GNNModules.call`), each of which returns the new
        parameters and state laid out as its arguments; whole arguments
        run the one-device step."""
        if self.mesh_fn is not None:
            if mesh is None:
                raise ValueError(f"{self.name} needs a mesh")
            return self.mesh_fn(mesh)
        if mesh is not None and rules is not None:
            return SH.wrap_with_activation_sharding(self.fn, rules, mesh)
        return self.fn

    def place_args(self, args: tuple, mesh, rules) -> tuple:
        """``args`` laid out over ``mesh`` by :attr:`arg_specs` through
        ``rules`` (``launch.mesh.place_tree``; a dimension split unevenly
        raises)."""
        return tuple(place_tree(a, SH.resolve_tree(sp, rules, mesh), sp)
                     for a, sp in zip(args, self.arg_specs))


_OPT = opt.AdamWConfig()


def _whole(x):
    """A small argument whole on its first entry's device (tokens,
    lengths), as the model code takes it."""
    return gather(x) if isinstance(x, Placed) else x


def _whole_tree(tree):
    """``tree`` with each placed leaf gathered whole (:func:`_whole`)."""
    return map_tree(lambda _, x: _whole(x), tree)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


# ==========================================================================
# LM family
# ==========================================================================
def _lm_flops(cfg: tf.TransformerConfig, tokens: int, seq: int,
              train: bool) -> float:
    mult = 6 if train else 2
    dense = mult * cfg.active_param_count() * tokens
    attn = mult * 2 * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * tokens
    return float(dense + attn)


def _lm_batch_struct(b, t):
    return {"tokens": _meta((b, t), torch.int32),
            "labels": _meta((b, t), torch.int32)}


def _lm_batch_spec():
    return {"tokens": ("batch", None), "labels": ("batch", None)}


def lm_bundle(spec: ArchSpec, shape: ShapeSpec, smoke: bool) -> StepBundle:
    cfg: tf.TransformerConfig = spec.smoke if smoke else spec.config
    dims = dict(shape.dims)
    if smoke:
        dims["seq_len"] = 16
        dims["global_batch"] = 2
    b, t = dims["global_batch"], dims["seq_len"]
    params_a = tf.init_params(cfg, device="meta")
    p_specs = tf.param_specs(cfg)
    name = f"{spec.arch_id}/{shape.name}"

    if shape.kind == "train":
        step = make_train_step_fn(tf.make_train_loss(cfg), _OPT)
        return StepBundle(
            name=name, fn=step, mesh_fn=None,
            abstract_args=(params_a, opt.init(params_a, _OPT),
                           _lm_batch_struct(b, t)),
            arg_specs=(p_specs, opt.state_specs(p_specs), _lm_batch_spec()),
            model_flops=_lm_flops(cfg, b * t, t, train=True))

    if shape.kind == "prefill":
        s_max = t

        def prefill(params, tokens):
            return tf.prefill(params, _whole(tokens), cfg, s_max)

        return StepBundle(
            name=name, fn=prefill, mesh_fn=None,
            abstract_args=(params_a, _meta((b, t), torch.int32)),
            arg_specs=(p_specs, ("batch", None)),
            model_flops=_lm_flops(cfg, b * t, t, train=False))

    if shape.kind == "decode":
        s_max = t

        def decode(params, cache, token):
            cache = dict(cache, lengths=_whole(cache["lengths"]))
            return tf.decode_step(params, cache, _whole(token), cfg)

        # one token per sequence; cache attention reads the whole window
        flops = (2 * cfg.active_param_count() * b
                 + 2 * 2 * cfg.n_layers * cfg.n_heads * cfg.d_head * t * b)
        return StepBundle(
            name=name, fn=decode, mesh_fn=None,
            abstract_args=(params_a, tf.abstract_cache(cfg, b, s_max),
                           _meta((b,), torch.int32)),
            arg_specs=(p_specs, tf.cache_specs(cfg), ("batch",)),
            model_flops=float(flops))

    raise ValueError(shape.kind)


def lm_host_args(spec: ArchSpec, shape: ShapeSpec, seed: int = 0, *,
                 device="cuda"):
    """Small real tensors for the smoke path (the abstract trees'
    structure): the reference's token draws, parameters from a
    ``torch.Generator`` seeded ``seed`` on ``device``."""
    cfg: tf.TransformerConfig = spec.smoke
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    b, t = 2, 16
    params = tf.init_params(cfg, generator=_generator(seed, dev), device=dev)

    def ids(shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab, shape).astype(
            np.int32)).to(dev)

    if shape.kind == "train":
        batch = {"tokens": ids((b, t)), "labels": ids((b, t))}
        return (params, opt.init(params, _OPT), batch)
    if shape.kind == "prefill":
        return (params, ids((b, t)))
    if shape.kind == "decode":
        cache = tf.init_cache(cfg, b, t, device=dev)
        cache["lengths"] = torch.full((b,), t // 2, dtype=torch.int32,
                                      device=dev)
        return (params, cache, ids((b,)))
    raise ValueError(shape.kind)


# ==========================================================================
# GNN family
# ==========================================================================
_GNN_MODULES = {"egnn": EGNN, "pna": PNA, "nequip": NequIP,
                "equiformer-v2": EquiformerV2}


def _gnn_needs_pos(arch_id: str) -> bool:
    return arch_id != "pna"


def _gnn_adapt(cfg, d_feat: int, n_out: int):
    return dataclasses.replace(cfg, d_in=d_feat, n_out=n_out)


def _gnn_flops(arch_id, cfg, n_edges, n_nodes) -> float:
    """Useful-op estimates (messages + updates), documented per family."""
    if arch_id == "egnn":
        per_edge = 2 * (2 * cfg.d_hidden + 1) * cfg.d_hidden * 2
        per_node = 2 * 2 * cfg.d_hidden * cfg.d_hidden * 2
    elif arch_id == "pna":
        per_edge = 2 * 2 * cfg.d_hidden * cfg.d_hidden
        per_node = 2 * 13 * cfg.d_hidden * cfg.d_hidden
    elif arch_id == "nequip":
        n_paths = len(cfg.paths)
        per_edge = (2 * cfg.n_rbf * cfg.radial_hidden
                    + 2 * cfg.radial_hidden * n_paths * cfg.d_hidden
                    + n_paths * cfg.d_hidden * 27 * 2)
        per_node = 2 * (cfg.l_max + 1) * cfg.d_hidden ** 2 * 9
    else:  # equiformer-v2
        c, lmax = cfg.d_hidden, cfg.l_max
        n_m0 = (lmax + 1) * c
        so2 = 2 * (2 * n_m0 + cfg.n_rbf) * n_m0
        for m in range(1, cfg.m_max + 1):
            nm = cfg.n_l(m) * c
            so2 += 2 * 4 * (2 * nm) * nm
        wig = sum((2 * l + 1) ** 2 for l in range(lmax + 1)) * c * 2 * 2
        per_edge = so2 + wig
        per_node = 2 * (lmax + 1) * c * c * 2
    layers = cfg.n_layers
    return float(layers * (per_edge * n_edges + per_node * n_nodes))


def _gnn_batch_specs(batch_a: GraphBatch) -> GraphBatch:
    return GraphBatch(
        nodes=(), senders=("edges",), receivers=("edges",),
        pos=None if batch_a.pos is None else (),
        graph_id=(), n_node=batch_a.n_node, n_graph=batch_a.n_graph)


class _Method(nn.Module):
    """``model.<method>`` as a module's ``forward``, so that
    ``functional_call`` can swap the model's parameters in for it."""

    def __init__(self, model: nn.Module, method: str) -> None:
        super().__init__()
        self.m = model
        self.method = method

    def forward(self, *args):
        return getattr(self.m, self.method)(*args)


class GNNModules:
    """The GNN module of one bundle, built once for each device the
    step's parameters lie on; :meth:`call` runs one of its methods with
    a parameter dict (by ``named_parameters()`` name) in place of its
    own (``torch.func.functional_call``: autograd sees the dict's
    tensors)."""

    def __init__(self, cls, cfg) -> None:
        self.cls, self.cfg = cls, cfg
        self._built: dict = {}

    def on(self, device) -> nn.Module:
        dev = torch.device(device)
        if dev not in self._built:
            self._built[dev] = self.cls(self.cfg, device=dev)
        return self._built[dev]

    def call(self, params: dict, method: str, batch: GraphBatch):
        """``method`` of the module on ``batch`` with ``params``; a batch
        laid out by ``place_args`` (its edges placed) runs edge-sharded:
        :meth:`call_sharded`."""
        if isinstance(batch.senders, Placed):
            return self.call_sharded(params, method, batch)
        model = self.on(next(iter(params.values())).device)
        return torch.func.functional_call(
            _Method(model, method), {f"m.{k}": v for k, v in params.items()},
            (batch,))

    def call_sharded(self, params: dict, method: str, batch: GraphBatch):
        """The edge-sharded forward (the reference's ``"edges": ("data",
        "model")``, nodes and parameters replicated): mesh entry ``e``
        runs the messages of its block of the edges
        (``graph.EdgeShards.placed``) with its own view of the edge
        weights (``launch.mesh.entry_view``, one a (leaf, entry), on the
        module built on its device); the shards' partial aggregates come
        together on the controller's device (entry 0's), where the node
        work runs once, on entry 0's view of every parameter, so that each
        leaf's gradient is the sum of its entries' views' gradients in
        entry order (``launch.mesh.ShardGrads`` under
        ``train.loop.value_and_grad``).  ``params`` must be placed on
        the batch's mesh."""
        mesh = batch.senders.sharding.mesh
        if not all(isinstance(p, Placed) and p.sharding.mesh == mesh
                   for p in params.values()):
            raise ValueError("an edge-sharded batch trains with every "
                             "parameter placed on its mesh (place_args)")
        model = self.on(mesh.devices.flat[0])
        paths = {id(m): name for name, m in model.named_modules()}
        views: dict = {}

        def view(entry: int, name: str) -> torch.Tensor:
            if (entry, name) not in views:
                views[entry, name] = entry_view(params[name], entry)
            return views[entry, name]

        def call_of(entry: int, device):
            if entry == 0:
                return None         # entry 0's views are the module's own

            def call(module, subs, fn, *args):
                path = paths[id(module)]
                tensors = {}
                for sub in subs:
                    pre = ".".join(x for x in (path, sub) if x) + "."
                    tensors.update({f"module.{sub}.{k[len(pre):]}":
                                    view(entry, k) for k in params
                                    if k.startswith(pre)})
                twin = self.on(device).get_submodule(path)
                return torch.func.functional_call(ModuleCall(twin, fn),
                                                  tensors, args)
            return call

        nodes, edges = EdgeShards.placed(batch, call_of)
        return torch.func.functional_call(
            _Method(model, method), {f"m.{k}": view(0, k) for k in params},
            (nodes, edges))


def _label_blocks(labels) -> list:
    """(lo, hi, block) of ``labels`` by rows where they lie: the whole
    tensor, or each block of a placed one on its first entry's device."""
    if isinstance(labels, Placed):
        return [(b[0][0], b[0][1], shard) for _, b, shard in labels.blocks]
    return [(0, labels.shape[0], labels)]


def _blocked_mean(terms, out: torch.Tensor, labels, count: int):
    """The mean of ``terms(out rows, label rows)`` over ``count`` terms:
    each label block's terms summed on its device, the blocks added in
    order in float32 on ``out``'s device (``launch.mesh.psum``)."""
    return psum([terms(out[lo:hi].to(lab.device), lab).sum()
                 for lo, hi, lab in _label_blocks(labels)],
                out.device) / count


def _gnn_setup(spec: ArchSpec, shape: ShapeSpec, smoke: bool) -> dict:
    """The cell's adapted config, graph capacities and loss, shared by
    the bundle, the host arguments and :func:`load_reference_args`."""
    arch = spec.arch_id
    dims = dict(shape.dims)
    if smoke:
        # reduced instances of the same kind
        if shape.kind == "sampled":
            dims.update(n_nodes=500, batch_nodes=8, fanout=(3, 2),
                        d_feat=12, n_classes=5)
        elif shape.kind == "molecule":
            dims.update(n_nodes=6, n_edges=10, batch=3, d_feat=4)
        else:
            dims.update(n_nodes=40, n_edges=120, d_feat=12, n_classes=5)
    cfg = spec.smoke if smoke else spec.config
    if shape.kind in ("full_graph", "sampled"):
        cfg = _gnn_adapt(cfg, dims["d_feat"], dims["n_classes"])
        if shape.kind == "sampled":
            n_node, n_edge = sample_block_caps(dims["batch_nodes"],
                                               dims["fanout"])
            n_tgt = dims["batch_nodes"]
        else:
            n_node, n_edge = dims["n_nodes"], dims["n_edges"]
            n_tgt = None
        # pad the edge capacity so it divides any production mesh axis
        # combination (padded slots relax into the dump row)
        n_edge = -(-n_edge // 512) * 512
        modules = GNNModules(_GNN_MODULES[arch], cfg)
        method = "forward" if arch == "pna" else "node_forward"

        def loss_fn(params, batch_and_labels):
            batch, labels = batch_and_labels
            logits = modules.call(params, method, batch)
            if n_tgt is not None:
                logits = logits[:n_tgt]
            return _blocked_mean(cross_entropy_terms, logits, labels,
                                 logits.shape[0])

        labels_a = _meta((n_tgt if n_tgt else n_node,), torch.int32)
        labels_spec = ("batch",) if n_tgt else ()
        n_graph = 1
    elif shape.kind == "molecule":
        cfg = _gnn_adapt(cfg, dims["d_feat"], 1)
        n_graph = dims["batch"]
        n_node = dims["n_nodes"] * n_graph
        n_edge = dims["n_edges"] * n_graph
        if arch == "pna":        # graph readout, as the reference's loss
            cfg = dataclasses.replace(cfg, node_level=False)
        modules = GNNModules(_GNN_MODULES[arch], cfg)

        def loss_fn(params, batch_and_target):
            batch, target = batch_and_target
            out = modules.call(params, "forward", batch)
            g = out if arch == "pna" else out[0]
            return _blocked_mean(lambda x, t: (x - t) ** 2, g, target,
                                 g.numel())

        labels_a = _meta((n_graph, 1), torch.float32)
        labels_spec = ("batch", None)
    else:
        raise ValueError(shape.kind)
    batch_a = batch_spec(n_node, n_edge, dims["d_feat"],
                         with_pos=_gnn_needs_pos(arch), n_graph=n_graph)
    return dict(cfg=cfg, modules=modules, loss_fn=loss_fn, batch_a=batch_a,
                labels_a=labels_a, labels_spec=labels_spec, n_node=n_node,
                n_edge=n_edge)


def _named_params(model: nn.Module) -> dict:
    return {k: p.detach() for k, p in model.named_parameters()}


def gnn_bundle(spec: ArchSpec, shape: ShapeSpec, smoke: bool) -> StepBundle:
    s = _gnn_setup(spec, shape, smoke)
    params_a = _named_params(s["modules"].on("meta"))
    p_specs = replicated_specs(s["modules"].on("meta"))
    return StepBundle(
        name=f"{spec.arch_id}/{shape.name}",
        fn=make_train_step_fn(s["loss_fn"], _OPT), mesh_fn=None,
        abstract_args=(params_a, opt.init(params_a, _OPT),
                       (s["batch_a"], s["labels_a"])),
        arg_specs=(p_specs, opt.state_specs(p_specs),
                   (_gnn_batch_specs(s["batch_a"]), s["labels_spec"])),
        model_flops=_gnn_flops(spec.arch_id, s["cfg"], s["n_edge"],
                               s["n_node"]))


def gnn_host_args(spec: ArchSpec, shape: ShapeSpec, seed: int = 0, *,
                  device="cuda"):
    """Small real graphs for the smoke path: the reference's numpy
    draws of the graph and labels, parameters from a ``torch.Generator``
    seeded ``seed``."""
    from repro_torch.models.gnn.graph import from_numpy
    dev = resolve_device(device)
    s = _gnn_setup(spec, shape, smoke=True)
    batch_a, labels_a = s["batch_a"], s["labels_a"]
    rng = np.random.default_rng(seed)
    n, e = batch_a.n_node, batch_a.senders.shape[0]
    d_feat = batch_a.nodes.shape[1]
    n_real_e = max(e // 2, 1)
    senders = rng.integers(0, n, n_real_e).astype(np.int32)
    receivers = rng.integers(0, n, n_real_e).astype(np.int32)
    keep = senders != receivers
    gid = None
    if batch_a.n_graph > 1:
        per = n // batch_a.n_graph
        gid = np.minimum(np.arange(n) // per,
                         batch_a.n_graph - 1).astype(np.int32)
        keep &= gid[senders] == gid[receivers]   # edges within one graph
    batch = from_numpy(
        rng.normal(size=(n, d_feat)).astype(np.float32),
        senders[keep], receivers[keep],
        pos=(rng.normal(size=(n, 3)).astype(np.float32)
             if batch_a.pos is not None else None),
        graph_id=gid, n_graph=batch_a.n_graph, e_cap=e, device=dev)
    if labels_a.dtype == torch.int32:
        labels = rng.integers(0, 5, labels_a.shape).astype(np.int32)
    else:
        labels = rng.normal(size=labels_a.shape).astype(np.float32)
    params = gnn_params(spec, shape, seed, smoke=True, device=dev)
    return (params, opt.init(params, _OPT),
            (batch, torch.from_numpy(labels).to(dev)))


def gnn_params(spec: ArchSpec, shape: ShapeSpec, seed: int = 0, *,
               smoke: bool, device="cuda") -> dict:
    """The cell's parameters by name: its module at the cell's config
    (SMOKE with ``smoke``, else CONFIG), weights from a CPU
    ``torch.Generator`` seeded ``seed``, on ``device``."""
    s = _gnn_setup(spec, shape, smoke)
    return _named_params(s["modules"].cls(
        s["cfg"], generator=torch.Generator().manual_seed(seed),
        device=resolve_device(device)))


# ==========================================================================
# RecSys family (DIEN)
# ==========================================================================
def _dien_batch_struct(cfg: dien_mod.DIENConfig, b: int, with_train: bool):
    t = cfg.seq_len
    d = {
        "hist_items": _meta((b, t), torch.int32),
        "hist_cates": _meta((b, t), torch.int32),
        "hist_mask": _meta((b, t), torch.bool),
        "target_item": _meta((b,), torch.int32),
        "target_cate": _meta((b,), torch.int32),
        "profile": _meta((b, cfg.profile_bags, cfg.bag_size), torch.int32),
    }
    if with_train:
        d.update({
            "neg_items": _meta((b, t), torch.int32),
            "neg_cates": _meta((b, t), torch.int32),
            "label": _meta((b,), torch.int32),
        })
    return d


def _dien_batch_spec(struct):
    return {k: ("batch",) + (None,) * (len(v.shape) - 1)
            for k, v in struct.items()}


def _dien_flops(cfg: dien_mod.DIENConfig, b: int, train: bool) -> float:
    d, h, t = cfg.beh_dim, cfg.gru_dim, cfg.seq_len
    gru = 2 * 3 * h * (d + h) * t * 2          # GRU + AUGRU
    mlp_in = h + d + cfg.profile_bags * cfg.embed_dim
    mlp = 2 * (mlp_in * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1])
    aux = 2 * (h + d) * 100 * t * 2 if train else 0
    total = (gru + mlp + aux) * b
    return float(total * (3 if train else 1))


def dien_bundle(spec: ArchSpec, shape: ShapeSpec, smoke: bool) -> StepBundle:
    cfg: dien_mod.DIENConfig = spec.smoke if smoke else spec.config
    dims = dict(shape.dims)
    if smoke:
        dims["batch"] = 4
        dims["n_candidates"] = 64
    b = dims["batch"]
    params_a = dien_mod.init_params(cfg, device="meta")
    p_specs = dien_mod.param_specs(cfg)
    name = f"{spec.arch_id}/{shape.name}"

    if shape.kind == "recsys_train":
        batch_a = _dien_batch_struct(cfg, b, with_train=True)
        return StepBundle(
            name=name,
            fn=make_train_step_fn(dien_mod.make_train_loss(cfg), _OPT),
            mesh_fn=None,
            abstract_args=(params_a, opt.init(params_a, _OPT), batch_a),
            arg_specs=(p_specs, opt.state_specs(p_specs),
                       _dien_batch_spec(batch_a)),
            model_flops=_dien_flops(cfg, b, train=True))

    if shape.kind == "recsys_serve":
        batch_a = _dien_batch_struct(cfg, b, with_train=False)

        def serve(params, batch):
            return dien_mod.forward(params, batch, cfg)

        return StepBundle(
            name=name, fn=serve, mesh_fn=None,
            abstract_args=(params_a, batch_a),
            arg_specs=(p_specs, _dien_batch_spec(batch_a)),
            model_flops=_dien_flops(cfg, b, train=False))

    if shape.kind == "retrieval":
        n_cand = dims["n_candidates"]
        batch_a = _dien_batch_struct(cfg, b, with_train=False)
        cand_a = {"item": _meta((n_cand,), torch.int32),
                  "cate": _meta((n_cand,), torch.int32)}

        def retrieve(params, batch, cand):
            return dien_mod.retrieval_scores(params, batch, cand, cfg)

        flops = (_dien_flops(cfg, b, train=False)
                 + 2.0 * b * cfg.beh_dim * n_cand)
        return StepBundle(
            name=name, fn=retrieve, mesh_fn=None,
            abstract_args=(params_a, batch_a, cand_a),
            arg_specs=(p_specs, _dien_batch_spec(batch_a),
                       {"item": ("qbatch",), "cate": ("qbatch",)}),
            model_flops=float(flops))

    raise ValueError(shape.kind)


_DIEN_SERVE_KEYS = ("hist_items", "hist_cates", "hist_mask", "target_item",
                    "target_cate", "profile")


def dien_host_args(spec: ArchSpec, shape: ShapeSpec, seed: int = 0, *,
                   device="cuda"):
    from repro_torch.data import dien_batch
    cfg: dien_mod.DIENConfig = spec.smoke
    dev = resolve_device(device)
    params = dien_mod.init_params(cfg, generator=_generator(seed, dev),
                                  device=dev)
    b = 4
    full = dien_batch(0, b, cfg.seq_len, cfg.n_items, cfg.n_cates,
                      cfg.n_profile_vocab, cfg.profile_bags, cfg.bag_size,
                      seed=seed)
    full = {k: torch.from_numpy(v).to(dev) for k, v in full.items()}
    if shape.kind == "recsys_train":
        return (params, opt.init(params, _OPT), full)
    serve_batch = {k: full[k] for k in _DIEN_SERVE_KEYS}
    if shape.kind == "recsys_serve":
        return (params, serve_batch)
    rng = np.random.default_rng(seed)
    cand = {"item": rng.integers(0, cfg.n_items, (64,)),
            "cate": rng.integers(0, cfg.n_cates, (64,))}
    return (params, serve_batch,
            {k: torch.from_numpy(v.astype(np.int32)).to(dev)
             for k, v in cand.items()})


# ==========================================================================
# DSPC family (the paper's workload)
# ==========================================================================
def _dspc_cap_e(m: int) -> int:
    return 1 << (2 * m + m).bit_length()        # 2m doubled + headroom


def dspc_bundle(spec: ArchSpec, shape: ShapeSpec, smoke: bool) -> StepBundle:
    from repro_torch.core import distributed as dist
    from repro_torch.core.decremental import dec_spc
    from repro_torch.core.graph import Graph
    from repro_torch.core.incremental import inc_spc
    from repro_torch.core.labels import SPCIndex

    cfg = spec.smoke if smoke else spec.config
    dims = dict(shape.dims)
    if smoke:
        dims.update(n=cfg.n, m=cfg.m, l_cap=cfg.l_cap, batch=cfg.query_batch)
    n, m, l_cap = dims["n"], dims["m"], dims["l_cap"]
    cap_e = _dspc_cap_e(m)
    graph_a = Graph(src=_meta((cap_e,), torch.int32),
                    dst=_meta((cap_e,), torch.int32), m2=2 * m, n=n)
    graph_spec = Graph(src=("edges",), dst=("edges",), m2=(), n=n)
    index_a = SPCIndex(hub=_meta((n + 1, l_cap), torch.int32),
                       dist=_meta((n + 1, l_cap), torch.int32),
                       cnt=_meta((n + 1, l_cap), torch.int64),
                       size=_meta((n + 1,), torch.int32),
                       cnt_sum=_meta((n + 1,), torch.int64),
                       overflow=_meta((), torch.int32), n=n)
    index_spec = SPCIndex(hub=(), dist=(), cnt=(), size=(), cnt_sum=(),
                          overflow=(), n=n)
    # op-count proxy: per hub ~ one BFS over m edges + nL label merge
    build_ops = float(n) * (2.0 * m + 2.0 * n * l_cap) / 50.0
    update_ops = 2.0 * m + 4.0 * (n + 1) * l_cap
    name = f"{spec.arch_id}/{shape.name}"

    if shape.kind == "dspc_build":
        def mesh_fn(mesh):
            build = dist.make_distributed_builder(mesh, "model")
            return lambda g: build(_whole_tree(g), l_cap=l_cap)
        return StepBundle(
            name=name, fn=None, mesh_fn=mesh_fn,
            abstract_args=(graph_a,), arg_specs=(graph_spec,),
            model_flops=build_ops, notes="op-count proxy, not FLOPs")

    if shape.kind in ("dspc_inc", "dspc_dec"):
        fn = inc_spc if shape.kind == "dspc_inc" else dec_spc

        def wrapped(g, idx, a, b):
            a, b = int(_whole(a)), int(_whole(b))   # read on the host
            return fn(_whole_tree(g), _whole_tree(idx), a, b)

        return StepBundle(
            name=name, fn=wrapped, mesh_fn=None,
            abstract_args=(graph_a, index_a, _meta((), torch.int32),
                           _meta((), torch.int32)),
            arg_specs=(graph_spec, index_spec, (), ()),
            model_flops=update_ops, notes="op-count proxy, not FLOPs")

    if shape.kind == "dspc_query":
        batch = dims["batch"]

        def mesh_fn(mesh):
            axes = tuple(a for a in ("pod", "data", "model")
                         if a in mesh.axis_names)
            query = dist.make_sharded_query(mesh, axes)
            # the placed index is replicated: entry 0's copy stands for
            # each entry's own (the query reads it on every device)
            return lambda idx, s, t: query(local_tree(idx, 0), _whole(s),
                                           _whole(t))

        return StepBundle(
            name=name, fn=None, mesh_fn=mesh_fn,
            abstract_args=(index_a, _meta((batch,), torch.int32),
                           _meta((batch,), torch.int32)),
            arg_specs=(index_spec, ("qbatch",), ("qbatch",)),
            model_flops=4.0 * batch * l_cap * l_cap,
            notes="op-count proxy, not FLOPs")

    raise ValueError(shape.kind)


def dspc_host_args(spec: ArchSpec, shape: ShapeSpec, seed: int = 0, *,
                   device="cuda"):
    from repro_torch.core import build_index, from_edges
    from repro_torch.data import random_graph_edges
    dev = resolve_device(device)
    cfg = spec.smoke
    edges = random_graph_edges(cfg.n, cfg.m, seed=seed)
    g = from_edges(cfg.n, edges, cap_e=_dspc_cap_e(cfg.m), device=dev)
    if shape.kind == "dspc_build":
        return (g,)
    idx = build_index(g, l_cap=cfg.l_cap)

    def scalar(x):
        return torch.tensor(int(x), dtype=torch.int32, device=dev)

    if shape.kind == "dspc_inc":
        present = set(edges)
        rng = np.random.default_rng(seed)
        while True:
            a, b = rng.integers(0, cfg.n, 2)
            if a != b and (min(a, b), max(a, b)) not in present:
                break
        return (g, idx, scalar(a), scalar(b))
    if shape.kind == "dspc_dec":
        a, b = edges[len(edges) // 2]
        return (g, idx, scalar(a), scalar(b))
    rng = np.random.default_rng(seed)
    s = rng.integers(0, cfg.n, cfg.query_batch).astype(np.int32)
    t = rng.integers(0, cfg.n, cfg.query_batch).astype(np.int32)
    return (idx, torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))


# ==========================================================================
# Ring variant: node-sharded Equiformer-v2 for the full-batch-large shapes
# ==========================================================================
class _RingLoss(nn.Module):
    """The ring forward, the head on its scalars and the masked
    cross-entropy, as one module's ``forward``, so that
    ``functional_call`` swaps the parameters in for the whole loss.  The
    head and the per-row losses run block by block on the node blocks'
    devices (``ring.forward_ring`` keeps the node state sharded over
    ``data``); only each block's sum and count reach the controller."""

    def __init__(self, model: EquiformerV2, mesh) -> None:
        super().__init__()
        self.m = model
        self.mesh = mesh

    def forward(self, nodes, pos, sb, db, labels):
        from repro_torch.launch.mesh import Placed, psum
        from repro_torch.models.gnn import ring
        x = ring.forward_ring(self.m, nodes, pos, sb, db, self.mesh)
        sums, counts = [], []
        for key, bounds, block in x.blocks:
            lab = (labels.shard(x.entry_keys.index(key))
                   if isinstance(labels, Placed)
                   else labels[slice(*bounds[0])]).to(key[1])
            head = ring._on(self.m.head, lambda h, z: h(z), key[1])
            logits = head(block[..., 0]).float()
            mask = lab >= 0
            logz = torch.logsumexp(logits, dim=-1)
            ll = logits.gather(-1, lab.clamp(min=0).long()[:, None])[:, 0]
            sums.append(torch.where(mask, logz - ll, 0.0).sum())
            counts.append(mask.sum())
        home = labels.device if torch.is_tensor(labels) else \
            labels.entry_keys[0][1]
        return psum(sums, home) / psum(counts, home).clamp(min=1)


def equiformer_ring_bundle(spec: ArchSpec, shape: ShapeSpec,
                           p_data: int = 16,
                           p_model: int = 16) -> StepBundle:
    """The reference's ``steps.py:577``: Equiformer-v2 at a full-graph
    shape through ``models.gnn.ring`` over a ``("data", "model")`` mesh
    of ``p_data`` x ``p_model``; nodes (and labels, -1 on pad rows) in
    the blocked layout, edges in ring buckets."""
    from repro_torch.models.gnn import ring

    dims = dict(shape.dims)
    cfg = _gnn_adapt(spec.config, dims["d_feat"], dims["n_classes"])
    n = dims["n_nodes"]
    src_a, dst_a, n_loc = ring.bucket_specs(n, dims["n_edges"], p_data,
                                            p_model)
    n_pad = p_data * (n_loc + 1)
    nodes_a = _meta((n_pad, dims["d_feat"]), torch.float32)
    pos_a = _meta((n_pad, 3), torch.float32)
    labels_a = _meta((n_pad,), torch.int32)          # -1 on pad rows
    modules = GNNModules(EquiformerV2, cfg)
    params_a = _named_params(modules.on("meta"))
    p_specs = replicated_specs(modules.on("meta"))

    def mesh_fn(mesh):
        def loss_fn(params, batch):
            # placed (replicated) weights: entry 0's view, so that their
            # gradients come back laid out as they are
            params = {k: entry_view(v, 0) if isinstance(v, Placed) else v
                      for k, v in params.items()}
            model = modules.on(next(iter(params.values())).device)
            return torch.func.functional_call(
                _RingLoss(model, mesh),
                {f"m.{k}": v for k, v in params.items()}, batch)

        return make_train_step_fn(loss_fn, _OPT)

    node_spec = ("ring_nodes",)
    return StepBundle(
        name=f"{spec.arch_id}/{shape.name}@ring", fn=None, mesh_fn=mesh_fn,
        abstract_args=(params_a, opt.init(params_a, _OPT),
                       (nodes_a, pos_a, src_a, dst_a, labels_a)),
        arg_specs=(p_specs, opt.state_specs(p_specs),
                   (node_spec + (None,), node_spec + (None,),
                    ("ring_nodes", "ring_cols", None, None),
                    ("ring_nodes", "ring_cols", None, None), node_spec)),
        model_flops=_gnn_flops(spec.arch_id, cfg, dims["n_edges"], n) * 3,
        notes="ring-partitioned (SPerf cell-B)")


# ==========================================================================
# The reference's host arguments, carried into the port's trees
# ==========================================================================
def _gnn_tree(model_like: nn.Module, tree, device) -> dict:
    """A reference GNN tree (parameters, or moments of their shapes) as
    the port's dict by parameter name: loaded into a module of the
    cell's config through its ``load_reference_params``, which knows
    each leaf's place (and the transposes of ``nn.Linear``)."""
    return {k: p.detach().clone() for k, p in
            model_like.load_reference_params(tree).named_parameters()}


def _graph_batch(b, device) -> GraphBatch:
    def put(x, dtype=None):
        return torch.from_numpy(np.array(x)).to(device=device, dtype=dtype)
    return GraphBatch(
        nodes=put(b.nodes), senders=put(b.senders, torch.int64),
        receivers=put(b.receivers, torch.int64),
        pos=None if b.pos is None else put(b.pos),
        graph_id=put(b.graph_id, torch.int64), n_node=int(b.n_node),
        n_graph=int(b.n_graph))


def load_reference_args(arch_id: str, shape_name: str, args, *,
                        device="cuda") -> tuple:
    """The reference's ``make_host_args(arch_id, shape_name)`` output,
    leaves as numpy (``jax.tree.map(np.asarray, ...)``), as the port's
    argument tree of the same smoke cell on ``device``: parameters
    through ``load_reference_params`` (the GNNs' into a module of the
    cell's config), AdamW state through ``load_reference_state`` (the
    GNNs' moments through the same module), the ``GraphBatch``, the
    DIEN batch, the LM cache and the DSPC ``Graph`` / ``SPCIndex``."""
    from repro_torch.core.graph import Graph
    from repro_torch.core.labels import SPCIndex
    dev = resolve_device(device)
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    if spec.family in ("lm", "recsys"):
        params = load_tree(args[0], device=dev)
        rest = list(args[1:])
        if shape.kind in ("train", "recsys_train"):
            rest[0] = opt.load_reference_state(rest[0], device=dev)
            rest[1:] = [load_tree(x, device=dev) for x in rest[1:]]
        else:
            rest = [load_tree(x, device=dev) for x in rest]
        return (params, *rest)
    if spec.family == "gnn":
        s = _gnn_setup(spec, shape, smoke=True)
        model = s["modules"].cls(s["cfg"], device=dev)
        ref_params, ref_state, (ref_batch, ref_labels) = args
        if any(np.ndim(x) or np.asarray(x).item() != 0
               for x in _leaves(ref_state.err)):
            raise ValueError("the reference state carries a compression "
                             "residual; the GNN smoke cells have none")
        params = _gnn_tree(model, ref_params, dev)
        state = opt.OptState(
            step=torch.tensor(np.asarray(ref_state.step), device=dev),
            mu=_gnn_tree(model, ref_state.mu, dev),
            nu=_gnn_tree(model, ref_state.nu, dev),
            err={k: torch.zeros((), dtype=torch.float32, device=dev)
                 for k in params})
        return (params, state, (_graph_batch(ref_batch, dev),
                                load_tree(ref_labels, device=dev)))
    # dspc
    def graph(g):
        return Graph(src=load_tree(g.src, device=dev).to(torch.int32),
                     dst=load_tree(g.dst, device=dev).to(torch.int32),
                     m2=int(np.asarray(g.m2)), n=int(g.n))

    def index(x):
        return SPCIndex(**{f: load_tree(getattr(x, f), device=dev)
                           for f in ("hub", "dist", "cnt", "size",
                                     "cnt_sum", "overflow")}, n=int(x.n))

    if shape.kind == "dspc_build":
        return (graph(args[0]),)
    if shape.kind == "dspc_query":
        return (index(args[0]), load_tree(args[1], device=dev),
                load_tree(args[2], device=dev))
    return (graph(args[0]), index(args[1]), load_tree(args[2], device=dev),
            load_tree(args[3], device=dev))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree]


# ==========================================================================
# Dispatch
# ==========================================================================
_BUNDLERS = {"lm": lm_bundle, "gnn": gnn_bundle, "recsys": dien_bundle,
             "dspc": dspc_bundle}
_HOST_ARGS = {"lm": lm_host_args, "gnn": gnn_host_args,
              "recsys": dien_host_args, "dspc": dspc_host_args}


def make_bundle(arch_id: str, shape_name: str, *, smoke: bool = False,
                variant: str = "") -> StepBundle:
    """The cell's bundle: ``smoke`` at the SMOKE config, ``variant="ring"``
    for Equiformer-v2's ring-partitioned full-graph step."""
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    if variant == "ring":
        if not (arch_id == "equiformer-v2" and shape.kind == "full_graph"):
            raise ValueError("the ring variant is the equiformer-v2 "
                             "full-graph optimization")
        return equiformer_ring_bundle(spec, shape)
    if variant:
        raise ValueError(f"unknown variant {variant!r}")
    return _BUNDLERS[spec.family](spec, shape, smoke)


def make_host_args(arch_id: str, shape_name: str, seed: int = 0, *,
                   device="cuda"):
    spec = get_arch(arch_id)
    shape = spec.shapes[shape_name]
    return _HOST_ARGS[spec.family](spec, shape, seed, device=device)


def all_cells(include_dspc: bool = True):
    from repro_torch.configs import ARCH_IDS, ASSIGNED_ARCH_IDS
    ids = ARCH_IDS if include_dspc else ASSIGNED_ARCH_IDS
    return [(a, s) for a in ids for s in get_arch(a).shapes]


__all__ = ["GNNModules", "StepBundle", "all_cells", "dien_bundle",
           "dien_host_args", "dspc_bundle", "dspc_host_args",
           "equiformer_ring_bundle", "gnn_bundle", "gnn_host_args",
           "gnn_params", "lm_bundle", "lm_host_args", "load_reference_args",
           "make_bundle", "make_host_args"]
