"""Decoder-only LM (port of ``repro.models.transformer``): parameters,
``forward_train`` and ``make_train_loss``, the cache, ``prefill`` and
``decode_step`` for every LM configuration of the reference -- GQA or
MLA attention, a dense or a mixture-of-experts FFN.

Parameters are a nested dict of tensors in the reference's layout --
[in, out] weights, the layers stacked on a leading [L] axis, the MoE
router in float32 -- so :func:`load_reference_params` is a plain copy
of the reference's tree.  The layer loop is a Python loop over views of
that stack.  Every layer is of one kind, as in the reference (no
leading dense layer in the MoE configurations).

Training sums the MoE layers' switch aux losses into the loss, as the
reference does; a dense layer adds none (the reference stacks its
``0.0`` as float64 under x64, which makes its loss float64; here the
loss stays float32).  ``cfg.remat`` wraps each layer of
``forward_train`` in ``torch.utils.checkpoint`` (non-reentrant), which
recomputes its activations in the backward: the same numbers.  Serving
drops the aux loss, as the reference's ``prefill`` and ``decode_step``
do (here it is not computed at all).

The mesh: ``param_specs``, ``act_spec`` and ``cache_specs`` are the
reference's logical specs (``repro_torch.sharding``).  ``init_cache`` /
``prefill`` with ``mesh=`` lay the cache out over the mesh (``cache_seq``
-> ``model``: each sequence shard its own tensor on its entry's device),
and ``decode_step`` on such a cache runs the sequence-sharded decode
(``attention.gqa_decode_sharded``, ``mla_decode_sharded``): one
flash_decode launch a shard for GQA, the shards' partial outputs merged
by their log-sum-exps.

The tensor-parallel serve path: :func:`place_params` lays the weights
out by ``param_specs`` (``TP_ONLY``: ``heads``, ``mlp``, ``vocab`` and
``experts`` over ``model``, the batch over ``data``), and ``prefill`` /
``decode_step`` given that placed tree run each layer over the mesh's
``model`` entries: the vocab-parallel embedding
(``common.take_rows``), each entry's heads (``attention.prefill_tp``,
``gqa_decode_tp`` / ``mla_decode_tp`` on the sequence-sharded cache),
its slice of the FFN or its experts (``moe.ffn_tp``) and its logit
columns (``common.split_logits``), the partial outputs summed in entry
order on the controller's device (``launch.mesh.psum``).  In the
prefill the residual stream is laid out by ``act_spec`` through
``sharding.shard_act``: sequence shards, one on each ``model`` entry's
device, where ``t % tp == 0`` -- the norms and residual adds run on
the shards, gathered before attention and the FFN.  ``cfg.tp`` must be
the mesh's ``model`` size (the reference pads the query heads to its
model axis).  ``unroll_scans`` (a cost-analysis mode of XLA) has no
effect.

FSDP training: ``make_train_loss`` given a tree laid out by
``param_specs`` through ``FSDP_TP`` (``launch.steps``' ``place_args``:
``embed`` and ``expert_embed`` over ``data``, ``heads``, ``mlp``,
``vocab`` and ``experts`` over ``model``) runs each layer over the
mesh, under ``remat`` one ``torch.utils.checkpoint`` a layer, whose
backward gathers the layer again.  Each mesh entry takes its view of
the layer (``launch.mesh.entry_view``: its ``model`` block, the
``data`` shards gathered), and runs its heads
(``attention.train_tp``) and its FFN slice or experts
(``moe.ffn_tp`` / ``moe_ffn_tp``: ``route`` and the aux loss whole on
the first entry's router, as on one device) on its data row's batch
rows; the partial outputs are summed in entry order.  The residual is
laid out by ``act_spec`` (the reference's ``_layer_fwd`` constrains it
so), the norms run on its shards, the embedding is vocab-parallel over
each data row's entries, and the head and cross-entropy run one
sequence at a time over the entries' logit columns, the sequences
added in batch order as on one device.  The views' gradients are
reduce-scattered onto the shards by ``launch.mesh.ShardGrads``
(``train.loop.value_and_grad``).  ``check_tp``'s ``cfg.tp == model``
does not apply here: ``cfg.tp`` pads the heads and the vocabulary, as
the reference pads them whatever the mesh, and the train path needs
only that the mesh's sizes divide every split dimension
(:func:`check_fsdp`).  At a mesh of one entry the step is the one-device
step, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch import sharding as SH
from repro_torch.core.graph import resolve_device
from repro_torch.launch.mesh import (Placed, block_bounds, entry_bounds,
                                     entry_grid, entry_view, entry_views,
                                     as_controller, gather, gather_entry,
                                     local_tree,
                                     place_tree, place_zeros, row_groups)
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.common import (dense_init, init_rms, load_tree,
                                      rms_norm, softmax_cross_entropy,
                                      split_logits, take_rows)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Every field of the reference's config, so config files read the
    same; ``param_dtype`` and ``act_dtype`` are torch dtypes.

    ``moe_groups`` and ``moe_capacity_factor`` act on one card as on a
    mesh: the dispatch groups and the capacity of each expert in a group
    decide which routed assignments drop (``moe.dispatch_shape``).
    ``remat`` recomputes each layer in ``forward_train``'s backward.
    ``sharded_decode`` sequence-splits a cache laid out over a mesh
    (``cache_specs``); ``seq_parallel`` chooses ``act_spec``, the
    residual stream's layout in the tensor-parallel prefill, and
    ``unroll_scans`` has no effect (module doc); ``tp`` pads the query
    heads and the vocabulary, and is the ``model`` size of the mesh the
    tensor-parallel path runs on."""
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 128
    attn: str = "gqa"              # "gqa" | "mla"
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # MLA dims (deepseek-v2)
    kv_lora: int = 512
    q_lora: int = 0                # 0 = no q compression
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    moe_experts: int = 0           # 0 = dense FFN
    moe_shared: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_norm_topk: bool = True
    moe_groups: int = 16
    aux_loss_weight: float = 0.001
    # system
    tp: int = 16                   # head and vocab padding multiple
    param_dtype: Any = torch.bfloat16
    act_dtype: Any = torch.bfloat16
    remat: bool = True
    max_seq: int = 4096
    sharded_decode: bool = True
    blockwise_prefill_from: int = 8192  # t >= this: flash-style prefill
    prefill_block_k: int = 1024
    seq_parallel: bool = True
    unroll_scans: bool = False

    @property
    def padded_heads(self) -> int:
        return A.pad_heads(self.n_heads, self.tp)

    @property
    def padded_vocab(self) -> int:
        return A.pad_heads(self.vocab, self.tp)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (unpadded)."""
        d, l, v = self.d_model, self.n_layers, self.vocab
        if self.attn == "mla":
            dqk = self.qk_nope_dim + self.qk_rope_dim
            h = self.n_heads
            attn = (self.q_lora * (d + h * dqk) if self.q_lora
                    else d * h * dqk)
            attn += d * (self.kv_lora + self.qk_rope_dim)
            attn += self.kv_lora * h * (self.qk_nope_dim + self.v_head_dim)
            attn += h * self.v_head_dim * d
        else:
            attn = d * self.d_head * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.is_moe:
            ffn = (3 * d * self.moe_d_ff * (self.moe_experts + self.moe_shared)
                   + d * self.moe_experts)
        else:
            ffn = 3 * d * self.d_ff
        return l * (attn + ffn + 2 * d) + 2 * v * d

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        ffn_all = 3 * d * self.moe_d_ff * self.moe_experts
        ffn_act = 3 * d * self.moe_d_ff * self.moe_top_k
        return self.param_count() - l * (ffn_all - ffn_act)


# -------------------------------------------------------------------------
# Parameters
# -------------------------------------------------------------------------
def init_params(cfg: TransformerConfig, *, generator=None,
                device="cuda") -> dict:
    """Random parameters in the reference's tree layout, drawn with a
    ``torch.Generator`` (default: seed 0 on ``device``).  The numbers
    differ from ``jax.random``'s; tests carry the reference's across
    with :func:`load_reference_params`."""
    dev = resolve_device(device)
    if generator is None:
        # torch.Generator takes no meta device; nothing is drawn there
        generator = torch.Generator(
            "cpu" if dev.type == "meta" else dev).manual_seed(0)
    lead = (cfg.n_layers,)
    kw = dict(generator=generator, dtype=cfg.param_dtype, device=dev)
    d, vp = cfg.d_model, cfg.padded_vocab
    init_attn = A.init_mla if cfg.attn == "mla" else A.init_gqa
    layers = {
        "attn": init_attn(cfg, generator=generator, device=dev, lead=lead),
        "ffn": (M.init_moe(cfg, generator=generator, device=dev, lead=lead)
                if cfg.is_moe else M.init_dense_ffn(d, cfg.d_ff, lead=lead,
                                                    **kw)),
        "ln1": init_rms(d, dtype=cfg.param_dtype, device=dev).repeat(
            cfg.n_layers, 1),
        "ln2": init_rms(d, dtype=cfg.param_dtype, device=dev).repeat(
            cfg.n_layers, 1),
    }
    return {"embed": dense_init(vp, d, scale=0.02, **kw), "layers": layers,
            "ln_f": init_rms(d, dtype=cfg.param_dtype, device=dev),
            "lm_head": dense_init(d, vp, **kw)}


def load_reference_params(tree, *, device="cuda") -> dict:
    """The reference's parameter tree (``transformer.init_params``,
    leaves as numpy arrays) as the same tree of tensors on ``device``."""
    return load_tree(tree, device=device)


def param_specs(cfg: TransformerConfig) -> dict:
    """The logical specs of :func:`init_params`' tree, the reference's
    (``transformer.py:161``): every per-layer leaf with the stacked
    ``"layers"`` axis first."""
    attn = A.mla_specs(cfg) if cfg.attn == "mla" else A.gqa_specs(cfg)
    ffn = M.moe_specs() if cfg.is_moe else M.dense_ffn_specs()
    layer = {"attn": attn, "ffn": ffn, "ln1": (None,), "ln2": (None,)}
    return {"embed": ("vocab", "embed"),
            "layers": SH.map_specs(lambda sp: ("layers",) + tuple(sp),
                                   layer),
            "ln_f": (None,), "lm_head": ("embed", "vocab")}


def check_tp(cfg: TransformerConfig, mesh) -> None:
    """Raise ``ValueError`` unless the tensor-parallel path can run
    ``cfg`` on ``mesh``: a ``model`` axis whose size divides the padded
    heads, the padded vocabulary, the FFN's width and the experts (none
    is ever split unevenly), and equals ``cfg.tp``."""
    if "model" not in mesh.axis_names:
        raise ValueError(f"the tensor-parallel path needs a 'model' mesh "
                         f"axis, got {mesh.axis_names}")
    p = mesh.shape["model"]
    dims = {"heads": cfg.padded_heads, "vocab": cfg.padded_vocab}
    if cfg.is_moe:
        dims.update(experts=cfg.moe_experts,
                    mlp=cfg.moe_shared * cfg.moe_d_ff)
    else:
        dims["mlp"] = cfg.d_ff
    for name, n in dims.items():
        if n % p:
            raise ValueError(f"{cfg.name}: {name} ({n}) does not split "
                             f"evenly over the mesh's model axis of {p}")
    if cfg.tp != p and p != 1:
        raise ValueError(f"{cfg.name}: tp = {cfg.tp} must equal the mesh's "
                         f"model axis ({p}): the reference pads the query "
                         f"heads to it")


def place_params(params: dict, cfg: TransformerConfig, mesh,
                 rules=SH.TP_ONLY) -> dict:
    """``params`` laid out over ``mesh`` by :func:`param_specs` through
    ``rules`` (``launch.mesh.place_tree``): the tree ``prefill`` and
    ``decode_step`` run the tensor-parallel path on (module doc)."""
    check_tp(cfg, mesh)
    specs = param_specs(cfg)
    return place_tree(params, SH.resolve_tree(specs, rules, mesh), specs)


#: [b, t, d] activations: batch-sharded.
ACT = ("batch", None, None)


def act_spec(cfg: TransformerConfig, t: int):
    """Residual-stream spec: sequence-parallel when enabled and the
    sequence divides ``tp`` (decode t = 1 stays batch-only)."""
    if cfg.seq_parallel and t % cfg.tp == 0:
        return ("batch", "act_seq", None)
    return ACT


def param_bytes(params: dict) -> int:
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def _layer(tree, i: int):
    """Layer ``i``'s parameters: views into the stacked [L, ...] tree."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# -------------------------------------------------------------------------
# Training forward and loss
# -------------------------------------------------------------------------
def _layer_fwd(layer_p: dict, x: torch.Tensor, cfg: TransformerConfig,
               positions: torch.Tensor):
    """One layer of ``forward_train``: (x out, its aux loss or None)."""
    h, _ = (A.mla_train if cfg.attn == "mla" else A.gqa_train)(
        layer_p["attn"], rms_norm(layer_p["ln1"], x), cfg, positions)
    x = x + h
    if cfg.is_moe:
        f, aux = M.moe_ffn(layer_p["ffn"], rms_norm(layer_p["ln2"], x), cfg)
    else:
        f, aux = M.dense_ffn(layer_p["ffn"], rms_norm(layer_p["ln2"], x)), None
    return x + f, aux


def _train_hidden(params: dict, tokens: torch.Tensor,
                  cfg: TransformerConfig):
    """The final-norm hidden states [b, t, d] of ``forward_train`` and
    the summed aux loss (float32)."""
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.act_dtype)
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device).expand(b, t)
    auxes = []
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        if cfg.remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                _layer_fwd, lp, x, cfg, positions, use_reentrant=False)
        else:
            x, aux = _layer_fwd(lp, x, cfg, positions)
        if aux is not None:
            auxes.append(aux)
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return rms_norm(params["ln_f"], x), aux


def forward_train(params: dict, tokens: torch.Tensor,
                  cfg: TransformerConfig):
    """tokens int [b, t] -> (logits [b, t, Vpad], aux loss float32)."""
    x, aux = _train_hidden(params, tokens, cfg)
    return x @ params["lm_head"], aux


def _sequence_ce(x: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """One sequence's mean cross-entropy: ``x [t, d] @ head`` through
    ``softmax_cross_entropy``."""
    return softmax_cross_entropy(x @ head, labels)


def make_train_loss(cfg: TransformerConfig):
    """loss_fn(params, batch) -> scalar: next-token cross-entropy of
    ``batch["tokens"]`` against ``batch["labels"]`` (shifted once more,
    as the reference shifts them) plus ``aux_loss_weight`` times the
    summed MoE aux loss.

    The head and the cross-entropy run one sequence at a time, each
    under ``torch.utils.checkpoint``: only the hidden states are kept for
    the backward, never the [b, t, V] logits (qwen2-1.5b at 4 x 4096:
    5 GB in bf16, 10 GB more in float32, and as much again for their
    gradient).  Every sequence has t - 1 tokens, so the mean of the
    sequences' means is the reference's mean over all of them, up to
    float32 summation order.  Given a tree laid out by
    ``param_specs`` through ``FSDP_TP`` (``launch.steps``' ``place_args``),
    the FSDP train path (module doc)."""
    def loss_fn(params, batch):
        if isinstance(params["embed"], Placed):
            return _fsdp_train_loss(params, batch, cfg)
        x, aux = _train_hidden(params, batch["tokens"], cfg)
        x, labels = x[:, :-1], batch["labels"][:, 1:]
        total = 0
        for i in range(x.shape[0]):
            total = total + torch.utils.checkpoint.checkpoint(
                _sequence_ce, x[i], params["lm_head"], labels[i],
                use_reentrant=False)
        return total / x.shape[0] + cfg.aux_loss_weight * aux
    return loss_fn


# -------------------------------------------------------------------------
# Serving: prefill + decode
# -------------------------------------------------------------------------
def cache_names(cfg: TransformerConfig) -> tuple[str, str]:
    """The two per-layer cache tensors: ``("ckv", "kr")`` for MLA,
    ``("k", "v")`` for GQA."""
    return ("ckv", "kr") if cfg.attn == "mla" else ("k", "v")


def abstract_cache(cfg: TransformerConfig, batch: int, s_max: int) -> dict:
    """The cache's shapes and dtypes, as tensors on the meta device: for
    MLA the latent ``ckv [L, b, s_max, kv_lora]`` and the rope key ``kr
    [L, b, s_max, qk_rope_dim]``, for GQA ``k`` and ``v [L, b, s_max,
    kv, dh]``; and ``lengths`` int32 [b]."""
    lead = (cfg.n_layers, batch, s_max)
    if cfg.attn == "mla":
        shapes = (lead + (cfg.kv_lora,), lead + (cfg.qk_rope_dim,))
    else:
        shapes = (lead + (cfg.n_kv_heads, cfg.d_head),) * 2
    cache = {name: torch.empty(shape, dtype=cfg.act_dtype, device="meta")
             for name, shape in zip(cache_names(cfg), shapes)}
    cache["lengths"] = torch.empty((batch,), dtype=torch.int32, device="meta")
    return cache


def cache_specs(cfg: TransformerConfig) -> dict:
    """Logical specs of the cache: sequence-sharded (``cache_seq``) when
    ``sharded_decode`` (the reference's, ``transformer.py:271``)."""
    seq_ax = "cache_seq" if cfg.sharded_decode else None
    if cfg.attn == "mla":
        return {"ckv": ("layers", "batch", seq_ax, None),
                "kr": ("layers", "batch", seq_ax, None),
                "lengths": ("batch",)}
    return {"k": ("layers", "batch", seq_ax, "kv_heads", None),
            "v": ("layers", "batch", seq_ax, "kv_heads", None),
            "lengths": ("batch",)}


def init_cache(cfg: TransformerConfig, batch: int, s_max: int, *,
               device="cuda", mesh=None) -> dict:
    """A zero cache of :func:`abstract_cache`'s shapes, in ``act_dtype``
    (lengths int32).

    With ``mesh`` the two cache tensors are laid out over it by
    :func:`cache_specs` through ``FSDP_TP``: each
    shard made on its entry's device as a contiguous tensor of its own
    (``launch.mesh.place_zeros``), so that the flash_decode kernel reads
    it as it is.  ``lengths`` stays on ``device``, the controller's,
    whole (the reference replicates it); each step copies it to each
    distinct device of the shards."""
    dev = resolve_device(device)
    shapes = abstract_cache(cfg, batch, s_max)
    cache = {"lengths": torch.zeros((batch,), dtype=torch.int32,
                                    device=dev)}
    specs = cache_specs(cfg)
    for name in cache_names(cfg):
        x = shapes[name]
        if mesh is None:
            cache[name] = torch.zeros(x.shape, dtype=x.dtype, device=dev)
        else:
            cache[name] = place_zeros(x.shape, x.dtype, SH.resolve(
                specs[name], SH.FSDP_TP, mesh))
    return cache


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            s_max: int, *, mesh=None):
    """Full-sequence forward that also fills the cache.

    tokens int [b, t] on the device the parameters lie on.  Prompts of
    ``t >= cfg.blockwise_prefill_from`` take the blockwise attention.
    Returns (logits [b, Vpad] of the last position, cache) with the
    cache of :func:`init_cache` (laid out over ``mesh`` when given; each
    layer's rows written into the shards they reach)
    filled to length t.  Given :func:`place_params`' tree, the
    tensor-parallel prefill (module doc), its cache laid out over that
    tree's mesh."""
    if isinstance(params["embed"], Placed):
        return _prefill_tp(params, tokens, cfg, s_max)
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.act_dtype)
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device).expand(b, t)
    attn_fn = _prefill_attention(cfg, t)
    cache = init_cache(cfg, b, s_max, device=tokens.device, mesh=mesh)
    n1, n2 = cache_names(cfg)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h, (c1, c2) = attn_fn(lp["attn"], rms_norm(lp["ln1"], x), cfg,
                              positions)
        if mesh is None:
            cache[n1][i, :, :t] = c1
            cache[n2][i, :, :t] = c2
        else:
            A.cache_fill(cache[n1], i, c1)
            A.cache_fill(cache[n2], i, c2)
        x = x + h
        x = x + _ffn(lp["ffn"], rms_norm(lp["ln2"], x), cfg)
    logits = rms_norm(params["ln_f"], x[:, -1]) @ params["lm_head"]
    cache["lengths"].fill_(t)
    return logits, cache


def _prefill_attention(cfg: TransformerConfig, t: int):
    """The prefill's attention: blockwise from ``blockwise_prefill_from``
    tokens on, else the plain causal path."""
    mla = cfg.attn == "mla"
    if t < cfg.blockwise_prefill_from:
        return A.mla_train if mla else A.gqa_train
    blockwise = A.mla_prefill_blockwise if mla else A.gqa_prefill_blockwise

    def attn_fn(p, h, c, pos, **kw):
        # a prefill's positions are 0..t-1: known on the host, so no
        # block reads them back from the device
        return blockwise(p, h, c, pos, block_k=cfg.prefill_block_k,
                         q_last=range(t), **kw)
    return attn_fn


def _ffn(p: dict, x: torch.Tensor, cfg: TransformerConfig) -> torch.Tensor:
    """The layer's FFN; serving never computes the MoE aux loss."""
    return M.moe_dispatch(p, x, cfg)[0] if cfg.is_moe else M.dense_ffn(p, x)


def decode_step(params: dict, cache: dict, token: torch.Tensor,
                cfg: TransformerConfig):
    """One decode step: token int [b] -> (logits [b, Vpad], cache).

    Each layer writes its new rows **in place** into the cache's two
    tensors (``k`` / ``v``, or ``ckv`` / ``kr`` for MLA); the returned
    cache shares them and carries ``lengths + 1``.  A cache laid out
    over a mesh (``init_cache(..., mesh=)``) takes the sequence-sharded
    decode (module doc); given :func:`place_params`' tree and such a
    cache, the tensor-parallel decode."""
    if isinstance(params["embed"], Placed):
        return _decode_step_tp(params, cache, token, cfg)
    x = params["embed"][token[:, None]].to(cfg.act_dtype)
    lengths = cache["lengths"]
    n1, n2 = cache_names(cfg)
    mla = cfg.attn == "mla"
    sharded = isinstance(cache[n1], Placed)
    if sharded:
        decode = A.mla_decode_sharded if mla else A.gqa_decode_sharded
    else:
        decode = A.mla_decode if mla else A.gqa_decode
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h_in = rms_norm(lp["ln1"], x)
        if sharded:
            h = decode(lp["attn"], h_in, cache[n1], cache[n2], i, lengths,
                       cfg)
        else:
            h, _, _ = decode(lp["attn"], h_in, cache[n1][i], cache[n2][i],
                             lengths, cfg)
        x = x + h
        x = x + _ffn(lp["ffn"], rms_norm(lp["ln2"], x), cfg)
    logits = rms_norm(params["ln_f"], x[:, 0]) @ params["lm_head"]
    return logits, {n1: cache[n1], n2: cache[n2], "lengths": lengths + 1}


# -------------------------------------------------------------------------
# The tensor-parallel serve path (module doc)
# -------------------------------------------------------------------------
def _tp_setup(params: dict, cfg: TransformerConfig, b: int):
    """(mesh, rules, groups) of a placed tree: ``groups`` ``[(b0, b1,
    [(entry, device), ...]), ...]``, each batch range (``batch`` through
    the active rules, ``TP_ONLY`` outside a context) with its ``model``
    entries in order.  Raises where the path cannot run
    (:func:`check_tp`)."""
    mesh = params["embed"].sharding.mesh
    check_tp(cfg, mesh)
    rules = SH.active_rules() or SH.TP_ONLY
    batch = SH.resolve(("batch",), rules, mesh)
    rows: dict = {}
    for e, (coords, dev) in enumerate(batch.entries()):
        (r,) = batch.block_of(coords, 1)
        rows.setdefault(r, {}).setdefault(coords["model"], (e, dev))
    groups = []
    for r in sorted(rows):
        ((b0, b1),) = block_bounds((b,), batch.parts(1), (r,))
        if b1 > b0:
            groups.append((b0, b1, [rows[r][m] for m in sorted(rows[r])]))
    return mesh, rules, groups


def _layer_view(tree: dict, e: int, i: int) -> dict:
    """Entry ``e``'s layer ``i`` of a placed layer tree: its own shard's
    layer of a leaf split over ``model`` only (``TP_ONLY``), its
    gathered view of one split over ``data`` too (``FSDP_TP``:
    ``launch.mesh.gather_entry``)."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _layer_view(x, e, i)
        elif any(a == "data" for a in _spec_axes(x)):
            out[k] = gather_entry(x, e, i)
        else:
            out[k] = x.shard(e)[i]
    return out


def _spec_axes(x) -> tuple:
    return tuple(a for entry in x.sharding.spec if entry is not None
                 for a in (entry if isinstance(entry, tuple) else (entry,)))


def _layer_groups(params: dict, groups, i: int, part: str):
    """Layer ``i``'s ``part`` (``"attn"`` / ``"ffn"``) of each entry,
    ``[(b0, b1, [(device, tree, entry), ...]), ...]``
    (``launch.mesh.row_groups``)."""
    tree = params["layers"][part]
    return row_groups(groups, lambda e: _layer_view(tree, e, i))


def _norm(g: torch.Tensor, x):
    """RMSNorm of the residual stream, whole or placed (each shard on
    its device)."""
    if isinstance(x, Placed):
        return x.map(lambda s, _, dev: rms_norm(g.to(dev), s))
    return rms_norm(g.to(x.device), x)


def _whole(x, device) -> torch.Tensor:
    """The residual stream whole on ``device`` (gathered when placed)."""
    return gather(x, device) if isinstance(x, Placed) else x.to(device)


def _add(x, f: torch.Tensor):
    """``x + f``, for a placed ``x`` each shard plus its slice of ``f``
    on the shard's device."""
    if isinstance(x, Placed):
        return x.map(lambda s, sl, dev: s + f[sl].to(dev))
    return x + f


def _residual(x: torch.Tensor, spec, mesh, rules):
    """The residual stream laid out by ``spec`` (``sharding.shard_act``);
    whole where no axis of the mesh applies."""
    with SH.activation_sharding(rules, mesh):
        return SH.shard_act(x, spec)


def _prefill_tp(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                s_max: int):
    b, t = tokens.shape
    home = tokens.device
    mesh, rules, groups = _tp_setup(params, cfg, b)
    whole = local_tree(params, 0)
    x = take_rows(params["embed"], tokens).to(cfg.act_dtype)
    x = _residual(x, act_spec(cfg, t), mesh, rules)
    positions = torch.arange(t, dtype=torch.int32,
                             device=home).expand(b, t)
    attn_fn = _prefill_attention(cfg, t)
    cache = init_cache(cfg, b, s_max, device=home, mesh=mesh)
    n1, n2 = cache_names(cfg)
    for i in range(cfg.n_layers):
        lp = _layer(whole["layers"], i)
        h, (c1, c2) = A.prefill_tp(_layer_groups(params, groups, i, "attn"),
                                   _whole(_norm(lp["ln1"], x), home), cfg,
                                   positions, attn_fn)
        A.cache_fill(cache[n1], i, c1)
        A.cache_fill(cache[n2], i, c2)
        x = _add(x, h)
        x = _add(x, M.ffn_tp(_layer_groups(params, groups, i, "ffn"),
                             _whole(_norm(lp["ln2"], x), home), cfg))
    last = rms_norm(whole["ln_f"].to(home), _whole(x, home)[:, -1])
    cache["lengths"].fill_(t)
    return split_logits(last, params["lm_head"]), cache


def _decode_step_tp(params: dict, cache: dict, token: torch.Tensor,
                    cfg: TransformerConfig):
    home = token.device
    mesh, rules, groups = _tp_setup(params, cfg, token.shape[0])
    n1, n2 = cache_names(cfg)
    if not isinstance(cache[n1], Placed):
        raise ValueError("the tensor-parallel decode runs on a cache laid "
                         "out over the mesh (init_cache(..., mesh=) or the "
                         "tensor-parallel prefill)")
    whole = local_tree(params, 0)
    x = take_rows(params["embed"], token[:, None]).to(cfg.act_dtype)
    x = _residual(x, ACT, mesh, rules)
    lengths = cache["lengths"]
    decode = A.mla_decode_tp if cfg.attn == "mla" else A.gqa_decode_tp
    for i in range(cfg.n_layers):
        lp = _layer(whole["layers"], i)
        x = _add(x, decode(_layer_groups(params, groups, i, "attn"),
                           _whole(_norm(lp["ln1"], x), home), cache[n1],
                           cache[n2], i, lengths, cfg))
        x = _add(x, M.ffn_tp(_layer_groups(params, groups, i, "ffn"),
                             _whole(_norm(lp["ln2"], x), home), cfg))
    last = rms_norm(whole["ln_f"].to(home), _whole(x, home)[:, 0])
    return (split_logits(last, params["lm_head"]),
            {n1: cache[n1], n2: cache[n2], "lengths": lengths + 1})


# -------------------------------------------------------------------------
# FSDP training on a placed tree (module doc)
# -------------------------------------------------------------------------
def check_fsdp(cfg: TransformerConfig, mesh, batch: int) -> None:
    """Raise ``ValueError`` unless the FSDP train path can run ``cfg`` on
    ``mesh`` at a global batch of ``batch``: the ``model`` size divides
    the padded heads, the padded vocabulary, the FFN's width and the
    experts, and the ``data`` size divides ``d_model`` (``embed``,
    ``expert_embed``) and the batch.  ``cfg.tp`` need not be the
    ``model`` size (module doc)."""
    grid = entry_grid(mesh)
    p_data, p_model = len(grid), len(grid[0])
    dims = [("heads", cfg.padded_heads, p_model),
            ("vocab", cfg.padded_vocab, p_model),
            ("mlp", cfg.moe_shared * cfg.moe_d_ff if cfg.is_moe
             else cfg.d_ff, p_model),
            ("embed", cfg.d_model, mesh.shape.get("data", 1)),
            ("batch", batch, p_data)]
    if cfg.is_moe:
        dims.append(("experts", cfg.moe_experts, p_model))
    for name, n, p in dims:
        if n % p:
            raise ValueError(f"{cfg.name}: {name} ({n}) does not split "
                             f"evenly over {p} mesh entries")


def _fsdp_layer(layers: dict, x, i: int, cfg: TransformerConfig, grid,
                rows, positions, home):
    """Layer ``i`` on the placed tree: the norms on the residual's
    shards, each entry's heads and FFN slice (or experts) on its
    gathered view of the layer, the partial outputs summed in entry
    order.  Returns (x, aux loss or None)."""
    e0 = grid[0][0][0]

    def groups(part, skip=()):
        tree = {k: v for k, v in layers[part].items() if k not in skip}
        return row_groups([(b0, b1, row) for (b0, b1), row in
                           zip(rows, grid)],
                          lambda e: entry_views(tree, e, i))
    h = _whole(_norm(entry_view(layers["ln1"], e0, i), x), home)
    x = _add(x, A.train_tp(groups("attn"), h, cfg, positions))
    h = _whole(_norm(entry_view(layers["ln2"], e0, i), x), home)
    if not cfg.is_moe:
        return _add(x, M.ffn_tp(groups("ffn"), h, cfg)), None
    g = groups("ffn", skip=("router",))
    dev, first, _ = g[0][2][0]
    # route runs whole on one entry's view of the router
    g[0][2][0] = (dev, dict(first, router=entry_view(
        layers["ffn"]["router"], e0, i)), e0)
    f, aux = M.moe_ffn_tp(g, h, cfg)
    return _add(x, f), aux


def _sequence_ce_tp(x: torch.Tensor, labels: torch.Tensor, *heads):
    """One sequence's mean cross-entropy against the logit columns of
    the head's blocks ``heads`` (:func:`common.split_logits`)."""
    return softmax_cross_entropy(split_logits(x, list(heads)), labels)


def _fsdp_train_loss(params: dict, batch: dict, cfg: TransformerConfig):
    """``make_train_loss`` on a tree laid out through ``FSDP_TP``."""
    mesh = params["embed"].sharding.mesh
    home = mesh.devices.flat[0]
    tokens, labels = (_whole(batch[k], home) for k in ("tokens", "labels"))
    b, t = tokens.shape
    check_fsdp(cfg, mesh, b)
    grid = entry_grid(mesh)
    rows = [block_bounds((b,), (len(grid),), (d,))[0]
            for d in range(len(grid))]
    rules = SH.active_rules() or SH.FSDP_TP
    xs = []
    for (b0, b1), row in zip(rows, grid):
        blocks = [entry_bounds(params["embed"], e)[0] +
                  (entry_view(params["embed"], e),) for e, _ in row]
        xs.append(take_rows(blocks, tokens[b0:b1].to(row[0][1])).to(home))
    x = _residual(torch.cat(xs).to(cfg.act_dtype), act_spec(cfg, t), mesh,
                  rules)
    positions = torch.arange(t, dtype=torch.int32, device=home).expand(b, t)
    auxes = []
    for i in range(cfg.n_layers):
        args = (params["layers"], x, i, cfg, grid, rows, positions, home)
        if cfg.remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                as_controller(_fsdp_layer), *args, use_reentrant=False)
        else:
            x, aux = _fsdp_layer(*args)
        if aux is not None:
            auxes.append(aux)
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=home))
    x = _whole(_norm(entry_view(params["ln_f"], grid[0][0][0]), x), home)
    x, labels = x[:, :-1], labels[:, 1:]
    total = 0
    for (b0, b1), row in zip(rows, grid):
        heads = [entry_view(params["lm_head"], e) for e, _ in row]
        for i in range(b0, b1):
            total = total + torch.utils.checkpoint.checkpoint(
                as_controller(_sequence_ce_tp), x[i], labels[i], *heads,
                use_reentrant=False)
    return total / b + cfg.aux_loss_weight * aux
