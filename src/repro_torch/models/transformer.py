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
reference's logical specs (``repro_torch.sharding``).  Of them only the
cache's act here: ``init_cache`` / ``prefill`` with ``mesh=`` lay the
cache out over the mesh (``cache_seq`` -> ``model``: each sequence
shard its own tensor on its entry's device), and ``decode_step`` on such
a cache runs the sequence-sharded decode (``attention.gqa_decode_sharded``,
``mla_decode_sharded``): one flash_decode launch a shard for GQA, the
shards' partial outputs merged by their log-sum-exps.  The weights stay
whole on the controller's device, so ``seq_parallel`` (a layout hint for
XLA's partitioner over a tensor-parallel forward) and ``unroll_scans``
(a cost-analysis mode of XLA) have no effect: the port has no
tensor-parallel forward yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch import sharding as SH
from repro_torch.core.graph import resolve_device
from repro_torch.launch.mesh import Placed, place_zeros
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models.common import (dense_init, init_rms, load_tree,
                                      rms_norm, softmax_cross_entropy)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Every field of the reference's config, so config files read the
    same; ``param_dtype`` and ``act_dtype`` are torch dtypes.

    ``moe_groups`` and ``moe_capacity_factor`` act on one card as on a
    mesh: the dispatch groups and the capacity of each expert in a group
    decide which routed assignments drop (``moe.dispatch_shape``).
    ``remat`` recomputes each layer in ``forward_train``'s backward.
    ``sharded_decode`` sequence-splits a cache laid out over a mesh
    (``cache_specs``); ``seq_parallel`` only chooses ``act_spec`` and
    ``unroll_scans`` has no effect (module doc); ``tp`` pads the query
    heads and the vocabulary."""
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
        generator = torch.Generator(dev).manual_seed(0)
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
    float32 summation order."""
    def loss_fn(params, batch):
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
    filled to length t."""
    b, t = tokens.shape
    x = params["embed"][tokens].to(cfg.act_dtype)
    positions = torch.arange(t, dtype=torch.int32,
                             device=tokens.device).expand(b, t)
    mla = cfg.attn == "mla"
    if t >= cfg.blockwise_prefill_from:
        blockwise = (A.mla_prefill_blockwise if mla
                     else A.gqa_prefill_blockwise)

        def attn_fn(p, h, c, pos):
            return blockwise(p, h, c, pos, block_k=cfg.prefill_block_k)
    else:
        attn_fn = A.mla_train if mla else A.gqa_train
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
    decode (module doc)."""
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
