"""DIEN: Deep Interest Evolution Network [Zhou et al., arXiv:1809.03672].

Port of ``repro.models.dien``.  CTR model over user behavior sequences:

  1. **Embedding layer** -- item + category id embeddings plus multi-hot
     user profile fields, each bag gathered and averaged (the
     reference's ``jnp.take`` + mean, not the ``embedding_bag`` kernel,
     which sums).
  2. **Interest extractor** -- GRU over the behavior sequence, with the
     auxiliary loss (next-behavior discrimination vs sampled negatives).
  3. **Interest evolution** -- attention scores between the target item
     and extractor states drive an **AUGRU** (GRU whose update gate is
     scaled by the attention weight).
  4. **MLP head** -- mlp=200-80 -> logit (PReLU activations).

The GRU is the reference's, not ``torch.nn.GRU``'s: the reset gate
multiplies the state *before* its product with the candidate columns of
``wh`` (``(r * h) @ wh[:, 2H:]``) and the candidate bias is added once.
Each step takes ``x_t @ wx`` once for all three gates (the reference
takes the candidate columns twice) and ``h @ wh`` only over the gate
columns it uses (the reference also computes, and drops, the candidate
columns); every element is the same dot product.  The product stays
inside the step: one over all T before the loop would hold a [B, T, 3H]
float32 tensor, 8.5 GB at train_batch and 34 GB at serve_bulk.  A
masked step keeps its state.

Parameters are a nested dict of tensors in the reference's tree and
``[in, out]`` layout (``head`` and ``aux`` lists of ``{"w", "b", "p"}``
layers), so :func:`load_reference_params` copies the reference's tree.
``param_specs`` are the reference's logical specs: the three tables on
``table_rows`` (-> ``model``), the rest replicated.  ``place_params``
lays the tables out over a mesh by them, and the embedding reads then
run shard by shard: each shard takes the ids in its row range on its own
device and gives zeros for the others, and the shards' rows are summed
in shard order on the ids' device -- one row plus zeros, so the result
equals the unsharded gather bit for bit.  ``unroll_scans`` has no
effect here.

Shapes: ``train_batch`` (65536) runs the train step; ``serve_p99`` /
``serve_bulk`` the scoring forward; ``retrieval_cand`` scores one user
state against 10^6 candidates as one batched dot against the item table
(the two-tower retrieval pattern, not a per-candidate AUGRU).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.core.graph import resolve_device
from repro_torch.launch.mesh import Placed, place
from repro_torch.models.common import dense_init, load_tree


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    """The reference's config; ``dtype`` is a torch dtype."""
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple = (200, 80)
    n_items: int = 4_000_000
    n_cates: int = 10_000
    n_profile_vocab: int = 100_000   # hashed multi-hot profile features
    profile_bags: int = 4            # multi-hot fields
    bag_size: int = 8                # ids per bag
    aux_weight: float = 1.0
    dtype: Any = torch.float32
    unroll_scans: bool = False       # kept for the reference's field set

    @property
    def beh_dim(self) -> int:        # item + cate embedding concat
        return 2 * self.embed_dim


# -------------------------------------------------------------------------
# Params
# -------------------------------------------------------------------------
def _gru_init(d_in: int, d_h: int, **kw) -> dict:
    return {"wx": dense_init(d_in, 3 * d_h, **kw),    # update/reset/cand
            "wh": dense_init(d_h, 3 * d_h, **kw),
            "b": torch.zeros((3 * d_h,), dtype=kw["dtype"],
                             device=kw["device"])}


def _mlp_init(dims, **kw) -> list:
    return [{"w": dense_init(a, b, **kw),
             "b": torch.zeros((b,), dtype=kw["dtype"], device=kw["device"]),
             "p": torch.full((b,), 0.25, dtype=kw["dtype"],
                             device=kw["device"])}           # PReLU slope
            for a, b in zip(dims[:-1], dims[1:])]


def init_params(cfg: DIENConfig, *, generator=None, device="cuda") -> dict:
    """Random parameters in the reference's tree, drawn in its order with
    a ``torch.Generator`` (default: seed 0 on ``device``).  The numbers
    differ from ``jax.random``'s; tests carry the reference's across with
    :func:`load_reference_params`."""
    dev = resolve_device(device)
    if generator is None:
        # torch.Generator takes no meta device; nothing is drawn there
        generator = torch.Generator(
            "cpu" if dev.type == "meta" else dev).manual_seed(0)
    kw = dict(generator=generator, dtype=cfg.dtype, device=dev)
    d, h, e = cfg.beh_dim, cfg.gru_dim, cfg.embed_dim
    head_in = h + d + cfg.profile_bags * e
    return {
        "item_table": dense_init(cfg.n_items, e, scale=0.01, **kw),
        "cate_table": dense_init(cfg.n_cates, e, scale=0.01, **kw),
        "profile_table": dense_init(cfg.n_profile_vocab, e, scale=0.01,
                                    **kw),
        "gru": _gru_init(d, h, **kw),
        "augru": _gru_init(d, h, **kw),
        "attn": dense_init(h, d, **kw),
        "head": _mlp_init((head_in,) + tuple(cfg.mlp) + (1,), **kw),
        "aux": _mlp_init((h + d, 100, 1), **kw),
    }


def load_reference_params(tree, *, device="cuda") -> dict:
    """The reference's parameter tree (``dien.init_params``, leaves as
    numpy arrays) as the same tree of tensors on ``device``."""
    return load_tree(tree, device=device)


#: The embedding tables, and their logical spec: rows over "table_rows".
TABLES = ("item_table", "cate_table", "profile_table")
TABLE_SPEC = ("table_rows", None)


def param_specs(cfg: DIENConfig) -> dict:
    """The logical specs of :func:`init_params`' tree (the reference's,
    ``dien.py:104``): the tables row-sharded, the rest replicated."""
    return {
        **dict.fromkeys(TABLES, TABLE_SPEC),
        "gru": {"wx": (), "wh": (), "b": ()},
        "augru": {"wx": (), "wh": (), "b": ()},
        "attn": (),
        "head": [{"w": (), "b": (), "p": ()}
                 for _ in range(len(cfg.mlp) + 1)],
        "aux": [{"w": (), "b": (), "p": ()} for _ in range(2)],
    }


def place_params(params: dict, mesh) -> dict:
    """``params`` with the tables laid out over ``mesh`` by their
    :func:`param_specs` through ``FSDP_TP`` (rows over ``model``); the
    other leaves stay whole where they are."""
    sharding = SH.resolve(TABLE_SPEC, SH.FSDP_TP, mesh)
    return dict(params, **{name: place(params[name], sharding)
                           for name in TABLES})


def take_rows(table, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a whole or a placed table ([V, D]).  Placed:
    each row shard (the first copy of each block) takes the ids in its
    range on its device, zeros for the others, and the shards' rows are
    added in shard order on ``ids``' device; negative ids count from the
    end, as whole-tensor indexing reads them."""
    if not isinstance(table, Placed):
        return table[ids]
    if any(p != 1 for p in table.parts[1:]):
        raise ValueError(f"a table splits only its rows, got "
                         f"{table.sharding.spec}")
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids)
    out = None
    for key, bounds, shard in table.blocks:
        lo, hi = bounds[0]
        if hi == lo:
            continue
        local = ids.to(key[1]) - lo
        hit = (local >= 0) & (local < hi - lo)
        rows = torch.where(hit[..., None], shard[local.clamp(0, hi - lo - 1)],
                           0).to(ids.device)
        out = rows if out is None else out + rows
    return out


def _prelu_mlp(layers, x: torch.Tensor, last_linear: bool = True):
    for i, lay in enumerate(layers):
        x = x @ lay["w"] + lay["b"]
        if i < len(layers) - 1 or not last_linear:
            x = torch.where(x >= 0, x, lay["p"] * x)
    return x


# -------------------------------------------------------------------------
# Embedding ops
# -------------------------------------------------------------------------
def behavior_embed(params, item_ids, cate_ids) -> torch.Tensor:
    """[B, T] ids -> [B, T, 2 * embed_dim]."""
    return torch.cat([take_rows(params["item_table"], item_ids),
                      take_rows(params["cate_table"], cate_ids)], dim=-1)


def profile_embed(params, bag_ids, cfg: DIENConfig) -> torch.Tensor:
    """bag_ids int [B, bags, bag_size] -> [B, bags * embed_dim]: each
    bag's rows gathered and averaged over all ``bag_size`` ids, as the
    reference's code does (its docstring's zero pad row is not enforced:
    the row is drawn at random and the batches draw no pads)."""
    b = bag_ids.shape[0]
    return take_rows(params["profile_table"], bag_ids).mean(dim=2).reshape(
        b, -1)


# -------------------------------------------------------------------------
# GRU / AUGRU
# -------------------------------------------------------------------------
def _gru_cell(p, h, x, a=None):
    """The reference's GRU step (``dien.py:152``); with ``a`` the update
    gate is scaled by it (AUGRU, [arXiv:1809.03672] eq. 7-8)."""
    dh = h.shape[-1]
    xw = x @ p["wx"]
    gates = xw[..., :2 * dh] + h @ p["wh"][:, :2 * dh] + p["b"][:2 * dh]
    u = torch.sigmoid(gates[..., :dh])
    r = torch.sigmoid(gates[..., dh:])
    c = torch.tanh(xw[..., 2 * dh:] + (r * h) @ p["wh"][:, 2 * dh:]
                   + p["b"][2 * dh:])
    if a is not None:
        u = a * u
    return (1.0 - u) * h + u * c


def _scan(p, xs, mask, att=None, keep_states: bool = True):
    """The masked GRU (or, with ``att`` [B, T], AUGRU) over [B, T, D]:
    all states [B, T, H], or the last one [B, H]."""
    b, t, _ = xs.shape
    h = xs.new_zeros((b, p["wh"].shape[0]))
    states = []
    for i in range(t):
        a = None if att is None else att[:, i, None]
        h = torch.where(mask[:, i, None], _gru_cell(p, h, xs[:, i], a=a), h)
        if keep_states:
            states.append(h)
    return torch.stack(states, dim=1) if keep_states else h


def run_gru(p, xs, mask) -> torch.Tensor:
    """xs [B, T, D], mask bool [B, T] -> all hidden states [B, T, H]."""
    return _scan(p, xs, mask)


def run_augru(p, xs, att, mask) -> torch.Tensor:
    """AUGRU: att [B, T] attention scores scale the update gate; returns
    the final state [B, H]."""
    return _scan(p, xs, mask, att=att, keep_states=False)


# -------------------------------------------------------------------------
# Forward / losses
# -------------------------------------------------------------------------
def interest_states(params, batch, cfg: DIENConfig):
    """Behavior GRU states (target-independent) and the behaviour
    embeddings: ([B, T, H], [B, T, 2E])."""
    beh = behavior_embed(params, batch["hist_items"], batch["hist_cates"])
    return run_gru(params["gru"], beh, batch["hist_mask"]), beh


def _evolve(params, batch, hs, beh, cfg: DIENConfig) -> torch.Tensor:
    """The CTR logit [B] from the extractor's states and embeddings."""
    tgt = behavior_embed(params, batch["target_item"][:, None],
                         batch["target_cate"][:, None])[:, 0]   # [B, D]
    # attention: a_t = softmax(h_t W e_tgt)
    scores = torch.bmm(hs, (tgt @ params["attn"].T)[..., None])[..., 0]
    scores = torch.where(batch["hist_mask"], scores, -1e30)
    att = torch.softmax(scores, dim=-1)
    final = run_augru(params["augru"], beh, att, batch["hist_mask"])
    prof = profile_embed(params, batch["profile"], cfg)
    feats = torch.cat([final, tgt, prof], dim=-1)
    return _prelu_mlp(params["head"], feats)[..., 0]


def forward(params, batch, cfg: DIENConfig) -> torch.Tensor:
    """CTR logit per example.

    batch: hist_items/hist_cates int [B, T], hist_mask bool [B, T],
    target_item/target_cate int [B], profile int [B, bags, bag_size],
    tensors on the parameters' device."""
    hs, beh = interest_states(params, batch, cfg)
    return _evolve(params, batch, hs, beh, cfg)


def aux_loss(params, hs, beh, neg_beh, mask) -> torch.Tensor:
    """Auxiliary loss: h_t should score e_{t+1} over sampled negatives."""
    h = hs[:, :-1]                                  # [B, T-1, H]
    pos = beh[:, 1:]
    neg = neg_beh[:, 1:]
    m = mask[:, 1:].to(h.dtype)
    pos_logit = _prelu_mlp(params["aux"], torch.cat([h, pos], -1))[..., 0]
    neg_logit = _prelu_mlp(params["aux"], torch.cat([h, neg], -1))[..., 0]
    ll = (F.logsigmoid(pos_logit) + F.logsigmoid(-neg_logit)) * m
    return -ll.sum() / torch.clamp(m.sum(), min=1.0)


def make_train_loss(cfg: DIENConfig):
    """loss_fn(params, batch) -> scalar: the mean CTR cross-entropy plus
    ``aux_weight`` times :func:`aux_loss`.  The reference's ``forward``
    runs the extractor GRU a second time; here its states are computed
    once and serve both terms (the same numbers)."""
    def loss_fn(params, batch):
        hs, beh = interest_states(params, batch, cfg)
        neg_beh = behavior_embed(params, batch["neg_items"],
                                 batch["neg_cates"])
        aux = aux_loss(params, hs, beh, neg_beh, batch["hist_mask"])
        logits = _evolve(params, batch, hs, beh, cfg)
        y = batch["label"].to(logits.dtype)
        ce = -torch.mean(y * F.logsigmoid(logits)
                         + (1 - y) * F.logsigmoid(-logits))
        return ce + cfg.aux_weight * aux
    return loss_fn


def retrieval_scores(params, batch, candidate_ids,
                     cfg: DIENConfig) -> torch.Tensor:
    """Score one (or few) users against N candidates: the user vector is
    the last valid extractor state (position ``max(length - 1, 0)``)
    projected through ``attn``; scores are its dot with each candidate's
    item + cate embedding.  Returns [B, N]."""
    hs, _ = interest_states(params, batch, cfg)
    lengths = batch["hist_mask"].sum(dim=-1)
    last = hs[torch.arange(hs.shape[0], device=hs.device),
              torch.clamp(lengths - 1, min=0)]
    user_vec = last @ params["attn"]                # [B, beh_dim]
    cand = behavior_embed(params, candidate_ids["item"],
                          candidate_ids["cate"])    # [N, beh_dim]
    return user_vec @ cand.T


__all__ = ["DIENConfig", "TABLES", "aux_loss", "behavior_embed",
           "forward", "init_params", "interest_states",
           "load_reference_params", "make_train_loss", "param_specs",
           "place_params", "profile_embed", "retrieval_scores",
           "run_augru", "run_gru", "take_rows"]
