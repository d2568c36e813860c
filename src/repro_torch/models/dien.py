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

FSDP training: ``make_train_loss`` on a tree laid out by ``param_specs``
through ``FSDP_TP`` (``launch.steps``' ``place_args``; the batch over
``data``) runs each data row on its batch rows, on its first entry's
views of the replicated leaves and on the row blocks of the tables that
its ``model`` entries hold (``launch.mesh.entry_view``).  A table's
gradient lands on its row shards, rows outside a shard's range adding
zero, and ``launch.mesh.ShardGrads`` sums the data rows' gradients in
data order.  The rows' per-example terms are joined in data order
before the means, so at one data row the loss is the one-device loss
bit for bit.

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
from repro_torch.launch.mesh import (Placed, block_bounds, collect,
                                     entry_bounds, entry_grid, entry_view,
                                     entry_views, gather, place, working)
from repro_torch.models.common import dense_init, load_tree, take_rows


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
    tensors on the parameters' device.  Given a tree laid out by
    ``param_specs`` (and the batch by ``batch``), each data row scores
    its batch rows (:func:`_per_row`); with only the tables placed
    (:func:`place_params`) the tables are read where they lie."""
    if isinstance(params["attn"], Placed):
        return _per_row(params, batch, lambda p, rows: forward(p, rows, cfg))
    hs, beh = interest_states(params, batch, cfg)
    return _evolve(params, batch, hs, beh, cfg)


def _aux_terms(params, hs, beh, neg_beh, mask):
    """The auxiliary loss's masked log-likelihoods and mask, [B, T-1]."""
    h = hs[:, :-1]                                  # [B, T-1, H]
    pos = beh[:, 1:]
    neg = neg_beh[:, 1:]
    m = mask[:, 1:].to(h.dtype)
    pos_logit = _prelu_mlp(params["aux"], torch.cat([h, pos], -1))[..., 0]
    neg_logit = _prelu_mlp(params["aux"], torch.cat([h, neg], -1))[..., 0]
    return (F.logsigmoid(pos_logit) + F.logsigmoid(-neg_logit)) * m, m


def aux_loss(params, hs, beh, neg_beh, mask) -> torch.Tensor:
    """Auxiliary loss: h_t should score e_{t+1} over sampled negatives."""
    ll, m = _aux_terms(params, hs, beh, neg_beh, mask)
    return -ll.sum() / torch.clamp(m.sum(), min=1.0)


def _loss_terms(params, batch, cfg: DIENConfig):
    """Each example's CTR log-likelihood [B] and the auxiliary loss's
    terms (:func:`_aux_terms`) of a batch."""
    hs, beh = interest_states(params, batch, cfg)
    neg_beh = behavior_embed(params, batch["neg_items"], batch["neg_cates"])
    ll, m = _aux_terms(params, hs, beh, neg_beh, batch["hist_mask"])
    logits = _evolve(params, batch, hs, beh, cfg)
    y = batch["label"].to(logits.dtype)
    return y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits), ll, m


def _loss(ce, ll, m, cfg: DIENConfig) -> torch.Tensor:
    return -torch.mean(ce) + cfg.aux_weight * (
        -ll.sum() / torch.clamp(m.sum(), min=1.0))


def make_train_loss(cfg: DIENConfig):
    """loss_fn(params, batch) -> scalar: the mean CTR cross-entropy plus
    ``aux_weight`` times :func:`aux_loss`.  The reference's ``forward``
    runs the extractor GRU a second time; here its states are computed
    once and serve both terms (the same numbers).  Given a tree laid out
    by ``param_specs`` through ``FSDP_TP`` (module doc), each data row's
    terms come from its batch rows and are joined in data order before
    the means."""
    def loss_fn(params, batch):
        if isinstance(params["item_table"], Placed):
            return _fsdp_train_loss(params, batch, cfg)
        return _loss(*_loss_terms(params, batch, cfg), cfg)
    return loss_fn


def _fsdp_train_loss(params, batch, cfg: DIENConfig):
    """:func:`make_train_loss` on a placed tree: data row d runs on its
    first entry's views of the replicated leaves and on the row blocks
    of the tables its ``model`` entries hold (``launch.mesh.entry_view``;
    a table's gradient lands on its row shards), over its batch rows."""
    mesh = params["item_table"].sharding.mesh
    home = mesh.devices.flat[0]
    grid = entry_grid(mesh)
    b = batch["label"].shape[0]
    if b % len(grid):
        raise ValueError(f"the batch ({b}) does not split evenly over "
                         f"{len(grid)} data rows")
    parts = []
    for d, row in enumerate(grid):
        (b0, b1), = block_bounds((b,), (len(grid),), (d,))
        e, dev = row[0]
        with working(e):
            rows = {k: _rows(v, e, b0, b1, dev) for k, v in batch.items()}
            terms = _loss_terms(_row_params(params, row), rows, cfg)
        collect("gather", "all-gather", terms)
        parts.append([x.to(home) for x in terms])
    return _loss(*(torch.cat(xs) for xs in zip(*parts)), cfg)


def _row_params(params, row) -> dict:
    """A data row's weights: its first entry's views of the replicated
    leaves, and each table as the row blocks its ``model`` entries hold
    (``launch.mesh.entry_view``)."""
    e = row[0][0]
    p = entry_views({k: v for k, v in params.items() if k not in TABLES}, e)
    for name in TABLES:
        p[name] = [entry_bounds(params[name], em)[0] +
                   (entry_view(params[name], em),) for em, _ in row]
    return p


def _per_row(params, batch, fn) -> torch.Tensor:
    """``fn(weights, rows)`` for each data row of a placed tree
    (:func:`_row_params`) on its batch rows (``batch`` split evenly over
    the rows, or whole on the first where it does not split), the
    outputs joined in row order on the controller's device."""
    mesh = params["item_table"].sharding.mesh
    home = mesh.devices.flat[0]
    grid = entry_grid(mesh)
    b = batch["hist_mask"].shape[0]
    if b % len(grid):
        grid = grid[:1]
    outs = []
    for d, row in enumerate(grid):
        (b0, b1), = block_bounds((b,), (len(grid),), (d,))
        e, dev = row[0]
        with working(e):
            out = fn(_row_params(params, row),
                     {k: _rows(v, e, b0, b1, dev) for k, v in batch.items()})
        outs.append(out)
    collect("gather", "all-gather", outs)
    return torch.cat([o.to(home) for o in outs])


def _rows(x, entry: int, b0: int, b1: int, dev) -> torch.Tensor:
    """Batch rows [b0, b1) of ``x`` on ``dev``: the shard ``entry`` holds
    where ``x`` is placed with those rows, else a slice."""
    if isinstance(x, Placed):
        if x.bounds(x.entry_keys[entry][0])[0] == (b0, b1):
            return x.shard(entry)
        x = gather(x)
    return x[b0:b1].to(dev)


def retrieval_scores(params, batch, candidate_ids,
                     cfg: DIENConfig) -> torch.Tensor:
    """Score one (or few) users against N candidates: the user vector is
    the last valid extractor state (position ``max(length - 1, 0)``)
    projected through ``attn``; scores are its dot with each candidate's
    item + cate embedding.  Returns [B, N].  On a placed tree each data
    row scores its users (:func:`_per_row`) against every candidate
    (gathered where placed)."""
    if isinstance(params["attn"], Placed):
        cand = {k: gather(v) if isinstance(v, Placed) else v
                for k, v in candidate_ids.items()}
        return _per_row(params, batch, lambda p, rows: retrieval_scores(
            p, rows, {k: v.to(rows["hist_mask"].device)
                      for k, v in cand.items()}, cfg))
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
