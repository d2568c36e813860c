"""Train an EGNN potential on synthetic molecule batches (the GNN
``molecule`` shape at example scale) and verify rotation invariance of
the learned energies.

Run:  python -m repro_torch.examples.gnn_molecule [--steps 40]
"""

import argparse
import dataclasses

import numpy as np
import torch
import torch.func

from repro_torch.core.graph import resolve_device
from repro_torch.data import molecule_batch
from repro_torch.models.gnn import egnn
from repro_torch.models.gnn.graph import from_numpy
from repro_torch.train import loop, optimizer as opt


def make_batch(step, batch=16, n_nodes=8, n_edges=16, d_feat=8,
               device="cuda"):
    raw = molecule_batch(step, batch, n_nodes, n_edges, d_feat, seed=0)
    gb = from_numpy(raw["node_feat"], raw["senders"], raw["receivers"],
                    pos=raw["pos"], graph_id=raw["graph_id"],
                    n_graph=raw["n_graph"], device=device)
    # synthetic learnable target: summed pairwise-distance energy
    pos = raw["pos"]
    e = []
    for g in range(raw["n_graph"]):
        p = pos[raw["graph_id"] == g]
        d = np.linalg.norm(p[:, None] - p[None, :], axis=-1)
        e.append(d.sum() / len(p) ** 2)
    target = torch.from_numpy(np.asarray(e, np.float32)[:, None]).to(device)
    return gb, target


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = egnn.EGNNConfig(n_layers=3, d_hidden=32, d_in=8)
    model = egnn.EGNN(cfg, generator=torch.Generator().manual_seed(0),
                      device=dev)
    params = {k: p.detach() for k, p in model.named_parameters()}
    loss_fn = egnn.make_loss(model)
    ocfg = opt.AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=args.steps,
                           weight_decay=0.0)
    lcfg = loop.LoopConfig(total_steps=args.steps, log_every=5)
    params, _, hist = loop.run(
        params, loss_fn, lambda step: make_batch(step, device=dev), ocfg,
        lcfg)
    print("loss trajectory:", [round(h["loss"], 4) for h in hist])
    assert hist[-1]["loss"] < hist[0]["loss"], "no learning progress"

    # rotation invariance of the trained model
    gb, tgt = make_batch(0, device=dev)
    with torch.no_grad():
        e1 = torch.func.functional_call(model, params, (gb,))[0]
        A = np.random.default_rng(7).normal(size=(3, 3))
        Q, R = np.linalg.qr(A)
        Q = (Q * np.sign(np.diag(R))).astype(np.float32)
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        gb_rot = dataclasses.replace(
            gb, pos=gb.pos @ torch.from_numpy(Q).to(dev).T)
        e2 = torch.func.functional_call(model, params, (gb_rot,))[0]
    err = float((e1 - e2).abs().max())
    print(f"rotation-invariance max err: {err:.2e}")
    assert err < 1e-3
    print("done.")


if __name__ == "__main__":
    main()
