"""End-to-end LM training driver.

Trains a decoder-only transformer on the synthetic token stream with the
full production loop (AdamW, checkpointing, restart safety).  Presets:

  --preset tiny   ~1M params,   default (finishes in ~a minute on CPU)
  --preset 100m   ~100M params, the "train a ~100M model for a few
                  hundred steps" configuration (use on real hardware;
                  it runs on CPU too, just slowly)

Run:  python -m repro_torch.examples.train_lm --steps 30
"""

import argparse
import tempfile

import torch

from repro_torch.core.graph import resolve_device
from repro_torch.data import lm_batch
from repro_torch.models import transformer as tf
from repro_torch.train import loop, optimizer as opt
from repro_torch.train.checkpoint import flatten


PRESETS = {
    "tiny": tf.TransformerConfig(
        name="tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=2048, d_head=32, attn="gqa", tp=1, max_seq=128,
        param_dtype=torch.float32, act_dtype=torch.float32),
    # ~100M: 12L x 768 with GQA, 32k vocab (GPT-2-small-ish)
    "100m": tf.TransformerConfig(
        name="100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=3072, vocab=32768, d_head=64, attn="gqa", tp=1, max_seq=512,
        param_dtype=torch.float32, act_dtype=torch.float32),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PRESETS[args.preset]
    params = tf.init_params(cfg, generator=torch.Generator(dev)
                            .manual_seed(0), device=dev)
    n_params = sum(x.numel() for x in flatten(params)[0])
    print(f"model {cfg.name}: {n_params / 1e6:.1f}M params")

    loss_fn = tf.make_train_loss(cfg)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)

    def data_fn(step):
        b = lm_batch(step, args.batch, args.seq, cfg.vocab, seed=0)
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    lcfg = loop.LoopConfig(total_steps=args.steps, ckpt_dir=ckpt_dir,
                           ckpt_every=max(args.steps // 3, 5), log_every=1)
    params, state, hist = loop.run(params, loss_fn, data_fn, ocfg, lcfg)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    for h in hist:
        print(f"  step-loss {h['loss']:.4f}  lr {h['lr']:.2e} "
              f"gnorm {h['grad_norm']:.2f}")
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'}); "
          f"checkpoints in {ckpt_dir}")
    return first, last


if __name__ == "__main__":
    main()
