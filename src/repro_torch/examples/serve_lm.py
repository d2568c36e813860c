"""Serve a small LM: batched prefill + token-by-token decode with the KV
cache (the serving path of the ``decode_32k`` / ``long_500k`` cells at
production scale).  On the card every decode step's attention is the
flash_decode kernel.

Run:  python -m repro_torch.examples.serve_lm [--tokens 12]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.graph import resolve_device
from repro_torch.models import transformer as tf


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = tf.TransformerConfig(
        name="serve-demo", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_ff=512, vocab=2048, d_head=32, attn="gqa", tp=1, max_seq=128,
        param_dtype=torch.float32, act_dtype=torch.float32)
    params = tf.init_params(cfg, generator=torch.Generator(dev)
                            .manual_seed(0), device=dev)

    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, 16))
                               .astype(np.int32)).to(dev)
    s_max = 16 + args.tokens

    with torch.no_grad():
        t0 = time.perf_counter()
        logits, cache = tf.prefill(params, prompts, cfg, s_max)
        logits.cpu()
        print(f"prefill: {tuple(prompts.shape)} in "
              f"{time.perf_counter() - t0:.3f}s")

        token = logits.argmax(dim=-1).to(torch.int32)
        generated = [token]
        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            logits, cache = tf.decode_step(params, cache, token, cfg)
            token = logits.argmax(dim=-1).to(torch.int32)
            generated.append(token)
        token.cpu()
        dt = time.perf_counter() - t0
        toks = torch.stack(generated, dim=1)
        print(f"decoded {args.tokens - 1} steps x batch {args.batch} in "
              f"{dt:.3f}s ({dt / max(args.tokens - 1, 1) * 1e3:.1f} "
              f"ms/step)")
        print("generated token ids:\n", toks.cpu().numpy())

        # consistency: decode continuation must match a longer prefill
        full = torch.cat([prompts, toks[:, :-1]], dim=1)
        logits_ref, _ = tf.prefill(params, full, cfg, s_max)
        agree = logits_ref.argmax(dim=-1).to(torch.int32) == token
    print(f"decode/prefill agreement on final token: "
          f"{int(agree.sum())}/{args.batch}")
    print("done.")
    return int(agree.sum()), args.batch


if __name__ == "__main__":
    main()
