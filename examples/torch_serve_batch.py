"""Batched serving with the PyTorch port: mixed prompts, prefill + decode
slots, throughput report (the port's counterpart of
examples/serve_batch.py, printing the same lines).

  PYTHONPATH=src python examples/torch_serve_batch.py --arch zamba2-1.2b
  PYTHONPATH=src python examples/torch_serve_batch.py --device cpu

Prompts (and whisper's frames) are drawn by the port's threefry from
``PRNGKey(0)``, so they equal the reference's; the weights come from a
torch generator seeded with 0.  On the GPU every decode step normalises
through the RMSNorm kernel (K5).
"""

import argparse
import time

import torch

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.models import model as M


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="zamba2-1.2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    key = R.PRNGKey(0, device=dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)

    # mixed-length prompts padded into one batch (left-padding via position)
    lens = [4 + (i * 3) % 12 for i in range(args.requests)]
    max_prompt = max(lens)
    prompts = R.randint(key, (args.requests, max_prompt), 0, cfg.vocab_size)
    enc = None
    if cfg.encoder_layers:
        frames = 0.1 * R.normal(
            key, (args.requests, cfg.encoder_seq, cfg.d_model))
        enc = M.encode(params.encoder, cfg,
                       frames.to(params.embed["table"].dtype))

    state = M.init_decode_state(cfg, args.requests,
                                max_prompt + args.gen + 8, device=dev)

    def decode(p, t, s):
        return M.decode_step(p, cfg, t, s, enc_out=enc)

    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(max_prompt):                      # prefill token-by-token
        logits, state = decode(params, prompts[:, t:t + 1], state)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    tok = torch.argmax(logits[:, -1:, :], -1)
    outs = []
    for _ in range(args.gen):
        outs.append(tok)
        logits, state = decode(params, tok, state)
        tok = torch.argmax(logits[:, -1:, :], -1)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    total = args.requests * args.gen
    print(f"arch={cfg.name} batch={args.requests}")
    print(f"prefill: {max_prompt} steps in {prefill_s:.2f}s")
    print(f"decode: {total} tokens in {decode_s:.2f}s "
          f"({total / decode_s:.1f} tok/s)")
    print("first request:", torch.cat(outs, 1)[0, :12].tolist())


if __name__ == "__main__":
    main()
