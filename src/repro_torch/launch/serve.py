"""Serving launcher: batched greedy decoding against a KV cache, on the GPU
by default.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --requests 4 --prompt-len 16 --gen 24            # reduced config
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced  # full size
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
      --no-reduced                       # also xlstm-350m and
                                         # whisper-small; arctic-480b,
                                         # qwen1.5-110b, qwen2-vl-72b and
                                         # deepseek-v2-236b run reduced
                                         # (their full depth does not
                                         # fit one card)

The flags are the reference's (``repro/launch/serve.py``) plus
``--device``; ``--reduced`` is on by default and ``--no-reduced`` runs the
full configuration.  Weights and prompts are random, from seed 0.  For an
encoder-decoder (whisper-small) the run's generator also draws frames of
0.1 * normal (requests, encoder_seq, d_model), in the model's type; they
are encoded once and every decode step cross-attends to the output.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import greedy_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, dev)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.requests, args.prompt_len),
                            generator=gen, device=dev)
    enc = None
    if cfg.encoder_layers:
        frames = 0.1 * torch.randn(
            (args.requests, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=dev)
        enc = M.encode(params.encoder, cfg,
                       frames.to(params.embed["table"].dtype))
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompts, args.gen, device=dev,
                          enc_out=enc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    total = args.requests * args.gen
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} generated {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, batch={args.requests}, "
          f"device={where})")
    print("sample:", out[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
