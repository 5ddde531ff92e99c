"""Training launcher, on the GPU by default (the port of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --reduced --steps 50 --strategy sync              # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --full --steps 10 --batch-size 8 --seq-len 1024 --lr 3e-4
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --full --steps 5 --batch-size 4 --seq-len 1024 --lr 3e-4

The flags are the reference's plus ``--device`` (``cuda`` by default; a
host without a GPU is an error, never a quiet fall-back to the CPU).
Weights come from a generator seeded with 0 and the batches from
``data.lm.hmm_stream`` under ``random.PRNGKey(0)``; each step is the
train step of ``train.steps.make_train_step`` (AdamW, each layer
recomputed in the backward pass).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import random as R
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.core.advisor import ScalabilityAdvisor
from repro_torch.data.lm import LMConfig, hmm_stream, token_characters
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import model as M
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.steps import (init_train_state, make_train_step,
                                     value_and_grad)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(cfg, *, steps=50, batch_size=8, seq_len=64, lr=1e-3,
               strategy="sync", log_every=10, ckpt=None, advisor_every=0,
               key=None, params=None, device=DEFAULT_DEVICE):
    """Trains ``cfg`` for ``steps`` steps; returns (the trained
    ``CausalLM``, loss history, wall milliseconds of each step).
    ``params`` (a ``CausalLM``) replaces the seeded initial weights; the
    train state copies it and leaves it as it was."""
    dev = resolve_device(device)
    key = key if key is not None else R.PRNGKey(0)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = M.init_params(cfg, gen, dev)
    state = init_train_state(cfg, strategy, params=params)
    del params
    step_fn = make_train_step(cfg, strategy=strategy, lr=lr)

    lm_cfg = LMConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      batch_size=batch_size)

    def loss(model, batch):
        return M.loss_fn(model, cfg, batch)

    adv = ScalabilityAdvisor(device=dev)
    history, step_ms = [], []
    _sync(dev)
    t0 = time.perf_counter()
    dtype = getattr(torch, cfg.dtype)
    for step, batch in enumerate(hmm_stream(key, lm_cfg, steps, device=dev)):
        if cfg.vision_tokens:
            batch["vision_embeds"] = torch.zeros(
                (batch_size, cfg.vision_tokens, cfg.d_model), dtype=dtype,
                device=dev)
        if cfg.encoder_layers:
            batch["frames"] = torch.zeros(
                (batch_size, cfg.encoder_seq, cfg.d_model), dtype=dtype,
                device=dev)
        ts = time.perf_counter()
        state, metrics = step_fn(state, batch)
        history.append(float(metrics["loss"]))      # waits for the step
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if step % log_every == 0:
            msg = f"step {step:4d} loss {history[-1]:.4f}"
            if advisor_every and step and step % advisor_every == 0:
                # split the batch in two shards and probe gradient characters
                half = batch_size // 2
                shards = [{k: v[:half] for k, v in batch.items()},
                          {k: v[half:] for k, v in batch.items()}]
                rep = adv.from_grads([value_and_grad(
                    state["model"], loss, b)[2] for b in shards])
                msg += (f" | advisor: noise={rep['grad_noise_scale']:.3f} "
                        f"m_max_sync~{rep['predicted_m_max_sync']}")
            ch = token_characters(batch["tokens"])
            msg += f" | div={ch['sequence_diversity']:.2f}"
            print(msg)
    dt = time.perf_counter() - t0
    print(f"trained {steps} steps in {dt:.1f}s "
          f"({steps / dt:.2f} it/s), loss {history[0]:.3f} -> "
          f"{history[-1]:.3f}")
    if ckpt:
        save_checkpoint(ckpt, {"params": state["params"]}, step=steps)
        print(f"checkpoint -> {ckpt}")
    return state["model"], history, step_ms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--strategy", default="sync", choices=["sync", "stale"])
    ap.add_argument("--ckpt")
    ap.add_argument("--advisor-every", type=int, default=0)
    ap.add_argument("--json")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} reduced={args.reduced} strategy={args.strategy} "
          f"batch={args.batch_size}x{args.seq_len} device={where}")
    _, history, step_ms = train_loop(
        cfg, steps=args.steps, batch_size=args.batch_size,
        seq_len=args.seq_len, lr=args.lr, strategy=args.strategy,
        ckpt=args.ckpt, advisor_every=args.advisor_every, device=dev)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"arch": args.arch, "history": history,
                       "step_ms": step_ms, "device": where}, f)
    return history


if __name__ == "__main__":
    main()
