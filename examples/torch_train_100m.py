"""End-to-end driver of the PyTorch port: train a ~100M-param decoder for a
few hundred steps on the synthetic HMM corpus, with the scalability
advisor probing gradient characters along the way (the port's
counterpart of examples/train_100m.py, printing the same lines).

  PYTHONPATH=src python examples/torch_train_100m.py --steps 300      (GPU)
  PYTHONPATH=src python examples/torch_train_100m.py --device cpu \\
      --steps 2 --batch-size 2 --seq-len 16
(defaults to 60 steps; the reference expects the loss to drop from
~ln(8192)=9.0 to well under 5 by step 300.)  On the GPU the advisor's
probes (steps 50, 100, ...) run the L0 kernels (K1, K2) on the two
half-batch gradients; the train steps themselves run no kernel.
"""

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.train import train_loop
from repro_torch.models import model as M

# ~100M params: 12L, d=768, MHA 12 heads, SwiGLU ff 2048, vocab 8192
CONFIG_100M = ArchConfig(
    name="examples-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=8192,
    rope_theta=10000.0,
    mlp_kind="swiglu",
    norm="rmsnorm",
    max_seq_len=1024,
    dtype="float32",
    source="examples",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_params = sum(p.numel() for p in M.init_params(
        CONFIG_100M, device="meta").parameters())
    print(f"examples-100m: {n_params / 1e6:.1f}M params")
    train_loop(CONFIG_100M, steps=args.steps, batch_size=args.batch_size,
               seq_len=args.seq_len, lr=args.lr, log_every=10,
               advisor_every=50, ckpt=args.ckpt, device=dev)


if __name__ == "__main__":
    main()
