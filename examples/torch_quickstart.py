"""Quickstart of the PyTorch port: the public API in ~70 lines (the port's
counterpart of examples/quickstart.py, printing the same lines).

  PYTHONPATH=src python examples/torch_quickstart.py                (GPU)
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

On the GPU the advisor's characters run the L0 kernels (K1, K2), the
decode step the RMSNorm kernel (K5), and step 4 calls K6 and K2 directly;
on the CPU every kernel wrapper runs its plain version.
"""

import argparse
import math

import torch

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.core import metrics
from repro_torch.core.advisor import ScalabilityAdvisor
from repro_torch.data import synth
from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.models import model as M


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    key = R.PRNGKey(0, device=dev)

    # --- 1. the paper in three lines: dataset characters -> scalability advice
    ds = synth.make_realsim_like(key, n=1000, d=400, density=0.03)
    report = ScalabilityAdvisor(device=dev).from_dataset(ds.X, tau_max=8,
                                                         batch_size=8)
    print("dataset characters:", {k: round(float(report[k]), 4)
                                  for k in ("sparsity",
                                            "mean_feature_variance",
                                            "diversity_ratio",
                                            "csim_async")})
    print("predicted Hogwild! m_max:", report["hogwild"]["predicted_m_max"])
    print("advice:", report["recommendation"])

    # --- 2. any of the 10 assigned architectures, reduced
    print("\narchs:", ", ".join(ARCH_IDS))
    cfg = get_arch("gemma3-1b").reduced()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    tokens = R.randint(key, (2, 32), 0, cfg.vocab_size)
    batch = {"tokens": tokens, "labels": tokens}
    loss, aux = M.loss_fn(params, cfg, batch)
    print(f"\n{cfg.name}: loss at init = {float(loss):.3f} "
          f"(ln V = {math.log(cfg.vocab_size):.3f})")

    # --- 3. one decode step against a KV cache
    state = M.init_decode_state(cfg, 2, 64, device=dev)
    logits, state = M.decode_step(params, cfg, batch["tokens"][:, :1], state)
    print("decode_step ->", tuple(logits.shape), "position:",
          int(state["position"]))

    # --- 4. the hand-written kernels (their plain versions on the CPU)
    q = R.normal(key, (1, 128, 4, 64))
    k = R.normal(key, (1, 128, 2, 64))
    v = R.normal(key, (1, 128, 2, 64))
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=True)
    print("flash_attention ->", tuple(out.transpose(1, 2).shape))
    print("csim (paper Eq. 3) of the sparse dataset:",
          float(metrics.csim(ds.X[:256], 8)))


if __name__ == "__main__":
    main()
