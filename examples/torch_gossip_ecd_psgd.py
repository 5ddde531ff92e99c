"""ECD-PSGD as a production exchange strategy in the PyTorch port: 4 model
replicas on a ring exchanging stochastically quantized extrapolation
variables (paper Alg 4), the port's counterpart of
examples/gossip_ecd_psgd.py, printing the same lines.

  PYTHONPATH=src python examples/torch_gossip_ecd_psgd.py            (GPU)
  PYTHONPATH=src python examples/torch_gossip_ecd_psgd.py --device cpu
  PYTHONPATH=src python examples/torch_gossip_ecd_psgd.py --ranks 8 \\
      --device cpu
  PYTHONPATH=src python examples/torch_gossip_ecd_psgd.py --device cpu \\
      --steps 2

``--ranks`` and ``--steps`` (default 8, the reference's) are the port's
own flags. The reference runs its 4 replicas on a (data 4, model 2) mesh
of 8 host devices. One GPU cannot hold an 8-rank NCCL group, so by
default the 4 replicas are stacked on the given device (``mesh=None``),
the same computation; ``--ranks 8`` spawns 8 gloo ranks on the CPU on
``make_debug_mesh(data=4, model=2)``, one replica per data coordinate.
On the GPU every step quantizes and dequantizes each replica's leaves
with K3 and K4, twice a leaf.
"""

import argparse
import os
import socket
import tempfile

import torch

from repro_torch import random as R
from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.train.steps import init_gossip_state, make_gossip_step

REPLICAS, LR, BITS = 4, 2e-3, 8


def _batch(cfg, dev):
    key = R.PRNGKey(0, device=dev)
    tokens = R.randint(key, (8, 32), 0, cfg.vocab_size)
    return {"tokens": tokens, "labels": tokens}


def _report(losses, p0):
    print("gossip losses:", [round(x, 4) for x in losses])
    assert losses[-1] < losses[0], "gossip should descend on a fixed batch"
    # replicas should agree approximately after ring averaging rounds
    spread = float((p0 - p0.mean(0, keepdim=True)).abs().max())
    print("replica spread:", spread, "OK")


def run_stacked(dev, steps):
    """``steps`` steps of the 4 replicas stacked on ``dev``; returns the
    losses and the stacked leaf 3."""
    cfg = get_arch("gemma3-1b").reduced()
    step = make_gossip_step(cfg, replicas=REPLICAS, lr=LR,
                            compress_bits=BITS)
    state = init_gossip_state(
        cfg, REPLICAS, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    batch = _batch(cfg, dev)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, T.flatten(state["params"])[0][3]


def _rank(rank, world, port, out, steps):
    import torch.distributed as dist
    from repro_torch.distributed.mesh import make_debug_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(data=REPLICAS, model=world // REPLICAS,
                               device_type="cpu")
        cfg = get_arch("gemma3-1b").reduced()
        step = make_gossip_step(cfg, mesh, lr=LR, compress_bits=BITS)
        state = init_gossip_state(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu",
            mesh=mesh)
        batch = _batch(cfg, torch.device("cpu"))
        losses = []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        p0 = T.flatten(state["params"])[0][3].full_tensor()
        if rank == 0:
            torch.save({"losses": losses, "p0": p0}, out)
    finally:
        dist.destroy_process_group()


def run_ranks(ranks, steps):
    """``steps`` steps on ``ranks`` gloo ranks on a (data 4, model
    ranks/4) mesh; returns the losses and the global leaf 3 (rank 0's,
    handed back in a file)."""
    import torch.multiprocessing as mp
    if ranks % REPLICAS:
        raise ValueError(f"--ranks {ranks}: a multiple of {REPLICAS}")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.pt")
        mp.spawn(_rank, args=(ranks, port, out, steps), nprocs=ranks)
        got = torch.load(out)
    return got["losses"], got["p0"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--ranks", type=int, default=0,
                    help="spawn this many gloo ranks on the CPU (8: the "
                         "reference's data 4 x model 2 mesh)")
    ap.add_argument("--steps", type=int, default=8,
                    help="gossip steps (the reference runs 8)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.ranks:
        if dev.type != "cpu":
            raise ValueError("--ranks runs gloo ranks: pass --device cpu")
        losses, p0 = run_ranks(args.ranks, args.steps)
    else:
        losses, p0 = run_stacked(dev, args.steps)
    _report(losses, p0)


if __name__ == "__main__":
    main()
