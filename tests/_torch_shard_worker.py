"""Worker of ``tests/test_torch_shard.py`` (not collected: no ``test_``
prefix).  ``python tests/_torch_shard_worker.py mesh OUT ARCH...``
spawns 4 gloo ranks on a 2 x 2 (data, model) mesh and holds the sharded
steps of the reduced ARCHs (float32) against ``mesh=None`` on the same
inputs (the train, gossip and serve cases for gemma3-1b and qwen2.5-3b,
the loss, gradient and prefill case for the others); ``... dryrun OUT``
dry-runs every arch's tiny train pair and qwen2.5-3b's tiny decode on a
fake (2, 2, 2) group.  Rank 0 (or the dry run) writes a JSON report to
OUT; the test reads it."""

import json
import os
import socket
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

ARCHS = ("gemma3-1b", "qwen2.5-3b")
# (strategy, accum_mode) per arch: both strategies and both modes
CASES = {"gemma3-1b": (("sync", "explicit"), ("stale", "in-loss")),
         "qwen2.5-3b": (("sync", "in-loss"), ("stale", "explicit"))}
B, SEQ, STEPS, LR = 4, 16, 2, 3e-4
# the other archs: MoE with its experts split over 'model' (arctic-480b),
# Mamba2 with shared attention (zamba2-1.2b)


def _rel(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _train_case(cfg, lm, batch, mesh, strategy, mode, grads=True):
    import torch
    from repro_torch import tree as T
    from repro_torch.train import steps as S
    kw = dict(strategy=strategy, microbatches=2, accum_mode=mode, lr=LR)
    f0, f1 = S.make_train_step(cfg, None, **kw), S.make_train_step(
        cfg, mesh, **kw)
    st0 = S.init_train_state(cfg, strategy, params=lm, device="cpu")
    st1 = S.init_train_state(cfg, strategy, params=lm, device="cpu",
                             mesh=mesh)
    _, _, g0 = f0.grads(st0, batch)
    g_err = None
    if grads:
        _, _, g1 = f1.grads(st1, batch)
        g_err = max(float((a - b.full_tensor()).abs().max())
                    / max(float(a.abs().max()), 1e-30)
                    for a, b in zip(T.flatten(g0)[0], T.flatten(g1)[0]))
    g_top = max(float(a.abs().max()) for a in T.flatten(g0)[0])
    losses, norms = [], []
    for _ in range(STEPS):
        st0, m0 = f0(st0, batch)
        st1, m1 = f1(st1, batch)
        losses.append(abs(float(m0["loss"]) - float(m1["loss"]))
                      / abs(float(m0["loss"])))
        norms.append(abs(float(m0["grad_norm"]) - float(m1["grad_norm"]))
                     / abs(float(m0["grad_norm"])))
    p_top = max(float(a.abs().max()) for a in T.flatten(st0["params"])[0])
    p_err, odd, odd_max, worst = 0.0, 0, 0.0, ""
    for (path, a), b, g in zip(T.flatten_with_path(st0["params"]),
                               T.flatten(st1["params"])[0],
                               T.flatten(g0)[0]):
        d = (a - b.full_tensor()).abs()
        # the model's largest weight sets the scale: a bias that starts
        # at 0 holds only AdamW's lr-sized moves
        tol = 1e-5 * p_top
        # AdamW normalises each coordinate by its own gradient: a gradient
        # below 1e-4 of the largest carries summation-order noise of 1e-3
        # of itself and more, which AdamW turns into moves of that share
        # of lr; such coordinates are held to 2 lr a step instead
        # (AdamW.s first update is lr * g / (|g| + eps): +-lr for any g
        # far above eps, so float noise in a vanishing gradient moves
        # such a coordinate by up to 2 lr a step
        vanishing = g.abs() < 1e-4 * g_top
        bad = d > tol
        odd += int((bad & vanishing).sum())
        odd_max = max(odd_max, float(d[vanishing].max()) if bool(
            vanishing.any()) else 0.0)
        if bool((bad & ~vanishing).any()):
            e = float(d[bad & ~vanishing].max()) / p_top
            if e > p_err:
                p_err, worst = e, f"{path} g={float(g.abs().max()):.3g} top={g_top:.3g}"
    return {"loss": max(losses), "grad_norm": max(norms), "grads": g_err,
            "params": p_err, "worst": worst, "vanishing_moved": odd,
            "vanishing_max": odd_max, "vanishing_bound": 2 * LR * STEPS}


def _gossip(cfg, lm, batch, mesh):
    from repro_torch import tree as T
    from repro_torch.train import steps as S
    st0 = S.init_gossip_state(cfg, 2, params=lm, device="cpu")
    st1 = S.init_gossip_state(cfg, params=lm, device="cpu", mesh=mesh)
    f0 = S.make_gossip_step(cfg, None, replicas=2)
    f1 = S.make_gossip_step(cfg, mesh)
    losses = []
    for _ in range(STEPS):
        st0, m0 = f0(st0, batch)
        st1, m1 = f1(st1, batch)
        losses.append(abs(float(m0["loss"]) - float(m1["loss"]))
                      / abs(float(m0["loss"])))
    p = max(_rel(b.full_tensor(), a) for a, b in zip(
        T.flatten(st0["params"])[0], T.flatten(st1["params"])[0]))
    return {"loss": max(losses), "params": p}


def _family(cfg, lm, batch, mesh):
    """One sync step's loss and gradient leaves, and the prefill logits,
    sharded against ``mesh=None`` (the MoE and SSM regions of
    ``distributed/local.py``)."""
    from repro_torch import tree as T
    from repro_torch.distributed import rules as RU
    from repro_torch.serve import engine as E
    from repro_torch.train import steps as S
    st0 = S.init_train_state(cfg, "sync", params=lm, device="cpu")
    st1 = S.init_train_state(cfg, "sync", params=lm, device="cpu",
                             mesh=mesh)
    l0, _, g0 = S.make_train_step(cfg, None).grads(st0, batch)
    l1, _, g1 = S.make_train_step(cfg, mesh).grads(st1, batch)
    prompt = {"tokens": batch["tokens"]}
    p0 = E.make_prefill_step(cfg, "reference")(lm, prompt)
    p1 = E.make_prefill_step(cfg, "reference", constrain=RU.act_constraint(
        mesh))(E.shard_params(lm, mesh), prompt)
    return {"loss": abs(float(l0) - float(l1.full_tensor())) / abs(
                float(l0)),
            "grads": max(_rel(b.full_tensor(), a) for a, b in zip(
                T.flatten(g0)[0], T.flatten(g1)[0])),
            "prefill": _rel(p1, p0)}


def _serve(cfg, lm, batch, mesh):
    import torch
    from repro_torch.distributed import rules as RU
    from repro_torch.serve import engine as E
    slm = E.shard_params(lm, mesh)
    pf0 = E.make_prefill_step(cfg, "reference")
    pf1 = E.make_prefill_step(cfg, "reference",
                              constrain=RU.act_constraint(mesh))
    prompt = {"tokens": batch["tokens"]}
    pre = _rel(pf1(slm, prompt), pf0(lm, prompt))
    sv0 = E.make_serve_step(cfg)
    sv1 = E.make_serve_step(cfg, constrain=RU.decode_act_constraint(mesh))
    s0 = E.init_serve_state(cfg, B, 16, device="cpu")
    s1 = E.shard_serve_state(E.init_serve_state(cfg, B, 16, device="cpu"),
                             mesh)
    tok, same, logit_err = batch["tokens"][:, :1], True, 0.0
    from repro_torch.models import model as M
    for _ in range(8):
        n0, s0 = sv0(lm, s0, tok)
        n1, s1 = sv1(slm, s1, tok)
        same = same and bool(torch.equal(n0, n1))
        tok = n0[:, None]
    # the next logits after the 8 steps, from both caches
    from repro_torch.train.steps import mesh_context
    l0, _ = M.decode_step(lm, cfg, tok, s0["decode"])
    with mesh_context(mesh):
        l1, _ = M.decode_step(slm, cfg, E.place_batch(
            {"tokens": tok}, mesh)["tokens"], s1["decode"],
            constrain=RU.decode_act_constraint(mesh))
        l1 = l1.full_tensor()
    return {"prefill": pre, "decode_tokens_equal": same,
            "decode_logits": _rel(l1, l0)}


def _rank(rank, world, port, out, archs):
    import logging
    import torch
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from repro_torch.configs.registry import get_arch
        from repro_torch.distributed.mesh import make_debug_mesh
        from repro_torch.models import model as M
        mesh = make_debug_mesh(2, 2, device_type="cpu")
        report = {}
        for arch in [a for a in archs if a in ARCHS]:
            cfg = get_arch(arch).reduced()
            lm = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            g = torch.Generator().manual_seed(1)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, SEQ),
                                             generator=g),
                     "labels": torch.randint(-1, cfg.vocab_size, (B, SEQ),
                                             generator=g)}
            # the gradient leaves once per arch: both cases run the same
            # backward pass
            r = {f"{s}-{m}": _train_case(cfg, lm, batch, mesh, s, m,
                                         grads=i == 0)
                 for i, (s, m) in enumerate(CASES[arch])}
            r["gossip"] = _gossip(cfg, lm, batch, mesh)
            r["serve"] = _serve(cfg, lm, batch, mesh)
            report[arch] = r
        for arch in [a for a in archs if a not in ARCHS]:
            cfg = get_arch(arch).reduced()
            lm = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            g = torch.Generator().manual_seed(1)
            batch = {k: torch.randint(0, cfg.vocab_size, (B, SEQ),
                                      generator=g)
                     for k in ("tokens", "labels")}
            report[arch] = _family(cfg, lm, batch, mesh)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(report, f)
    finally:
        dist.destroy_process_group()


def mesh_main(out, *archs):
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(4, port, out, archs), nprocs=4)


def dryrun_main(out, *_):
    import logging
    warnings.filterwarnings("ignore")
    logging.disable(logging.WARNING)
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.distributed.mesh import make_debug_mesh
    from repro_torch.launch import dryrun as D
    D.start_fake_group(8)
    mesh = make_debug_mesh(data=2, model=2, pod=2, device_type="cpu")
    INPUT_SHAPES["tiny_train"] = InputShape("tiny_train", 64, 8, "train")
    INPUT_SHAPES["tiny_decode"] = InputShape("tiny_decode", 64, 8, "decode")
    # reduced configs through the real dry-run path on a tiny mesh
    D.arch_for_pair = lambda a, s: get_arch(a).reduced()
    report = {}
    pairs = [(a, "tiny_train") for a in ARCH_IDS] + [("qwen2.5-3b",
                                                      "tiny_decode")]
    for arch, shape in pairs:
        low, _ = D.lower_pair(arch, shape, mesh, microbatches=2)
        res = D.analyze(low, mesh, verbose=False)
        res["spec_bytes"] = D.spec_bytes(low.placed)
        report[f"{arch}|{shape}"] = res
    with open(out, "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    {"mesh": mesh_main, "dryrun": dryrun_main}[sys.argv[1]](*sys.argv[2:])
