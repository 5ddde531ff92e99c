"""The port's stacked-replica ECD-PSGD gossip step against the reference's
``make_gossip_step`` on a real 8-device host mesh, as
``examples/gossip_ecd_psgd.py`` runs it: reduced gemma3-1b (float32),
lr 2e-3, 8-bit compression, 8 steps on one fixed batch made with numpy.
The reference runs once in a subprocess (the device count is fixed when
JAX starts) on two meshes, data 4 x model 2 (R = 4 replicas) and data
2 x model 4 (R = 2), and dumps its state after steps 1 and 8.

Tolerances: parameters after step 1 within 1e-5 of each leaf's largest
magnitude (the compression of the equal initial y is bit-exact, only the
gradients' float32 rounding differs); y after step 1 is C(z), so an
element may sit one quantum (max|z| / 127 of its replica and leaf) off
where z's last bits decide the stochastic rounding, on at most 0.1 % of
elements; the 8 mean losses within 1e-3."""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch import kernels
from repro_torch import tree as T
from repro_torch.configs.registry import get_arch
from repro_torch.train import steps as S

REPO = os.path.join(os.path.dirname(__file__), "..")
STEPS, LR, B, SEQ = 8, 2e-3, 8, 32

REF_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_arch
    from repro.distributed import make_debug_mesh
    from repro.train.checkpoint import _leaf_key
    from repro.train.steps import init_gossip_state, make_gossip_step

    out, batch = sys.argv[1], dict(np.load(sys.argv[2]))
    cfg = get_arch("gemma3-1b").reduced()
    arrays, losses = {}, {}
    for data, model in ((4, 2), (2, 4)):
        mesh = make_debug_mesh(data=data, model=model)
        make, R = make_gossip_step(cfg, mesh, lr=%(lr)r, compress_bits=8)
        state = init_gossip_state(jax.random.PRNGKey(0), cfg, R)
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        step_fn, _, _ = make(jax.eval_shape(lambda: state),
                             jax.eval_shape(lambda: b))

        def dump(tag):
            for part in ("params", "y"):
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                        state[part])[0]:
                    arrays[f"R{R}/{tag}/{part}/{_leaf_key(path)}"] = \\
                        np.asarray(leaf)

        dump("step0")
        with mesh:
            jstep = jax.jit(step_fn)
            losses[R] = []
            for i in range(%(steps)d):
                state, metrics = jstep(state, b)
                losses[R].append(float(metrics["loss"]))
                if i == 0:
                    dump("step1")
        dump("step%(steps)d")
    np.savez(out, **arrays)
    print(json.dumps(losses))
""") % {"lr": LR, "steps": STEPS}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gossip")
    rng = np.random.default_rng(7)
    cfg = get_arch("gemma3-1b").reduced()
    batch = {k: rng.integers(0, cfg.vocab_size, (B, SEQ), dtype=np.int32)
             for k in ("tokens", "labels")}
    np.savez(tmp / "batch.npz", **batch)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REF_SCRIPT, str(tmp / "state.npz"),
         str(tmp / "batch.npz")], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    losses = {int(k): v for k, v in json.loads(
        proc.stdout.strip().splitlines()[-1]).items()}
    return dict(np.load(tmp / "state.npz")), losses, batch


def _leaves(arrays, R, tag, part):
    prefix = f"R{R}/{tag}/{part}/"
    return {k[len(prefix):]: v for k, v in arrays.items()
            if k.startswith(prefix)}


def _unflatten(flat):
    """{"embed/table": a, "segments/0/attn/wq": b, ...} -> nested tree."""
    tree = {}
    for path, leaf in flat.items():
        node, parts = tree, path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    tree["segments"] = [tree["segments"][str(i)]
                        for i in range(len(tree["segments"]))]
    return tree


@pytest.fixture(scope="module")
def port(reference):
    """R -> the port's (state after step 1, final state, 8 losses) from
    the reference's initial state, each R run once."""
    arrays, _, batch = reference
    cfg = get_arch("gemma3-1b").reduced()
    tb = {k: torch.tensor(v) for k, v in batch.items()}

    @functools.lru_cache(maxsize=None)
    def run(R):
        init = _unflatten(_leaves(arrays, R, "step0", "params"))
        lm = interop.lm_params(cfg, T.tree_map(lambda x: x[0], init))
        state = S.init_gossip_state(cfg, R, params=lm, device="cpu")
        step = S.make_gossip_step(cfg, replicas=R, lr=LR, compress_bits=8)
        losses, after_one = [], None
        for i in range(STEPS):
            state, metrics = step(state, tb)
            losses.append(float(metrics["loss"]))
            if i == 0:      # the step updates params and y in place
                after_one = {k: T.tree_map(torch.clone, state[k])
                             for k in ("params", "y")}
        return after_one, state, losses

    return run


@pytest.mark.parametrize("R", [4, 2])
def test_initial_state_layout(reference, port, R):
    """The stacked state has the reference's leaves, in its order, with a
    leading replica axis, and y equal to the parameters."""
    arrays, _, _ = reference
    want = _leaves(arrays, R, "step0", "params")
    cfg = get_arch("gemma3-1b").reduced()
    init = _unflatten(want)
    lm = interop.lm_params(cfg, T.tree_map(lambda x: x[0], init))
    state = S.init_gossip_state(cfg, R, params=lm, device="cpu")
    got = T.flatten_with_path(state["params"])
    assert [p for p, _ in got] == list(want)
    for path, t in got:
        assert t.shape == want[path].shape
        np.testing.assert_array_equal(t.numpy(), want[path])
    for (_, y), (_, x) in zip(T.flatten_with_path(state["y"]), got):
        assert torch.equal(x, y)


@pytest.mark.parametrize("R", [4, 2])
def test_params_after_one_step(reference, port, R):
    arrays, _, _ = reference
    after_one, _, _ = port(R)
    want = _leaves(arrays, R, "step1", "params")
    for path, t in T.flatten_with_path(after_one["params"]):
        w = want[path]
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(t.numpy() - w).max()) / scale
        assert err <= 1e-5, (R, path, err)


@pytest.mark.parametrize("R", [4, 2])
def test_y_after_one_step_within_a_quantum(reference, port, R):
    arrays, _, _ = reference
    after_one, _, _ = port(R)
    want_y = _leaves(arrays, R, "step1", "y")
    want_x = _leaves(arrays, R, "step1", "params")
    off = total = 0
    for path, t in T.flatten_with_path(after_one["y"]):
        w = want_y[path]
        # at t = 2, z = x_new: one quantum is max|x_new| / 127 per replica
        quantum = np.abs(want_x[path].reshape(R, -1)).max(axis=1) / 127.0
        diff = np.abs(t.numpy() - w).reshape(R, -1)
        assert (diff <= quantum[:, None] * (1 + 1e-5)).all(), path
        off += int((diff > quantum[:, None] * 1e-3).sum())
        total += diff.size
    assert off <= 1e-3 * total, (R, off, total)


@pytest.mark.parametrize("R", [4, 2])
def test_losses_match_and_descend(reference, port, R):
    _, ref_losses, _ = reference
    _, final, losses = port(R)
    np.testing.assert_allclose(losses, ref_losses[R], rtol=1e-3, atol=0)
    assert losses[-1] < losses[0]
    for _, leaf in T.flatten_with_path(final["params"]):
        assert torch.isfinite(leaf).all()


def test_compression_goes_through_k3_k4_wrappers(monkeypatch):
    """Every leaf of every replica is compressed twice a step by one
    quantize_rows and one dequantize_rows call over (R, numel) rows; on the
    CPU they run their plain versions and count no launch."""
    from repro_torch.kernels import quantize as kq
    calls = []
    real_q, real_dq = kq.quantize_rows, kq.dequantize_rows

    def spy_q(x, u, scale, bits=8):
        calls.append(("q", tuple(x.shape)))
        return real_q(x, u, scale, bits)

    def spy_dq(q, scale):
        calls.append(("dq", tuple(q.shape)))
        return real_dq(q, scale)

    monkeypatch.setattr(kq, "quantize_rows", spy_q)
    monkeypatch.setattr(kq, "dequantize_rows", spy_dq)
    cfg = get_arch("gemma3-1b").reduced()
    R = 3
    state = S.init_gossip_state(cfg, R, device="cpu")
    n_leaves = len(T.flatten(state["y"])[0])
    step = S.make_gossip_step(cfg, replicas=R, lr=LR)
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (R, 8),
                                          dtype=np.int32))
             for k in ("tokens", "labels")}
    kernels.reset_launch_counts()
    step(state, batch)
    assert sum(c == "q" for c, _ in calls) == 2 * n_leaves
    assert sum(c == "dq" for c, _ in calls) == 2 * n_leaves
    assert all(shape[0] == R and len(shape) == 2 for _, shape in calls)
    assert kernels.launch_counts()["ecd_compress_rows"] == 0
    assert all(v == 0 for v in kernels.launch_counts().values())
