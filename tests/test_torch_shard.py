"""The port's sharded model stack on the CPU: DTensor steps on a 2 x 2
(data, model) gloo mesh of 4 spawned ranks against the same steps with
``mesh=None``, and the dry run of every arch on a fake (2, 2, 2) group
(the reference's ``SUBPROC`` in ``tests/test_sharding.py``).

All run in child processes (``tests/_torch_shard_worker.py``: two 4-rank
meshes and the dry run, started together): no process group ever exists
in the pytest worker.

Reduced gemma3-1b and qwen2.5-3b in float32, batch 4 x 16, seeded:
  * sync and stale steps (microbatches 2; each arch takes both
    strategies, and the two archs both accumulation modes): the loss and
    grad norm of 2 steps within 1e-5 relative; the first step's gradient
    leaves (once per arch: both cases run the same backward) within 1e-5
    of each leaf's largest magnitude; every parameter
    after 2 steps within 1e-5 of the model's largest weight, except the
    coordinates whose gradient is below 1e-4 of the largest gradient:
    AdamW divides each coordinate by its own gradient, so the
    summation-order noise of a small gradient (1e-3 of it and more)
    becomes that share of an lr-sized move; those are held within
    2 lr a step.
  * the gossip step at R = 2 over 'data' (one replica per data rank,
    K3/K4 on each rank's leaves, the ring a permute) against the stacked
    two-replica step: losses and every parameter within 1e-5.
  * prefill logits within 1e-5 relative; 8 greedy decode steps give the
    same tokens, and the next logits agree within 1e-5 relative.
Reduced arctic-480b (MoE, its 4 experts split over 'model') and
zamba2-1.2b (Mamba2 and shared attention): one sync step's loss and every
gradient leaf within 1e-5 (of the leaf's largest magnitude), prefill
logits within 1e-5 relative.
Dry run: each arch's tiny train pair and qwen2.5-3b's tiny decode run on
meta tensors; argument bytes equal the spec-placed shard bytes; the
FSDP train steps all-gather and reduce-scatter; decode all-reduces."""

import functools
import json
import os
import subprocess
import sys
import tempfile

import pytest

from _torch_threads import capped_env, one_torch_thread  # noqa: F401

HERE = os.path.dirname(__file__)
WORKER = os.path.join(HERE, "_torch_shard_worker.py")
ARCH_IDS = ["qwen1.5-110b", "gemma3-1b", "arctic-480b", "qwen2-vl-72b",
            "qwen2.5-3b", "xlstm-350m", "deepseek-v2-236b", "zamba2-1.2b",
            "whisper-small", "phi3-mini-3.8b"]
CASES = [("gemma3-1b", "sync-explicit"), ("gemma3-1b", "stale-in-loss"),
         ("qwen2.5-3b", "sync-in-loss"), ("qwen2.5-3b", "stale-explicit")]


# three children side by side: two 4-rank meshes and the dry run
JOBS = {"mesh_a": ("mesh", "gemma3-1b", "arctic-480b"),
        "mesh_b": ("mesh", "qwen2.5-3b", "zamba2-1.2b"),
        "dryrun": ("dryrun",)}


@functools.lru_cache(maxsize=None)
def _reports():
    """The children's reports: {"mesh": {arch: ...}, "dryrun": {...}}."""
    tmp = tempfile.mkdtemp(prefix="torch_shard_")
    outs = {k: os.path.join(tmp, f"{k}.json") for k in JOBS}
    env = capped_env(PYTHONWARNINGS="ignore")
    procs = {k: subprocess.Popen([sys.executable, WORKER, JOBS[k][0],
                                  outs[k], *JOBS[k][1:]],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True,
                                 env=env)
             for k in JOBS}
    logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, logs[k][-3000:]
    got = {k: json.load(open(out)) for k, out in outs.items()}
    return {"mesh": {**got["mesh_a"], **got["mesh_b"]},
            "dryrun": got["dryrun"]}


@pytest.mark.parametrize("arch,case", CASES)
def test_sync_stale_steps_match_unsharded(arch, case):
    r = _reports()["mesh"][arch][case]
    assert r["loss"] <= 1e-5 and r["grad_norm"] <= 1e-5, r
    assert r["grads"] is None or r["grads"] <= 1e-5, r
    assert r["params"] <= 1e-5, r
    assert r["vanishing_max"] <= r["vanishing_bound"], r


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-3b"])
def test_gossip_step_matches_stacked(arch):
    r = _reports()["mesh"][arch]["gossip"]
    assert r["loss"] <= 1e-5 and r["params"] <= 1e-5, r


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2.5-3b"])
def test_prefill_and_decode_match_unsharded(arch):
    r = _reports()["mesh"][arch]["serve"]
    assert r["prefill"] <= 1e-5, r
    assert r["decode_tokens_equal"], r
    assert r["decode_logits"] <= 1e-5, r


@pytest.mark.parametrize("arch", ["arctic-480b", "zamba2-1.2b"])
def test_moe_and_ssm_regions_match_unsharded(arch):
    r = _reports()["mesh"][arch]
    assert r["loss"] <= 1e-5 and r["grads"] <= 1e-5, r
    assert r["prefill"] <= 1e-5, r


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dryrun_tiny_train_pair(arch):
    r = _reports()["dryrun"][f"{arch}|tiny_train"]
    assert r["argument_size_in_bytes"] == r["spec_bytes"] > 0
    assert r["collectives"]["all-gather"]["count"] > 0
    assert r["collectives"]["reduce-scatter"]["count"] > 0
    assert r["flops_per_device"] > 0 and r["chips"] == 8


def test_dryrun_tiny_decode():
    r = _reports()["dryrun"]["qwen2.5-3b|tiny_decode"]
    assert r["argument_size_in_bytes"] == r["spec_bytes"] > 0
    assert r["collectives"]["all-reduce"]["count"] > 0
