"""The port's examples (``examples/torch_*.py``) run on the CPU in this
process (``runpy`` with ``--device cpu``) at tiny sizes: each prints its
reference counterpart's lines, and each kernel wrapper is called exactly
as often as ``chip_smoke.example_launches`` says the card launches it
(on the CPU every wrapper runs its plain version).

The quickstart's dataset characters, Hogwild! m_max, advice, arch list
and C_sim equal the reference's functions on the same key, exactly (the
port's threefry is bit-exact); train_100m's parameter count equals the
reference's for the same config.  The gossip example runs 2 of its 8
steps; its 8-rank gloo run is not run here (about 15 s alone;
``tests/test_torch_shard.py`` holds the mesh gossip step against the
stacked one).  Each test runs torch on one thread: the threefry draws
and AdamW passes of these examples are large eager element-wise ops, and
beside other test workers a full thread pool each oversubscribes the
host's cores (the gossip example took minutes so)."""

import dataclasses
import importlib.util
import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    return os.path.join(ROOT, "examples", f"torch_{name}.py")


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (its top level imports the standard
    library only)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def calls(monkeypatch):
    """Each kernel wrapper's calls by ``kernels.WRAPPERS`` name: a launch
    each on a CUDA tensor."""
    from repro_torch import kernels
    counts = dict.fromkeys(kernels.WRAPPERS, 0)
    for name, fn in kernels.WRAPPERS.items():
        def counted(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(sys.modules[fn.__module__], fn.__name__,
                            counted)
    return counts


def _run(name, argv, capsys, monkeypatch):
    """The example's printed lines."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [_example(name), *argv])
    runpy.run_path(_example(name), run_name="__main__")
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_characters(smoke, calls, capsys,
                                                    monkeypatch):
    from repro.configs.registry import ARCH_IDS
    from repro.core import metrics as RM
    from repro.core.advisor import ScalabilityAdvisor
    from repro.data import synth as RS
    lines = _run("quickstart", ["--device", "cpu"], capsys, monkeypatch)
    ds = RS.make_realsim_like(jax.random.PRNGKey(0), n=1000, d=400,
                              density=0.03)
    rep = ScalabilityAdvisor().from_dataset(ds.X, tau_max=8, batch_size=8)
    chars = {k: round(float(rep[k]), 4)
             for k in ("sparsity", "mean_feature_variance",
                       "diversity_ratio", "csim_async")}
    assert lines[:3] == [
        f"dataset characters: {chars}",
        f"predicted Hogwild! m_max: {rep['hogwild']['predicted_m_max']}",
        f"advice: {rep['recommendation']}"]
    assert lines[4] == f"archs: {', '.join(ARCH_IDS)}"
    assert re.fullmatch(r"gemma3-1b: loss at init = \d+\.\d{3} "
                        r"\(ln V = 6\.238\)", lines[6])
    assert lines[7] == "decode_step -> (2, 1, 512) position: 1"
    assert lines[8] == "flash_attention -> (1, 128, 4, 64)"
    csim = RM.csim(ds.X[:256], 8, use_kernel=False)
    assert lines[9] == f"csim (paper Eq. 3) of the sparse dataset: " \
                       f"{float(csim)}"
    assert calls == smoke.example_launches("quickstart")


@pytest.mark.parametrize("argv", [[], ["--arch", "whisper-small",
                                       "--requests", "2", "--gen", "3"]])
def test_serve_batch(smoke, calls, capsys, monkeypatch, argv):
    lines = _run("serve_batch", ["--device", "cpu", *argv], capsys,
                 monkeypatch)
    arch = argv[1] if argv else "zamba2-1.2b"
    requests, gen = (int(argv[3]), int(argv[5])) if argv else (8, 32)
    assert lines[0] == f"arch={arch} batch={requests}"
    prompt = max(4 + (i * 3) % 12 for i in range(requests))
    assert re.fullmatch(rf"prefill: {prompt} steps in \d+\.\d\ds", lines[1])
    assert re.fullmatch(rf"decode: {requests * gen} tokens in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s\)", lines[2])
    first = eval(lines[3].split(": ", 1)[1])
    assert len(first) == min(gen, 12) and all(0 <= t < 512 for t in first)
    if not argv:
        assert calls == smoke.example_launches("serve_batch")


def test_train_100m(smoke, calls, capsys, monkeypatch):
    from repro.configs.base import ArchConfig
    from repro.models import model as RModel
    lines = _run("train_100m", ["--device", "cpu", "--steps", "2",
                                "--batch-size", "2", "--seq-len", "16"],
                 capsys, monkeypatch)
    port_cfg = runpy.run_path(_example("train_100m"))["CONFIG_100M"]
    cfg = ArchConfig(**dataclasses.asdict(port_cfg))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jax.eval_shape(
        lambda: RModel.init_params(jax.random.PRNGKey(0), cfg))))
    assert lines[0] == f"examples-100m: {n / 1e6:.1f}M params"
    assert re.fullmatch(r"step    0 loss \d+\.\d{4} \| div=1\.00", lines[1])
    assert re.fullmatch(r"trained 2 steps in .* loss \d+\.\d{3} -> "
                        r"\d+\.\d{3}", lines[2])
    assert len(lines) == 3
    assert calls == smoke.example_launches("train_100m")


def test_gossip_ecd_psgd(smoke, calls, capsys, monkeypatch):
    argv = ["--device", "cpu", "--steps", "2"]
    lines = _run("gossip_ecd_psgd", argv, capsys, monkeypatch)
    losses = eval(lines[0].split(": ", 1)[1])
    assert len(losses) == 2 and losses[-1] < losses[0]
    assert re.fullmatch(r"replica spread: \S+ OK", lines[1])
    assert float(lines[1].split()[2]) < 1e-2
    assert calls == smoke.example_launches("gossip_ecd_psgd", argv)


def test_paper_scalability_study(smoke, calls, capsys, monkeypatch,
                                 tmp_path):
    """At 40 iterations and n 256 (``get_spec`` cut as
    ``tests/_torch_sweep_parity.py`` cuts specs), into a cache under a
    temporary directory: computed once, served from the cache again."""
    from repro_torch import experiments
    real = experiments.get_spec
    monkeypatch.setattr(experiments, "get_spec",
                        lambda name, **kw: real(name, iters=40, n=256, **kw))
    monkeypatch.chdir(tmp_path)
    lines = _run("paper_scalability_study", ["--device", "cpu", "--force"],
                 capsys, monkeypatch)
    assert calls == smoke.example_launches("paper_scalability_study")
    again = _run("paper_scalability_study", ["--device", "cpu"], capsys,
                 monkeypatch)
    assert again[:-1] == lines
    assert again[-1].startswith("(served from sweep cache: results/"
                                "sweep_cache_torch/scalability_study-")
    assert lines[3].startswith("higgs_like(dense)        var=")
    assert re.fullmatch(r" {25}predicted m_max: hogwild=\d+ sync=\d+",
                        lines[4])
    gaps = [x for x in lines if "gap(m1->m8)=" in x]
    assert len(gaps) == 8
    assert lines[-1].startswith("paper conclusion check:")
