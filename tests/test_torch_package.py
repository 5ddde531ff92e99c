"""Package rules of the port: no JAX and no reference imports (the
package, chip_smoke.py and the port's examples, ``examples/torch_*.py``),
GPU by default with no silent fall-back to the CPU, and chip_smoke.py
failing without a GPU or outside a checkout."""

import glob
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from _torch_threads import capped_env, one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
PORT = os.path.join(ROOT, "src", "repro_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "torch_*.py")))

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))", re.M)


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield SMOKE
    yield from EXAMPLES


def test_no_jax_or_reference_imports():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_package_imports_without_jax():
    """Importing every port module, and loading each of the port's
    examples, pulls in neither jax nor repro."""
    assert len(EXAMPLES) == 5
    code = ("import sys, pkgutil, importlib, runpy, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            f"for path in {EXAMPLES!r}:\n"
            "    runpy.run_path(path, run_name='example')\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'repro.')) or k == 'repro']\n"
            "assert not bad, bad\n")
    env = capped_env(PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def _device_defaults():
    """(name, call with the device taken from ``device``) of every public
    function of the port that builds tensors or meshes on a device of its
    own choosing; each takes the card when the caller names none."""
    import numpy as np
    from repro_torch import interop
    from repro_torch import random as R
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import synth
    from repro_torch.distributed import mesh
    from repro_torch.models import attention, layers, ssm
    from repro_torch.models import model as M
    from repro_torch.resilience import faults
    gemma = get_arch("gemma3-1b").reduced()
    zamba = get_arch("zamba2-1.2b").reduced()
    xlstm = get_arch("xlstm-350m").reduced()
    mla = get_arch("deepseek-v2-236b").reduced()
    X, y = np.ones((4, 3), np.float32), np.ones(4, np.float32)
    tree = interop.lm_tree(M.init_params(gemma, device="cpu"))
    f32 = torch.float32
    return [
        ("PRNGKey", lambda **d: R.PRNGKey(0, **d)),
        ("init_kv_cache",
         lambda **d: attention.init_kv_cache(gemma, 1, 8, f32, **d)),
        ("init_mla_cache",
         lambda **d: attention.init_mla_cache(mla, 1, 8, f32, **d)),
        ("causal_mask", lambda **d: attention.causal_mask(4, 8, 2, **d)),
        ("rope_freqs", lambda **d: layers.rope_freqs(8, 1e4, **d)),
        ("init_mamba2_state",
         lambda **d: ssm.init_mamba2_state(zamba, 1, f32, **d)),
        ("init_mlstm_state",
         lambda **d: ssm.init_mlstm_state(xlstm, 1, f32, **d)),
        ("init_slstm_state",
         lambda **d: ssm.init_slstm_state(xlstm, 1, f32, **d)),
        ("ruler", lambda **d: synth.ruler(5, **d)),
        ("make_stream", lambda **d: faults.make_stream(
            faults.FaultSpec(drop_rate=0.5), (3,), **d)),
        ("interop.dataset", lambda **d: interop.dataset(X, y, **d)),
        ("interop.split", lambda **d: interop.split((X, y), (X, y), **d)),
        ("interop.model", lambda **d: interop.model(y, **d)),
        ("interop.draws", lambda **d: interop.draws(
            "minibatch", np.zeros((2, 3), np.int32), 3, **d)),
        ("interop.lm_params", lambda **d: interop.lm_params(gemma, tree,
                                                            **d)),
        ("available", lambda **d: mesh.available(**d)),
        ("get_mesh", lambda **d: mesh.get_mesh(**d)),
        ("resolve", lambda **d: mesh.resolve("auto", **d)),
    ]


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                          tmp_path):
    """Every entry point, and every function of ``_device_defaults``,
    raises on a host without a GPU unless the caller names the CPU, and
    runs there when it does; so do the model-stack meshes, which raise
    before they look for a process group (they run on a CPU group in
    ``tests/_torch_shard_worker.py``)."""
    from repro_torch.device import resolve_device
    from repro_torch.distributed import mesh
    from repro_torch.experiments import registry, run, runner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = registry.get_spec("upper_bound", iters=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run_sweep(spec, cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError):
        run.main(["--spec", "upper_bound", "--iters", "20",
                  "--cache-dir", str(tmp_path)])
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        run.main(["--spec", "upper_bound", "--iters", "20", "--no-cache",
                  "--devices", "1", "--seq", "--trace",
                  str(tmp_path / "t.json"), "--metrics"])
    from repro_torch.analysis import report
    with pytest.raises(RuntimeError, match="device='cpu'"):
        report.main(["--quick", "--iters", "20", "--out",
                     str(tmp_path / "r.md"), "--cache-dir", str(tmp_path)])
    for name, call in _device_defaults():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
        call(device="cpu")
    for make in (mesh.make_debug_mesh, mesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh.get_mesh("auto", device="cuda")
    assert mesh.get_mesh(device="cpu").devices == (torch.device("cpu"),)
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serve import engine
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1", "--prompt-len", "2", "--gen", "1"])
    cfg = get_arch("gemma3-1b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.greedy_generate(params, cfg, torch.zeros((1, 2),
                                                        dtype=torch.int64), 1)
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_chip_smoke_fails_without_gpu(tmp_path):
    """Here there is no GPU: the smoke run must exit non-zero and print no
    result line; a lone copy of the script must fail the same way."""
    for script in (SMOKE, shutil.copy(SMOKE, tmp_path / "chip_smoke.py")):
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=120,
                              cwd=os.path.dirname(str(script)))
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: chip_smoke.py would run")
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
