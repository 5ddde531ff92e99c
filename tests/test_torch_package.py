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
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                          tmp_path):
    from repro_torch.device import resolve_device
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
    from repro_torch.distributed import get_mesh
    with pytest.raises(ValueError, match="no CUDA device"):
        get_mesh("auto", device="cuda")
    assert get_mesh().devices == (torch.device("cpu"),)
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
