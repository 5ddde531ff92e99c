"""Guards of the benchmark: every cell of ``BENCHMARK.json`` resolves to its
files, new files are found by name, every reference kind is whole and the
harness takes each model-specific piece from the kind its configuration
names, nothing imports JAX, the JAX package or (in the reference) the
program, the counts hold their hand-worked values, a run with a fault planted in its timed path (from here, by
patching the program's step or feed) comes out not correct, and so does
the lower-precision control.  The card-only test
runs each cell end to end for 10 seconds."""

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from _portbench_tiny import ROOT, ref_cfg, tiny_cell, tiny_run
from portbench.counts import flops
from portbench.harness import cells, compare, inputs, kinds, train

PKG = os.path.join(ROOT, "portbench")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = cells.load(name)
    assert cell.cfg["name"] == next(w["config"] for w in BENCH["workloads"]
                                    if w["name"] == name)
    assert "launches_off" in cell.limits and len(cell.limits) > 1
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [dict(
        BENCH["configs"][0], name="new-model",
        file="portbench/configs/new-model.json")]
    bench["workloads"] = BENCH["workloads"] + [dict(
        BENCH["workloads"][0], name="new-model.new_mix", config="new-model",
        traffic="new_mix")]
    bench["per_layer"] = BENCH["per_layer"] + [dict(
        BENCH["per_layer"][0], name="new_metric",
        workloads=["new-model.new_mix"])]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    p = tmp_path / "portbench"
    cfg = dict(cells.load(CELLS[0]).cfg, name="new-model")
    (p / "configs" / "new-model.json").write_text(json.dumps(cfg))
    (p / "traffic" / "new_mix.json").write_text(json.dumps(
        dict(cells.load(CELLS[0]).traffic, seq=1024)))
    (p / "limits" / "new-model.new_mix.json").write_text(json.dumps(
        {"loss_gap": 1.0, "launches_off": 0.0}))
    (p / "metrics" / "new_metric.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    cell = cells.load("new-model.new_mix", root=str(tmp_path))
    assert cell.cfg["name"] == "new-model" and cell.traffic["seq"] == 1024
    assert [m["name"] for m in cell.per_layer][-1] == "new_metric"
    assert cells.reader("new_metric", root=str(tmp_path))(None) == 42.0


#: every module of ``counts/`` and ``reference/`` that claims to be a kind
KINDS = sorted(set(kinds.present()) | {
    os.path.basename(p)[:-3] for p in glob.glob(os.path.join(PKG, "counts",
                                                             "*.py"))
    if os.path.basename(p) not in ("__init__.py", "flops.py")})
CONFIGS = sorted(os.path.basename(p)[:-5] for p in
                 glob.glob(os.path.join(PKG, "configs", "*.json")))


@pytest.mark.parametrize("kind", KINDS)
def test_every_kind_is_whole(kind):
    ref = kinds.reference({"reference": kind})
    for name in kinds.NAMES:
        assert callable(getattr(ref, name)), (kind, name)
    assert callable(kinds.counts({"reference": kind}).terms)


@pytest.mark.parametrize("config", CONFIGS)
def test_every_configuration_names_a_kind(config):
    cfg = json.load(open(os.path.join(PKG, "configs", config + ".json")))
    assert cfg["reference"] in kinds.present()
    sizes = kinds.reference(cfg).program_sizes(cfg)
    assert sizes and all(isinstance(k, str) and isinstance(
        v, (str, int, float, bool, type(None))) for k, v in sizes.items())
    assert flops.per_token(cfg, 4096) > 0


PLANTED_REFERENCE = """
from . import lm

CALLS = {"param_specs": 0, "program_sizes": 0, "run_sync": 0}
layer_kinds, Arith = lm.layer_kinds, lm.Arith


def param_specs(cfg):
    CALLS["param_specs"] += 1
    return lm.param_specs(cfg)


def program_sizes(cfg):
    CALLS["program_sizes"] += 1
    return lm.program_sizes(cfg)


def run_sync(params, batches, cfg, traffic, ar):
    CALLS["run_sync"] += 1
    return lm.run_sync(params, batches, cfg, traffic, ar)
"""

PLANTED_COUNTS = """
from portbench.counts import lm


def terms(cfg, seq):
    return {k: 2 * v for k, v in lm.terms(cfg, seq).items()}
"""


@pytest.fixture
def planted(tmp_path, monkeypatch):
    """A test-only kind, ``planted``, in directories of its own added to
    the two packages: the ``lm`` kind with its FLOP terms doubled and the
    calls of three of its functions counted."""
    from portbench import counts, reference
    pkgs = ((reference, PLANTED_REFERENCE), (counts, PLANTED_COUNTS))
    for pkg, source in pkgs:
        d = tmp_path / pkg.__name__.rsplit(".", 1)[1]
        d.mkdir()
        (d / "planted.py").write_text(source)
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(d)])
    yield
    for pkg, _ in pkgs:
        sys.modules.pop(pkg.__name__ + ".planted", None)


def _traced_on_the_cpu(run_steps, steps, host=False):
    t0 = time.perf_counter()
    run_steps(steps)
    return train.TR.Trace([], [], time.perf_counter() - t0, steps)


def test_a_planted_kind_is_the_one_the_harness_uses(planted, monkeypatch):
    from repro_torch.configs import registry
    assert "planted" in kinds.present()
    handed, values = {}, {}
    monkeypatch.setattr(train.TR, "traced", _traced_on_the_cpu)
    for kind in ("lm", "planted"):
        cell, arch = tiny_cell(CELLS[0])
        cell.cfg["reference"] = kind
        # the port's registry gives the cut configuration, so that the run
        # checks the sizes itself
        monkeypatch.setattr(registry, "get_arch", lambda name: arch)

        def read(ctx, kind=kind):
            handed[kind] = ctx.flops_per_token

        readers = {m["name"]: read for m in cell.per_layer}
        res = train.run(cell, 5, 0.0, True, "cpu", time.perf_counter(),
                        peaks=cells.peaks(), readers=readers)
        values[kind] = res["values"]
    mod = sys.modules["portbench.reference.planted"]
    assert all(n > 0 for n in mod.CALLS.values()), mod.CALLS
    seq = cell.traffic["seq"]
    assert handed["planted"] == flops.per_token(cell.cfg, seq) \
        == 2 * handed["lm"]
    assert values["planted"] == values["lm"]
    assert compare.checks(values["planted"], cell.limits) == \
        compare.checks(values["lm"], cell.limits)


def test_an_unknown_kind_is_refused_before_the_weights(monkeypatch):
    cell, _ = tiny_cell(CELLS[0])
    cell.cfg["reference"] = "nosuch"
    monkeypatch.setattr(inputs, "weights", lambda *a: pytest.fail(a))
    with pytest.raises(ValueError, match="'nosuch'") as err:
        train.run(cell, 5, 0.0, False, "cpu", time.perf_counter())
    assert all(repr(k) in str(err.value) for k in kinds.present())


def test_run_prints_nothing_for_an_unknown_kind(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    os.symlink(os.path.join(ROOT, "src"), tmp_path / "src")
    name = cells.load(CELLS[0]).cfg["name"]
    path = tmp_path / "portbench" / "configs" / (name + ".json")
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    reference="nosuch")))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == "", r
    assert "ValueError" in r.stderr and "'nosuch'" in r.stderr, r.stderr


@pytest.mark.parametrize("arch,key,value", [
    ("phi3-mini-3.8b", "d_ff", 8193),
    ("zamba2-1.2b", "ssm.state_dim", 65),
    ("phi3-mini-3.8b", "ssm.state_dim", 64)])    # phi3 has no SSM
def test_a_wrong_program_size_is_refused(arch, key, value, monkeypatch):
    from portbench.reference import lm
    _, cfg = ref_cfg(arch, "bfloat16", reduced=False)
    train.program_arch(cfg)
    sizes = lm.program_sizes
    monkeypatch.setattr(lm, "program_sizes",
                        lambda c: dict(sizes(c), **{key: value}))
    with pytest.raises(ValueError, match="is not the configuration file's"):
        train.program_arch(cfg)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources(PKG):
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources(os.path.join(PKG, "reference")):
        names = set(_imports(path))
        assert names <= {"__future__", "math", "torch"}, (path, names)


def test_nothing_reads_the_old_benchmarks():
    old = "benchmarks" + "/"
    for path in _sources(PKG):
        assert old not in open(path).read(), path


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode != 0 and r.stdout == ""


def test_phi3_flops_by_hand():
    cfg = cells.load("phi3-mini-3.8b.sync").cfg
    # 6 x 3.72e9 non-embedding parameters (the head's included) and
    # 32 layers x 12 x (4096 / 2) x 3072 of causal attention
    hand = 6 * (32 * (4 * 3072 ** 2 + 3 * 3072 * 8192) + 3072 * 32064) \
        + 32 * 12 * 2048 * 3072
    assert flops.per_token(cfg, 4096) == pytest.approx(hand, rel=1e-12)
    assert flops.per_token(cfg, 4096) == pytest.approx(2.47e10, rel=3e-3)


def test_zamba2_counts_the_shared_block_at_each_application():
    # the port's zamba2-1.2b at its registry's sizes
    _, cfg = ref_cfg("zamba2-1.2b", "bfloat16", reduced=False)
    t = flops.terms(cfg, 4096)
    d, ff = 2048, 8192
    assert t["shared_mlp"] == 6 * 6 * 3 * d * ff
    assert t["shared_concat"] == 6 * 6 * 2 * d * d
    assert t["shared_down"] == 6 * 6 * d * d
    assert t["mamba_in_proj"] == 32 * 6 * d * (2 * 4096 + 2 * 64 + 64)
    assert t["mamba_ssd"] > 0 and "attention" not in t


def test_trace_readers_on_a_made_up_trace():
    from portbench.harness.trace import Trace
    dev = [("nvjet_tst_gemm", 0.0, 600.0),
           ("void at::native::softmax_kernel", 700.0, 800.0),
           ("void at::native::elementwise_kernel", 800.0, 850.0),
           ("Memset (Device)", 900.0, 910.0)]
    host = [("aten::copy_", 590.0, 720.0)]
    t = Trace(dev, host, 1e-3, 1)
    assert t.busy_s() == pytest.approx(760e-6)
    bd = t.breakdown()
    assert bd["idle_gaps"][0][0] == "aten::copy_"
    ctx = train.Ctx(cell=cells.load(CELLS[0]), trace=t, tokens_per_step=8,
                    flops_per_token=1e9, peaks=cells.peaks(), device="cpu")
    read = {m: cells.reader(m) for m in (
        "device_idle_share.train", "launches_per_step.train",
        "non_gemm_ms_per_step.train", "mfu.train")}
    assert read["device_idle_share.train"](ctx) == pytest.approx(24.0)
    assert read["launches_per_step.train"](ctx) == 4
    assert read["non_gemm_ms_per_step.train"](ctx) == pytest.approx(0.15)
    assert read["mfu.train"](ctx) == pytest.approx(
        100 * 8e9 / 1e-3 / cells.peaks()["bf16_flops_per_s"])


def _frozen(monkeypatch):
    """The step returns its state unchanged (and the loss it would have)."""
    from repro_torch.train import steps as S
    make = S.make_train_step

    def frozen(*args, **kwargs):
        step = make(*args, **kwargs)
        return lambda state, batch: (state,
                                     {"loss": step.grads(state, batch)[0]})
    monkeypatch.setattr(S, "make_train_step", frozen)


def _half(monkeypatch):
    """The feed repeats each batch's first half of rows over its second:
    half of the batch left out, the mean taken over the rest."""
    feed = train.Program.feed

    def halved(self):
        b = feed(self)
        tokens, labels = inputs.halve(b["tokens"], b["labels"])
        return {"tokens": tokens, "labels": labels}
    monkeypatch.setattr(train.Program, "feed", halved)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", [None, "frozen", "half"])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, monkeypatch):
    if fault is not None:
        {"frozen": _frozen, "half": _half}[fault](monkeypatch)
    checks = tiny_run(name)
    ok = all(c["ok"] for c in checks.values())
    assert ok == (fault is None), checks


def _control_gaps(name, seed=7):
    """The fp8 control's gaps at the small size, and the cell."""
    cell, _ = tiny_cell(name)
    tr = cell.traffic
    batches = inputs.batches(tr, cell.cfg["vocab_size"], seed,
                             "cpu")[:tr["checked_steps"]]
    base = train.reference(cell.cfg, tr, batches, seed, "cpu")
    ctrl = train.reference(cell.cfg, tr, batches, seed, "cpu", fp8=True)
    return {k: g for k, (g, _) in compare.gaps(ctrl, base).items()}, cell


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_is_not_correct(name):
    gaps, cell = _control_gaps(name)
    assert any(gaps[k] > lim for k, lim in cell.limits.items()
               if k in gaps), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_end_to_end_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        name, "--seed", "20261018", "--seconds", "10",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
