"""The port's device mesh, grid partitioner and racing Hogwild! against
the reference's ``repro.distributed``.

Mesh resolution, padding and the element plan are compared with the
reference's on the same inputs.  Sharding runs on a virtual 4-shard mesh
(``from_devices(["cpu"] * 4)``, shards one after another): every curve
within 1e-5 of ``mesh=None`` (ECD-PSGD within its 2e-2 envelope, since
its quantizer turns an ulp into a quantum), every m_max equal, and a
one-device mesh bit-exact.  Racing Hogwild! runs against the reference's
``run_hogwild_sharded`` on a real 8-device host mesh, in one subprocess
(the device count is fixed when JAX starts), faulted and unfaulted,
within 1e-5, with equal ``psum_rounds`` and ``race`` events.
"""

import json
import os
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro.distributed import element_plan as ref_element_plan
from repro.distributed import pad_to_multiple as ref_pad_to_multiple
from repro_torch import random as R
from repro_torch.data import synth
from repro_torch.distributed import (element_plan, from_devices, get_mesh,
                                     pad_to_multiple, resolve,
                                     run_grid_sharded, run_hogwild_sharded,
                                     sweep_hogwild_sharded)
from repro_torch.distributed import mesh as mesh_mod
from repro_torch.experiments import engine, registry, runner
from repro_torch.experiments.spec import (EXECUTION_ONLY_FIELDS,
                                          DatasetSpec, EpsilonSpec, JobSpec,
                                          SweepSpec, fingerprint)
from repro_torch.telemetry import metrics
from repro_torch.telemetry.recorder import RECORDER

REPO = os.path.join(os.path.dirname(__file__), "..")
CPU4 = from_devices(["cpu"] * 4)


# ---------------------------------------------------------------------------
# mesh resolution
# ---------------------------------------------------------------------------

def test_get_mesh_auto_int_and_clamp():
    auto = get_mesh(device="cpu")
    assert auto.devices == (torch.device("cpu"),)
    assert get_mesh("auto", device="cpu") == auto
    one = get_mesh(1, device="cpu")
    assert one.n_devices == 1 and "fallback" in one.describe()
    assert resolve(None) is None
    assert resolve(CPU4) is CPU4
    assert CPU4.n_devices == 4 and "sharding" in CPU4.describe()
    with pytest.raises(ValueError):
        get_mesh(0, device="cpu")
    mesh_mod._CLAMP_WARNED = False
    try:
        with pytest.warns(RuntimeWarning, match="clamping"):
            assert get_mesh(3, device="cpu").n_devices == 1
        with warnings.catch_warnings():
            warnings.simplefilter("error")     # one-shot: silent the 2nd time
            assert get_mesh(5, device="cpu").n_devices == 1
    finally:
        mesh_mod._CLAMP_WARNED = False


@pytest.mark.parametrize("n,k", [(5, 4), (8, 4), (1, 8), (13, 3)])
def test_pad_to_multiple_matches_reference(n, k):
    assert pad_to_multiple(n, k) == ref_pad_to_multiple(n, k)


@pytest.mark.parametrize("pos,ms,n_seeds,n_dev", [
    ((1, 3), [1, 2, 4, 8], 2, 4),
    ((0, 1, 2), [1, 2, 4], 1, 4),
    ((0, 1, 2, 3, 4), [2, 4, 8, 16, 24], 8, 4),
    ((2,), [1, 2, 3], 3, 8),
])
def test_element_plan_matches_reference(pos, ms, n_seeds, n_dev):
    mine = element_plan(pos, ms, n_seeds, n_dev)
    ref = ref_element_plan(pos, ms, n_seeds, n_dev)
    for a, b in zip(mine[:2], ref[:2]):
        assert a.dtype == np.int32 and np.array_equal(a, np.asarray(b))
    assert mine[2] == ref[2]


def test_run_grid_sharded_bookkeeping():
    """Pad, split, gather and scatter, with an analytic element runner
    whose 3 'evals' encode (m, s, m_pad)."""
    ms = [1, 2, 3, 4, 6, 8]

    def run_elements(m_list, s_list, m_pad, device):
        return torch.tensor([[m, s, m_pad] for m, s in zip(m_list, s_list)],
                            dtype=torch.float32, device=device)

    for n_seeds in (1, 3):
        for buckets in (engine._buckets(ms),
                        [(tuple(range(len(ms))), max(ms))]):
            out = run_grid_sharded(run_elements, ms, n_seeds, CPU4, buckets)
            pad_of = {i: m_pad for pos, m_pad in buckets for i in pos}
            assert out.shape == (len(ms), n_seeds, 3)
            for i, m in enumerate(ms):
                for s in range(n_seeds):
                    assert out[i, s].tolist() == [m, s, pad_of[i]]


# ---------------------------------------------------------------------------
# execution never enters result identity
# ---------------------------------------------------------------------------

def _tiny_spec(**over):
    base = dict(
        name="dist_tiny", description="distributed unit spec",
        ms=(1, 2, 4), iters=40, eval_every=20,
        datasets={"d0": DatasetSpec("higgs_like", {"n": 160, "d": 8})},
        jobs=(JobSpec("minibatch", "d0"),
              JobSpec("hogwild", "d0", {"gamma": 0.05}, predict=True)),
        epsilon=EpsilonSpec(probe_m=1, frac=0.7))
    base.update(over)
    return SweepSpec(**base).validate()


#: every registry spec's fingerprint at the parent commit of the mesh
#: work: `devices` must not move one, or the port's cache would go stale
PARENT_FINGERPRINTS = {
    "character_surface":
        "159f52c5a5fc10b83d15b8db748616408776237c75ee0d74f4a90ba55a269958",
    "character_surface:quick":
        "68e03857335d2663f0329c9b81aa5fc6e1ed7a1d76efb2e17c52cda86d5cedee",
    "critical_params":
        "47d2089a38190bb8f63dbd4f03a46071013b3324217576e16c725f513184c7ea",
    "critical_params:quick":
        "582dc0ad1348fbb7fc20144acec05f3de36ddd99f074bbee172c4c3a3fd7bfde",
    "diversity":
        "59e0468a2228d7c98ba8a453a87a14b25728d628ccc1f90633bc02b2dabee78f",
    "diversity:quick":
        "194f712b5de4710dcdacd8029fe6f950649a724f060a46b28eb20e069bd6fefe",
    "fault_tolerance":
        "974fc782805acb75461944607a8d75c6177c9fa156c1f40d95a37dfe444f13ae",
    "fault_tolerance:quick":
        "c4c4b4898f19657e67ec27dcd18930eb68c2556efd01769827a3baad285760cc",
    "ls":
        "c4ef17991e5b25d809b79073749079849bf0a4bff9dce2c2c70fc077bd845757",
    "ls:quick":
        "8804a7153a1dda9094ee2c15a5e1e9fb1f410d581c69324bba0da131ff7e5591",
    "problem_generality":
        "c15a640d93df0e040452f687bf366a3bf9294993836a6ab56039a74250a45361",
    "problem_generality:quick":
        "a06927aa0b74d3e90a61c65f92771d9fac3a851babc38ae0ebe48143600679c0",
    "scalability_study":
        "1d021b55dddcff0e1b42c21c131a32823d0b6b3996c517885595d7c2c48059de",
    "scalability_study:quick":
        "64503dc49f99f6208e388b61b4c3a500a8422fcf240d4a68fed1616ca18ce913",
    "upper_bound":
        "ac63383c6a702087cee39714a500ebcf5c4031d6222162057a068d770c52245b",
    "upper_bound:quick":
        "ebff390949c0abdf8bbf11861519d40fce4a973063a0260d4f6978a1bda5b200",
    "variance_sparsity":
        "257ed3af23754b64101fb5bcd91a0a80a93a4664a128a82638c0b5b77d590783",
    "variance_sparsity:quick":
        "ac9b1e9e0f1114250e5c9c94f30551751005aa612994371c6d350d282078c226",
}


def test_fingerprint_excludes_devices():
    assert EXECUTION_ONLY_FIELDS == ("devices",)
    fps = {fingerprint(_tiny_spec(devices=d)) for d in (None, 1, 8, "auto")}
    assert len(fps) == 1
    assert fingerprint(_tiny_spec(iters=80)) not in fps
    assert "devices" not in runner.spec_mod.computational_dict(
        _tiny_spec(devices=4))


def test_existing_fingerprints_unchanged():
    got = {}
    for name in registry.SPEC_IDS:
        for quick in (False, True):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                spec = registry.get_spec(name, quick=quick)
            got[name + (":quick" if quick else "")] = fingerprint(spec)
    assert got == PARENT_FINGERPRINTS


def test_spec_devices_validation():
    for bad in (0, -1, "all", 1.5):
        with pytest.raises(ValueError, match="devices"):
            _tiny_spec(devices=bad)
    for good in (None, "auto", 1, 8):
        assert _tiny_spec(devices=good).devices == good


def test_cache_hit_served_without_resolving_the_mesh(tmp_path, monkeypatch):
    spec = _tiny_spec()
    first = runner.run_sweep(spec, device="cpu", cache_dir=str(tmp_path))
    assert first["cache"]["hit"] is False
    assert first["execution"]["devices"] == 1
    assert first["execution"]["sharded"] is False

    def unresolvable(*a, **k):
        raise AssertionError("a cache hit resolved the mesh")

    monkeypatch.setattr(mesh_mod, "get_mesh", unresolvable)
    monkeypatch.setattr(runner.dist_mesh, "resolve", unresolvable)
    hit = runner.run_sweep(_tiny_spec(devices=8), device="cpu",
                           cache_dir=str(tmp_path), mesh=CPU4)
    assert hit["cache"]["hit"] is True
    assert hit["execution"]["sharded"] is False
    with open(first["cache"]["path"]) as f:
        stored = json.load(f)
    assert "devices" not in stored["spec"] and "execution" not in stored


# ---------------------------------------------------------------------------
# sharded grids: 4 virtual shards against mesh=None
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split():
    ds = synth.get_generator("higgs_like")(R.PRNGKey(0), n=400, d=16)
    return ds.split(key=R.PRNGKey(0))


@pytest.mark.parametrize("algo,n_seeds,iters,kw,tol", [
    ("minibatch", 3, 200, {}, 1e-5),
    ("hogwild", 3, 200, {"gamma": 0.05}, 1e-5),
    ("dadm", 1, 200, {}, 1e-5),
    ("ecd_psgd", 2, 60, {}, 2e-2),
    ("local_sgd", 2, 120, {}, 1e-5),
    ("hogwild", 2, 120, {"gamma": 0.05,
                         "fault": {"straggle_rate": 0.2,
                                   "corrupt_rate": 0.1, "seed": 3}}, 1e-5),
])
def test_sharded_grid_matches_unsharded(split, algo, n_seeds, iters, kw,
                                        tol):
    tr, te = split
    ms = [1, 2, 4, 8]
    run = dict(iters=iters, eval_every=iters // 4, n_seeds=n_seeds, **kw)
    base = engine.sweep(algo, tr, te, ms, **run)
    sharded = engine.sweep(algo, tr, te, ms, mesh=CPU4, **run)
    one = engine.sweep(algo, tr, te, ms, mesh=from_devices(["cpu"]), **run)
    key = "losses_seeds" if n_seeds > 1 else "losses"
    a, b = np.asarray(base[key]), np.asarray(sharded[key])
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol
    assert one == base                   # one device: the unsharded path


def test_sharded_sweep_keeps_every_mmax(tmp_path):
    spec = registry.get_spec("upper_bound", quick=True, iters=60, seeds=2)
    base = runner.run_sweep(spec, device="cpu", use_cache=False)
    sharded = runner.run_sweep(spec, device="cpu", use_cache=False,
                               mesh=CPU4)
    assert sharded["execution"] == {**base["execution"], "devices": 4,
                                    "sharded": True}
    for key, jb in base["jobs"].items():
        js = sharded["jobs"][key]
        tol = 2e-2 if jb["algorithm"] == "ecd_psgd" else 1e-5
        assert float(np.abs(np.asarray(jb["losses_seeds"])
                            - np.asarray(js["losses_seeds"])).max()) <= tol
        assert js["measured_m_max"] == jb["measured_m_max"]
        assert js.get("predicted") == jb.get("predicted")


# ---------------------------------------------------------------------------
# racing Hogwild! against the reference's on 8 host devices
# ---------------------------------------------------------------------------

#: (name, kwargs) of each race; m == devices at sync_every=1 is the
#: reference's exact-parity point, the others race for real
RACES = [
    ("parity", dict(m=8, iters=1600, gamma=0.05, eval_every=200)),
    ("stale", dict(m=8, iters=1600, gamma=0.05, eval_every=200,
                   sync_every=4)),
    ("padded", dict(m=6, iters=600, gamma=0.05, eval_every=60)),
    ("two_slots", dict(m=16, iters=1600, gamma=0.05, eval_every=160,
                       sync_every=2)),
    ("faulted", dict(m=8, iters=1600, gamma=0.05, eval_every=200,
                     fault={"straggle_rate": 0.2, "drop_rate": 0.1,
                            "duplicate_rate": 0.05, "corrupt_rate": 0.1,
                            "seed": 3})),
    ("faulted_quantize", dict(m=8, iters=800, gamma=0.05, eval_every=200,
                              sync_every=2,
                              fault={"corrupt_rate": 0.3,
                                     "corrupt_kind": "quantize",
                                     "corrupt_bits": 4, "seed": 1})),
]
SWEEP = dict(ms=[1, 2, 3, 8], iters=240, eval_every=80, gamma=0.05)

REF_RACE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.data.synth import Dataset
    from repro.distributed import run_hogwild_sharded, sweep_hogwild_sharded
    from repro.telemetry import metrics
    from repro.telemetry.recorder import RECORDER

    assert len(jax.devices()) == 8
    arrays = dict(np.load(sys.argv[1]))
    races, sweep = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    tr = Dataset(jnp.asarray(arrays["X"]), jnp.asarray(arrays["y"]))
    te = Dataset(jnp.asarray(arrays["Xte"]), jnp.asarray(arrays["yte"]))
    counter = metrics.REGISTRY.counter("repro_distributed_psum_rounds_total")
    out = {}
    for name, kw in races:
        c0 = counter.value
        RECORDER.clear()
        r = run_hogwild_sharded(tr, te, mesh=8, **kw)
        events = [{k: v for k, v in e.items() if k not in ("seq", "t")}
                  for e in RECORDER.snapshot()["events"]
                  if e["kind"] == "race"]
        out[name] = {"losses": np.asarray(r["losses"]).tolist(),
                     "psum_rounds": r["psum_rounds"],
                     "counted": counter.value - c0, "events": events,
                     "iters": r["iters"], "devices": r["devices"]}
    ms = sweep.pop("ms")
    out["sweep"] = sweep_hogwild_sharded(tr, te, ms, mesh=8, **sweep)
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_races(split, tmp_path_factory):
    tr, te = split
    path = tmp_path_factory.mktemp("race") / "data.npz"
    np.savez(path, X=tr.X.numpy(), y=tr.y.numpy(), Xte=te.X.numpy(),
             yte=te.y.numpy())
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", REF_RACE, str(path), json.dumps(RACES),
         json.dumps(SWEEP)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name,kw", RACES, ids=[r[0] for r in RACES])
def test_race_matches_reference(split, reference_races, name, kw):
    tr, te = split
    ref = reference_races[name]
    counter = metrics.REGISTRY.counter("repro_distributed_psum_rounds_total")
    c0 = counter.value
    seq = RECORDER.snapshot()["seq"]
    mine = run_hogwild_sharded(tr, te, mesh=from_devices(["cpu"] * 8), **kw)
    events = [{k: v for k, v in e.items() if k not in ("seq", "t")}
              for e in RECORDER.snapshot(since=seq)["events"]
              if e["kind"] == "race"]
    assert mine["devices"] == ref["devices"] == 8
    assert mine["iters"] == ref["iters"]
    assert mine["psum_rounds"] == ref["psum_rounds"]
    assert counter.value - c0 == ref["counted"] == mine["psum_rounds"]
    assert events == ref["events"]
    a, b = np.asarray(mine["losses"]), np.asarray(ref["losses"])
    assert a.shape == b.shape and np.isfinite(a).all()
    assert float(np.abs(a - b).max()) <= 1e-5


def test_race_parity_with_the_staleness_oracle(split):
    """m == devices, sync_every=1: the race is the engine's recurrence."""
    tr, te = split
    kw = dict(iters=1600, gamma=0.05, eval_every=200)
    race = run_hogwild_sharded(tr, te, m=8, mesh=from_devices(["cpu"] * 8),
                               **kw)
    oracle = engine.sweep("hogwild", tr, te, [8], **kw)["losses"][0]
    assert float(np.abs(np.asarray(race["losses"])
                        - np.asarray(oracle)).max()) <= 1e-5


def test_sweep_hogwild_sharded_matches_reference(split, reference_races):
    tr, te = split
    kw = dict(SWEEP)
    ms = kw.pop("ms")
    mine = sweep_hogwild_sharded(tr, te, ms,
                                 mesh=from_devices(["cpu"] * 8), **kw)
    ref = reference_races["sweep"]
    assert {k: v for k, v in mine.items() if k != "losses"} == \
        {k: v for k, v in ref.items() if k != "losses"}
    assert float(np.abs(np.asarray(mine["losses"])
                        - np.asarray(ref["losses"])).max()) <= 1e-5
