"""The port's nine sweep specs against the reference's registry, and its
CLI's --list, --n and --problem.  Spec dicts are compared exactly; the
reference's ``devices`` field steers execution only (its
``computational_dict`` drops it) and the port has no device mesh."""

import json
import warnings

import pytest

from repro.experiments import registry as JR
from repro.experiments import spec as JS
from repro_torch.experiments import registry as TR
from repro_torch.experiments import run as TRun_cli
from repro_torch.experiments import spec as TS

from _torch_threads import one_torch_thread  # noqa: F401

OVERRIDES = [{}, {"iters": 40}, {"n": 256}, {"seeds": 2},
             {"iters": 60, "n": 300, "seeds": 3}]


def test_the_registry_has_the_references_nine_specs():
    assert TR.SPEC_IDS == JR.SPEC_IDS
    assert len(TR.SPEC_IDS) == 9


@pytest.mark.parametrize("name", JR.SPEC_IDS)
@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("over", OVERRIDES, ids=lambda o: "-".join(o) or
                         "none")
def test_spec_dicts_match_reference(name, quick, over):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # upper_bound ignores n
        jspec = JR.get_spec(name, quick=quick, **over)
        tspec = TR.get_spec(name, quick=quick, **over)
    assert tspec.to_dict() == jspec.to_dict()
    assert TS.computational_dict(tspec) == JS.computational_dict(jspec)


def test_upper_bound_warns_and_ignores_n():
    with pytest.warns(UserWarning, match="ignores the n override"):
        spec = TR.get_spec("upper_bound", n=100)
    assert spec == TR.get_spec("upper_bound")


def test_fingerprints_differ_by_backend_for_every_spec():
    for name in TR.SPEC_IDS:
        tspec, jspec = TR.get_spec(name, quick=True), JR.get_spec(
            name, quick=True)
        assert TS.fingerprint(tspec) != JS.fingerprint(jspec)
        assert TS.fingerprint(tspec) == TS.fingerprint(
            TR.get_spec(name, quick=True))


def test_registry_signature_covers_every_registry_entry():
    """The fingerprint hashes the sources of the new generators and
    algorithms, and label_noise's base generator, as the reference's
    does."""
    for name in TR.SPEC_IDS:
        tsig = TS.registry_signature(TR.get_spec(name, quick=True))
        jsig = JS.registry_signature(JR.get_spec(name, quick=True))
        assert sorted(tsig) == sorted(jsig), name
    sig = TS.registry_signature(TR.get_spec("problem_generality"))
    assert {"generator:label_noise", "generator:higgs_like",
            "generator:heavy_tailed"} <= set(sig)
    sig = TS.registry_signature(TR.get_spec("critical_params"))
    assert {"algorithm:momentum", "algorithm:local_sgd",
            "algorithm:async_svrg", "generator:character_knob"} <= set(sig)


def test_diversity_variants_validate():
    TS.DatasetSpec("realsim_like", variant="mid").validate()
    with pytest.raises(ValueError):
        TS.DatasetSpec("realsim_like", variant="tiny").validate()


def test_cli_list(capsys):
    assert TRun_cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    for name in (TR.SPEC_IDS + ["async_svrg", "dadm", "ecd_psgd", "hogwild",
                                "local_sgd", "minibatch", "momentum",
                                "logistic", "ridge", "hinge",
                                "character_knob", "heavy_tailed",
                                "label_noise", "ls_sequence", "one_sample",
                                "higgs_like", "realsim_like"]):
        assert f"  {name} " in out, name


def test_cli_requires_a_spec_without_list():
    with pytest.raises(SystemExit):
        TRun_cli.main([])


def test_cli_n_and_problem(tmp_path, capsys):
    out_json = tmp_path / "out.json"
    assert TRun_cli.main(["--spec", "variance_sparsity", "--quick",
                          "--iters", "20", "--n", "120", "--problem",
                          "hinge", "--device", "cpu", "--no-cache",
                          "--json", str(out_json)]) == 0
    assert "minibatch+hinge/higgs_like" in capsys.readouterr().out
    result = json.loads(out_json.read_text())
    spec = result["spec"]
    assert {j["problem"] for j in spec["jobs"]} == {"hinge"}
    assert [ds["kwargs"]["n"] for ds in spec["datasets"].values()] == [120,
                                                                      120]
    assert {info["n"] for info in result["datasets"].values()} == {120}
    with pytest.raises(KeyError):
        TRun_cli.main(["--spec", "ls", "--problem", "nope", "--device",
                       "cpu"])
