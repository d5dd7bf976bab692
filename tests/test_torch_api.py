"""The port's analiticcl-compatible API (``analiticcl_tpu_torch.api``)
against the JAX package's (``analiticcl_tpu.api``) on the CPU: the
parameter classes (kwargs, threshold coercion, warnings on unknown kwargs,
``to_dict``), the result dicts of ``find_variants``, ``find_variants_par``
and ``find_all_matches`` and ``__contains__`` on a seeded lexicon (floats
compared exactly), the public surface of the four classes and the stub
``api.pyi``. The port's model runs on ``device="cpu"``."""

import ast
import contextlib
import inspect
import io
from pathlib import Path

import pytest
import torch

import analiticcl_tpu.api as jax_api
import analiticcl_tpu_torch.api as port_api
from test_torch_cli import cli_files  # noqa: F401 (fixture)
from test_torch_slice import to_ref

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
CLASSES = ("Weights", "SearchParameters", "VocabParams", "VariantModel")


def _printed(fn):
    """``fn()``'s value and what it printed to stdout and stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        value = fn()
    return value, out.getvalue(), err.getvalue()


def test_weights_match_jax():
    for kwargs in ({}, {"ld": 1, "lcs": 0.5}, {"case": 0.0, "bogus": 1}):
        p, *p_said = _printed(lambda: port_api.Weights(**kwargs))
        j, *j_said = _printed(lambda: jax_api.Weights(**kwargs))
        assert p.to_dict() == j.to_dict()
        assert p_said == j_said
    assert "Ignored unknown kwargs option bogus" in p_said[1]
    w = port_api.Weights(ld=1.0)
    w.prefix = 0.25
    assert (w.ld, w.prefix, w.to_dict()["prefix"]) == (1.0, 0.25, 0.25)
    with pytest.raises(AttributeError):
        w.nonexistent


@pytest.mark.parametrize("threshold", [3, 0.3, (0.4, 5), "0.5;6", "2", "0.25"],
                         ids=["int", "float", "tuple", "str_ratio_limit",
                              "str_int", "str_float"])
def test_search_parameters_coerce_thresholds_like_jax(threshold):
    kwargs = dict(max_edit_distance=threshold, max_anagram_distance=threshold,
                  max_matches=7, stop_at_exact_match=True, freq_weight=0.5)
    p, j = port_api.SearchParameters(**kwargs), jax_api.SearchParameters(**kwargs)
    assert p.to_dict() == j.to_dict()
    assert p.max_edit_distance == j.max_edit_distance
    assert to_ref(p.data) == j.data
    p.max_anagram_distance = j.max_anagram_distance = 2
    p.stop_at_exact_match = j.stop_at_exact_match = False
    p.max_ngram = j.max_ngram = 2
    assert p.to_dict() == j.to_dict()
    assert to_ref(p.data) == j.data


def test_search_parameters_warn_like_jax():
    kwargs = dict(max_matches=3, bogus=1, unicodeoffsets=True)
    p, *p_said = _printed(lambda: port_api.SearchParameters(**kwargs))
    j, *j_said = _printed(lambda: jax_api.SearchParameters(**kwargs))
    assert p_said == j_said and "bogus" in p_said[1]
    assert p.to_dict() == j.to_dict()
    assert sorted(p.to_dict()) == sorted(
        port_api.SearchParameters._FIELDS + ("stop_at_exact_match",))


@pytest.mark.parametrize("kwargs", [
    {},
    {"text_column": 2, "freq_column": None, "index": 1},
    {"freqhandling": "sum"}, {"freqhandling": "min"},
    {"freqhandling": "replace"}, {"freqhandling": "bogus"},
    {"vocabtype": "NONE"}, {"vocabtype": "INDEXED"},
    {"vocabtype": "TRANSPARENT"}, {"vocabtype": "LM"},
    {"vocabtype": "bogus"}, {"bogus": 1},
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()) or "default")
def test_vocab_params_match_jax(kwargs):
    p, *p_said = _printed(lambda: port_api.VocabParams(**kwargs))
    j, *j_said = _printed(lambda: jax_api.VocabParams(**kwargs))
    assert to_ref(p.data) == j.data
    assert p_said == j_said
    assert (p.text_column, p.freq_column, p.index) == (
        j.text_column, j.freq_column, j.index)


@pytest.fixture(scope="module")
def api_models(cli_files):
    """The JAX package's and the port's API model, filled alike from the
    CLI tests' files: two lexicons, a variant list, confusables, an LM."""
    files, inputs = cli_files
    models = []
    for api, kw in ((jax_api, {}), (port_api, {"device": "cpu"})):
        m = api.VariantModel(files["alphabet"], api.Weights(), debug=0, **kw)
        m.read_lexicon(files["lexicon"])
        m.read_vocabulary(files["lexicon2"], api.VocabParams(freqhandling="sum"))
        m.read_variants(files["variants"])
        m.read_variants(files["errors"], transparent=True)
        m.read_confusablelist(files["confusables"])
        m.read_lm(files["lm"])
        m.build()
        models.append(m)
    queries = [q for q in inputs["queries"].split("\n") if q]
    return models[0], models[1], queries, inputs["text"].split("\n")[:8]


def test_api_engine_is_the_port_model(api_models):
    from analiticcl_tpu_torch.models.variant_model import VariantModel

    _, port, _, _ = api_models
    assert isinstance(port.engine, VariantModel)
    assert port.engine.device.type == "cpu"


@pytest.mark.parametrize("freq_weight", [0.0, 1.0])
def test_find_variants_dicts_match_jax(api_models, freq_weight):
    jax, port, queries, _ = api_models
    kwargs = dict(max_edit_distance=2, score_threshold=0.0,
                  freq_weight=freq_weight)
    pp, jp = port_api.SearchParameters(**kwargs), jax_api.SearchParameters(**kwargs)
    got = [port.find_variants(q, pp) for q in queries[:40]]
    assert got == [jax.find_variants(q, jp) for q in queries[:40]]
    assert sum(map(len, got)) > 40
    par = port.find_variants_par(queries, pp)
    assert par == jax.find_variants_par(queries, jp)
    assert [r["variants"] for r in par[:40]] == got
    assert any("via" in v for r in par for v in r["variants"])


def test_find_all_matches_dicts_match_jax(api_models):
    jax, port, _, texts = api_models
    kwargs = dict(max_ngram=2, lm_weight=1.0)
    pp, jp = port_api.SearchParameters(**kwargs), jax_api.SearchParameters(**kwargs)
    for text in texts:
        got = port.find_all_matches(text, pp)
        assert got == jax.find_all_matches(text, jp)
        assert got and all("offset" in m for m in got)


def test_contains_matches_jax(api_models):
    jax, port, queries, _ = api_models
    probes = queries[:64] + ["", "xyzzy", queries[0].upper()]
    assert [q in port for q in probes] == [q in jax for q in probes]
    assert any(q in port for q in probes)


def test_api_default_device_has_no_fallback(cli_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    files, _ = cli_files
    with pytest.raises(RuntimeError, match="cuda"):
        port_api.VariantModel(files["alphabet"], port_api.Weights())


def _public(cls):
    """Public callables (and ``__init__``/``__contains__``) of ``cls`` with
    their parameter names."""
    out = {}
    for name, member in inspect.getmembers(cls):
        if name.startswith("_") and name not in ("__init__", "__contains__"):
            continue
        if inspect.isfunction(member):
            out[name] = list(inspect.signature(member).parameters)
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_api_surface_matches_jax(name):
    port, jax = _public(getattr(port_api, name)), _public(getattr(jax_api, name))
    assert sorted(port) == sorted(jax)
    for method, params in jax.items():
        extra = ["device"] if (name, method) == ("VariantModel", "__init__") else []
        assert port[method] == params + extra, method


def _stub(path: Path):
    """{class: {method: [parameter names]}} of a stub file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            out[node.name] = {
                f.name: [a.arg for a in f.args.args + f.args.kwonlyargs]
                for f in node.body if isinstance(f, ast.FunctionDef)
            }
    return out


def test_stub_declares_the_jax_stub_plus_device():
    port = _stub(REPO / "analiticcl_tpu_torch" / "api.pyi")
    jax = _stub(REPO / "analiticcl_tpu" / "api.pyi")
    assert sorted(port) == sorted(jax) == sorted(CLASSES)
    jax["VariantModel"]["__init__"].append("device")
    assert port == jax
    for cls, methods in port.items():
        have = _public(getattr(port_api, cls))
        assert set(methods) <= set(have), cls
