"""Weighted variant lists (``-V``, both column layouts), error lists
(``-E``, transparent), context rules (``-R``), early confusables and
checkpoints that carry all of them: the port against the JAX package on
the CPU, with no tolerance.

Both packages read the same seeded files (``testing.synthetic_variants``,
``synthetic_errors``, ``synthetic_contextrules``): a 2,000-entry lexicon
with frequencies, 200 references with variants (160 in the two-column
layout, 40 in the frequency-bearing one), 80 with error forms, 14 rules
and a bigram LM. The JAX package runs its device backend on JAX's CPU,
the port ``device="cpu"``; parameters are built from the port's types and
carried over by ``to_ref``. Result tuples (text, dist_score, freq_score,
via) and search matches (offsets, selection, variants, tags and their
sequence numbers) must be equal, and the port's device path equal to its
host oracle."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import analiticcl_tpu.vocab as ref_vocab
from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    StopCriterion,
    VariantModel,
)
from analiticcl_tpu_torch.parallel.mesh import make_mesh
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    synthetic_bigrams,
    synthetic_confusables,
    synthetic_contextrules,
    synthetic_errors,
    synthetic_frequencies,
    synthetic_lexicon,
    synthetic_text,
    synthetic_variants,
)
from analiticcl_tpu_torch.vocab import VocabParams, VocabType
from test_torch_slice import to_ref

torch.set_num_threads(2)

N_WORDS = 2000
PARAMS = SearchParameters(
    max_anagram_distance=DistanceThreshold.absolute(3),
    max_edit_distance=DistanceThreshold.absolute(2),
    max_matches=10,
    score_threshold=0.25,
)
STOP = dataclasses.replace(
    PARAMS, stop_criterion=StopCriterion.STOP_AT_EXACT_MATCH)
SEARCH = dataclasses.replace(PARAMS, max_ngram=2, lm_weight=1.0)


def _write(path: Path, lines) -> str:
    path.write_text("".join(f"{line}\n" for line in lines), encoding="utf-8")
    return str(path)


def _forms(lines):
    """The forms of variant-list lines (either layout)."""
    out = []
    for line in lines:
        f = line.split("\t")
        rest, step = (f[2:], 3) if (len(f) - 2) % 3 == 0 and f[1].isdigit() \
            else (f[1:], 2)
        out += rest[::step]
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("variants")
    words = synthetic_lexicon(seed=41, n=N_WORDS)
    freqs = synthetic_frequencies(42, N_WORDS)
    bigrams = synthetic_bigrams(words, 43, 400)
    text = synthetic_text(words, 44, 24, bigrams)
    variants = synthetic_variants(words[100:260], 45)
    variants_freq = synthetic_variants(words[300:340], 46, freqs=True)
    errors = synthetic_errors(words[400:480], 47)
    files = {
        "lexicon": _write(d / "lexicon.tsv",
                          [f"{w}\t{f}" for w, f in zip(words, freqs)]),
        "variants": _write(d / "variants.tsv", variants),
        "variants_freq": _write(d / "variants_freq.tsv", variants_freq),
        "errors": _write(d / "errors.tsv", errors),
        "rules": _write(d / "rules.tsv",
                        synthetic_contextrules(words, bigrams, text, 2)),
        "lm": _write(d / "lm.tsv", [f"{b}\t{f}" for b, f in bigrams]),
        "confusables": _write(d / "confusables.tsv",
                              synthetic_confusables(words, 48)),
    }
    var_forms = _forms(variants) + _forms(variants_freq)
    err_forms = _forms(errors)
    rng = np.random.default_rng(49)
    text = [" ".join(err_forms[int(rng.integers(len(err_forms)))]
                     if rng.random() < 0.1 else tok
                     for tok in line.split(" ")) for line in text]
    queries = (corrupt_queries(words, 50, 96) + var_forms[:24] + err_forms[:24]
               + corrupt_queries(var_forms + err_forms, 51, 16) + words[:4]
               + [w.upper() for w in words[10:14]] + [""])
    return files, words, queries, text, set(err_forms)


def build(pkg, files, rules=True, lm=True, confusables=False):
    """A model of the JAX package (``"jax"``) or the port (``"port"``, on
    the CPU) read from the files as the API reads them, on its device
    backend."""
    if pkg == "jax":
        model, conv = JaxModel(alphabet=ALPHABET), to_ref
    else:
        model, conv = VariantModel(alphabet=ALPHABET, device="cpu"), \
            (lambda x: x)
    model.read_vocabulary(files["lexicon"], conv(VocabParams()))
    model.read_variants(files["variants"], conv(VocabParams()))
    model.read_variants(files["variants_freq"], conv(VocabParams()))
    model.read_variants(files["errors"], conv(VocabParams()), transparent=True)
    if rules:
        model.read_contextrules(files["rules"])
    if lm:
        model.read_vocabulary(files["lm"],
                              conv(VocabParams(vocab_type=VocabType.LM)))
    if confusables:
        model.read_confusablelist(files["confusables"])
        model.set_confusables_before_pruning()
    model.have_freq = True
    model.build()
    model.set_backend("device")
    return model


@pytest.fixture(scope="module")
def models(data):
    files = data[0]
    return build("jax", files), build("port", files)


def tuples(model, results):
    return [[(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score,
              r.via) for r in res] for res in results]


def matches(outs):
    return [[(m.text, m.offset.begin, m.offset.end, m.selected, m.n,
              list(m.tag), list(m.seqnr),
              None if m.variants is None else [
                  (r.vocab_id, r.dist_score, r.freq_score, r.via)
                  for r in m.variants])
             for m in out] for out in outs]


def decoder_tuples(model):
    return [(v.text, v.frequency, v.tokencount, v.lexindex, int(v.vocabtype),
             None if v.variants is None else
             [(r.kind.name, r.vocab_id, r.score) for r in v.variants])
            for v in model.decoder]


def model_state(model):
    """The rules, tags, confusables and flags a checkpoint carries, as
    plain values."""
    rules = [(r.score, list(r.tag), [tuple(t) for t in r.tagoffset],
              [repr(p) for p in r.pattern]) for r in model.context_rules]
    conf = [(c.weight, c.strictbegin, c.strictend) for c in model.confusables]
    return (rules, list(model.tags), conf, model.confusables_before_pruning,
            model.have_freq, model.have_lm, list(model.lexicons))


def variant_counts(model, results, err_forms):
    """(results through a variant link, results reached through an error
    form, error forms shown as a result's text that are no lexicon entry)."""
    n_via = n_err = shown = 0
    for res in results:
        for r in res:
            if r.via is not None:
                n_via += 1
                n_err += model.decoder[r.via].text in err_forms
            v = model.decoder[r.vocab_id]
            shown += v.text in err_forms and v.vocabtype & VocabType.TRANSPARENT
    return n_via, n_err, shown


@pytest.mark.parametrize("params", [PARAMS, STOP], ids=["all", "stop_exact"])
def test_variant_and_error_lists_match_jax(models, data, params):
    jax, port = models
    _, _, queries, _, err_forms = data
    got = port.find_variants_batch(queries, params)
    assert tuples(port, got) == tuples(
        jax, jax.find_variants_batch(queries, to_ref(params)))
    assert tuples(port, got) == tuples(
        port, [port._find_variants_oracle(q, params) for q in queries])
    n_via, n_err, shown = variant_counts(port, got, err_forms)
    assert n_via > 20 and n_err > 5 and shown == 0
    # rows with a linked survivor took the object tail
    assert port._device._has_variants.sum() > 300


def test_early_confusables_match_jax(data):
    files, _, queries, _, _ = data
    jax = build("jax", files, rules=False, lm=False, confusables=True)
    port = build("port", files, rules=False, lm=False, confusables=True)
    assert port.confusables_before_pruning and port.confusables
    got = tuples(port, port.find_variants_batch(queries, PARAMS))
    assert got == tuples(jax, jax.find_variants_batch(queries, to_ref(PARAMS)))
    assert got == tuples(
        port, [port._find_variants_oracle(q, PARAMS) for q in queries])
    plain = build("port", files, rules=False, lm=False)
    assert got != tuples(plain, plain.find_variants_batch(queries, PARAMS))


def test_search_with_rules_and_lm_matches_jax(models, data):
    jax, port = models
    text = data[3]
    got = matches(port.find_all_matches_batch(text, SEARCH))
    assert got == matches(jax.find_all_matches_batch(text, to_ref(SEARCH)))
    host = port._fam_prepare(text, SEARCH)
    found = [port._find_variants_oracle(q, SEARCH) for q in host[2]]
    assert got == matches(port._fam_consolidate(host[0], host[1], found,
                                                SEARCH))
    assert sum(bool(m[5]) for out in got for m in out) > 0  # a rule's tag


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoints_cross_with_lists_rules_and_confusables(data, tmp_path,
                                                           direction):
    files, _, queries, text, _ = data
    src = build("port" if direction == "port_to_jax" else "jax", files)
    src.read_confusablelist(files["confusables"])
    path = str(tmp_path / "model.npz")
    src.save(path)
    if direction == "port_to_jax":
        dst = JaxModel.load(path, backend="device")
        port, jax = src, dst
    else:
        dst = VariantModel.load(path, backend="device", device="cpu")
        port, jax = dst, src
    assert decoder_tuples(dst) == decoder_tuples(src)
    assert model_state(dst) == model_state(src)
    assert len(port.context_rules) == 14 and port.tags
    got = tuples(port, port.find_variants_batch(queries, PARAMS))
    assert got == tuples(jax, jax.find_variants_batch(queries, to_ref(PARAMS)))
    flags = np.array([port.decoder[v].variants is not None
                      for v in port.index.vocab_ids])
    assert np.array_equal(port._device._has_variants, flags) and flags.any()
    got = matches(port.find_all_matches_batch(text, SEARCH))
    assert got == matches(jax.find_all_matches_batch(text, to_ref(SEARCH)))


def test_loaded_checkpoint_on_a_mesh(models, data, tmp_path):
    """A port checkpoint of the model, loaded and sharded over a 1x4 mesh
    of the CPU, answers as the model it came from on one device."""
    _, port = models
    _, _, queries, text, _ = data
    path = str(tmp_path / "port.npz")
    port.save(path)
    back = VariantModel.load(path, device="cpu")
    want_q = tuples(port, port.find_variants_batch(queries, PARAMS))
    want_s = matches(port.find_all_matches_batch(text, SEARCH))
    assert tuples(back, back.find_variants_batch(queries, PARAMS)) == want_q
    back.use_mesh(make_mesh(["cpu"] * 4, dp=1))
    assert tuples(back, back.find_variants_batch(queries, PARAMS)) == want_q
    assert tuples(back, back.find_variants_batch(queries, STOP)) == tuples(
        port, port.find_variants_batch(queries, STOP))
    assert matches(back.find_all_matches_batch(text, SEARCH)) == want_s


def test_builders_are_seeded_and_read_alike(tmp_path):
    words = synthetic_lexicon(seed=52, n=400)
    bigrams = synthetic_bigrams(words, 53, 200)
    text = synthetic_text(words, 54, 40, bigrams)
    for fn in (synthetic_variants, synthetic_errors):
        assert fn(words[:50], 55) == fn(words[:50], 55)
        assert fn(words[:50], 55) != fn(words[:50], 56)
    assert synthetic_variants(words[:50], 55, freqs=True) == \
        synthetic_variants(words[:50], 55, freqs=True)
    rules = synthetic_contextrules(words, bigrams, text, 3)
    assert rules == synthetic_contextrules(words, bigrams, text, 3)
    assert len(rules) == 1 + 3 * 7 and rules[0].startswith("#")
    assert all(len(r.split("\t")) == 4 for r in rules[7::7])
    two = synthetic_variants(words[:50], 55)
    widths = {len(line.split("\t")) for line in two}
    assert widths <= {3, 5, 7} and len(widths) > 1
    assert all(len(line.split("\t")) in (3, 5)
               for line in synthetic_errors(words[:50], 55))
    freq = synthetic_variants(words[50:90], 57, freqs=True)
    assert all((len(line.split("\t")) - 2) % 3 == 0 for line in freq)
    paths = {"two": _write(tmp_path / "two.tsv", two),
             "freq": _write(tmp_path / "freq.tsv", freq)}
    for name, path in paths.items():
        got = []
        for pkg in ("jax", "port"):
            model = (JaxModel(alphabet=ALPHABET) if pkg == "jax" else
                     VariantModel(alphabet=ALPHABET, device="cpu"))
            vp = VocabParams() if pkg == "port" else ref_vocab.VocabParams()
            for w in words:
                model.add_to_vocabulary(w, None, vp)
            model.read_variants(path, vp, transparent=name == "freq")
            got.append(decoder_tuples(model))
        assert got[0] == got[1]
        n_linked = sum(t[5] is not None for t in got[1])
        assert n_linked > (50 if name == "two" else 40)
        if name == "freq":  # the forms carry their frequencies
            assert {t[1] for t in got[1][len(words) + 3:]} - {1}


@pytest.mark.parametrize("batch", [None, 96], ids=["one_batch", "batches"])
def test_strict_learn_looks_up_every_input_before_the_merge(data, monkeypatch,
                                                           batch):
    """F13: strict learn looks every input up before it merges any link,
    as the reference collects its lookups (lib.rs:1086-1088). With variant
    lists a lexicon word among the inputs gains VARIANT_OF links, and a
    later input that finds it would be expanded through them if it were
    looked up after the merge: the host oracle's path did that, and so
    did the device path's later batches. Both backends, in one batch or
    several, now give the links of the JAX package's device path in one
    batch; the JAX package's host path keeps the fault."""
    from analiticcl_tpu_torch.models import variant_model

    files, words = data[0], data[1]
    inputs = words[100:260] + corrupt_queries(words[100:260], 62, 160)
    learned = {}
    for name in ("port_device", "port_oracle", "jax_device", "jax_oracle"):
        pkg, backend = name.split("_")
        model = build(pkg, files, rules=False, lm=False)
        model.set_backend(backend)
        if pkg == "port" and batch:
            monkeypatch.setattr(variant_model, "LEARN_BATCH", batch)
        params = PARAMS if pkg == "port" else to_ref(PARAMS)
        assert model.learn_variants(inputs, params, strict=True) > 0
        learned[name] = decoder_tuples(model)
    assert learned["port_device"] == learned["port_oracle"]
    assert learned["port_device"] == learned["jax_device"]
    assert learned["jax_oracle"] != learned["jax_device"]


@pytest.mark.parametrize("mesh", [None, 2], ids=["one_device", "mesh_1x2"])
def test_confusables_set_after_serving_reach_over_long_queries(mesh):
    """F14: a query longer than every index entry takes the host oracle,
    whose results the pipeline keeps in a memo. Setting early confusables,
    or adding a confusable, on a model that has served such a query gives
    the results of the model as it now is, not those kept from before: the
    memo's key holds the early-confusables flag and the confusable count.
    Held against a JAX model built with the same confusables from the
    start. The confusable favours the second candidate, so cropping to
    one match before or after it gives different results."""
    words = [w for w in synthetic_lexicon(seed=71, n=200) if len(w) < 10]
    words += ["abcdefghijkl", "abcdefghijkm"]
    params = dataclasses.replace(PARAMS, max_matches=1, score_threshold=0.0)
    queries = ["abcdefghijklq", "abcdefghijkq", words[0]]

    def make(pkg, confusable=None, early=False):
        model = (JaxModel(alphabet=ALPHABET) if pkg == "jax" else
                 VariantModel(alphabet=ALPHABET, device="cpu"))
        vp = VocabParams() if pkg == "port" else ref_vocab.VocabParams()
        for w in words:
            model.add_to_vocabulary(w, None, vp)
        if confusable:
            model.add_to_confusables(*confusable)
        if early:
            model.set_confusables_before_pruning()
        model.build()
        model.set_backend("device")
        return model

    def jax_wants(confusable, early):
        jax = make("jax", confusable, early)
        return tuples(jax, jax.find_variants_batch(queries, to_ref(params)))

    port = make("port", ("+[m]", 2.0))
    if mesh:
        port.use_mesh(make_mesh(["cpu"] * mesh, dp=1))
    late = tuples(port, port.find_variants_batch(queries, params))
    assert port._device.L < len(queries[0])  # over-long: the host oracle
    assert late == jax_wants(("+[m]", 2.0), False)
    port.set_confusables_before_pruning()
    early = tuples(port, port.find_variants_batch(queries, params))
    assert early == jax_wants(("+[m]", 2.0), True)
    assert early[0] != late[0]
    port.confusables_before_pruning = False
    assert tuples(port, port.find_variants_batch(queries, params)) == late
    plain = make("port")
    if mesh:
        plain.use_mesh(make_mesh(["cpu"] * mesh, dp=1))
    before = tuples(plain, plain.find_variants_batch(queries, params))
    assert before == jax_wants(None, False)
    plain.add_to_confusables("+[m]", 2.0)
    assert tuples(plain, plain.find_variants_batch(queries, params)) == late
    assert late != before
    plain.set_confusables_before_pruning()
    assert tuples(plain, plain.find_variants_batch(queries, params)) == early
