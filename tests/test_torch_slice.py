"""The port's query path end to end on the CPU: ``analiticcl_tpu_torch``'s
VariantModel against the JAX package's device backend and the host oracle,
with exact result tuples (text, dist_score, freq_score, via); and the port's
promise to stand alone: it loads neither JAX nor ``analiticcl_tpu``.

The two packages' dataclasses and enums are distinct classes, so parameters
are built from the port's types and carried to the JAX package's by
:func:`to_ref` (and back by :func:`to_port`), and a JAX-package model is
populated by :func:`ref_populate`.
"""

import ast
import dataclasses
import enum
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import analiticcl_tpu.types as ref_types
import analiticcl_tpu.vocab as ref_vocab
from analiticcl_tpu.models.variant_model import VariantModel as JaxModel
import analiticcl_tpu_torch.types as port_types
import analiticcl_tpu_torch.vocab as port_vocab
from analiticcl_tpu_torch import (
    DistanceThreshold,
    SearchParameters,
    VariantModel,
)
from analiticcl_tpu_torch.device import resolve_device
from analiticcl_tpu_torch.ops.dl import dl_lcs
from analiticcl_tpu_torch.ops.stage_a import stage_a_masks
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    populate,
    synthetic_frequencies,
    synthetic_lexicon,
)
from test_pipeline import QUERIES

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_class(name):
    for mod in (ref_types, ref_vocab):
        if hasattr(mod, name):
            return getattr(mod, name)
    raise KeyError(name)


def to_ref(x):
    """The JAX package's counterpart of a port value: enums and dataclasses
    (SearchParameters, DistanceThreshold, VocabParams, ...) are rebuilt
    field by field from the same values; other values pass through."""
    if isinstance(x, enum.Enum):
        return _ref_class(type(x).__name__)(x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _ref_class(type(x).__name__)(**{
            f.name: to_ref(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init
        })
    return x


def to_port(x):
    """The port's counterpart of a JAX-package value (the inverse of
    :func:`to_ref`)."""
    if isinstance(x, enum.Enum):
        mod = port_types if hasattr(port_types, type(x).__name__) else port_vocab
        return getattr(mod, type(x).__name__)(x.value)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        mod = port_types if hasattr(port_types, type(x).__name__) else port_vocab
        return getattr(mod, type(x).__name__)(**{
            f.name: to_port(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init
        })
    return x


def ref_populate(model, words, freqs=None, bigrams=None):
    """``testing.populate`` for a JAX-package model (its own VocabParams)."""
    vp = ref_vocab.VocabParams()
    for i, w in enumerate(words):
        model.add_to_vocabulary(w, None if freqs is None else int(freqs[i]), vp)
    lm = ref_vocab.VocabParams(vocab_type=ref_vocab.VocabType.LM)
    for text, freq in bigrams or ():
        model.add_to_vocabulary(text, freq, lm)
    model.have_freq = freqs is not None
    model.build()
    return model
PARAMS = {
    "absolute": SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    ),
    # ratio thresholds reach the W=6 and W=12 windows and the window split
    "ratio": SearchParameters(
        max_anagram_distance=DistanceThreshold.ratio_with_limit(0.5, 6),
        max_edit_distance=DistanceThreshold.ratio_with_limit(0.5, 12),
        max_matches=10,
        score_threshold=0.25,
    ),
}


@pytest.fixture(scope="module")
def words():
    return synthetic_lexicon(seed=5, n=6000)


@pytest.fixture(scope="module")
def queries(words):
    return QUERIES + corrupt_queries(words, 13, 256)


def _tuples(model, results):
    return [
        [(model.decoder[r.vocab_id].text, r.dist_score, r.freq_score, r.via)
         for r in res]
        for res in results
    ]


@pytest.mark.parametrize("with_freq", [False, True], ids=["nofreq", "freq"])
@pytest.mark.parametrize("kind", ["absolute", "ratio"])
def test_port_matches_jax_and_oracle(words, queries, kind, with_freq):
    params = PARAMS[kind]
    freqs = synthetic_frequencies(9, len(words)) if with_freq else None
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    ref = ref_populate(JaxModel(alphabet=ALPHABET), words, freqs)
    ref.set_backend("device")
    got = _tuples(port, port.find_variants_batch(queries, params))
    streamed = _tuples(
        port, list(port.find_variants_stream(queries, params, batch_size=100))
    )
    want = _tuples(ref, ref.find_variants_batch(queries, to_ref(params)))
    oracle = _tuples(port, [port._find_variants_oracle(q, params) for q in queries])
    assert sum(map(len, got)) > len(queries)
    for q, g, s, w, o in zip(queries, got, streamed, want, oracle):
        assert g == s == w == o, q
    if kind == "ratio":
        lens = port.enc.normalize_batch_padded(queries, port._device.L)[1]
        assert (lens >= 14).any() and (lens < 7).any()  # W=12 and W=3 groups


def test_small_lexicon_takes_the_oracle(words):
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words[:40])
    res = port.find_variants_batch(["abc", words[3]], PARAMS["absolute"])
    assert port._device is None
    assert res == [port._find_variants_oracle(q, PARAMS["absolute"])
                   for q in ["abc", words[3]]]


def test_refresh_freqs_matches_rebuild(words):
    params = PARAMS["absolute"]
    freqs = synthetic_frequencies(1, len(words))
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, freqs)
    qs = corrupt_queries(words, 2, 64)
    port.find_variants_batch(qs, params)
    new = synthetic_frequencies(2, len(words))
    for i, w in enumerate(words):
        port.decoder[port.encoder[w]].frequency = int(new[i])
    idx = port.index
    idx.freqs = np.array(
        [port.decoder[v].frequency for v in idx.vocab_ids], dtype=np.float64
    )
    port._device.refresh_freqs(idx.freqs)
    fresh = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words, new)
    assert _tuples(port, port.find_variants_batch(qs, params)) == _tuples(
        fresh, fresh.find_variants_batch(qs, params)
    )


def test_explicit_device_and_no_fallback():
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            VariantModel(alphabet=ALPHABET)  # the default device is "cuda"


def test_cpu_run_launches_no_kernel(words, queries):
    port = populate(VariantModel(alphabet=ALPHABET, device="cpu"), words)
    before = (stage_a_masks.launches, dl_lcs.launches)
    port.find_variants_batch(queries[:32], PARAMS["absolute"])
    assert (stage_a_masks.launches, dl_lcs.launches) == before


def test_port_never_imports_jax():
    """Query (on one device and on a mesh), search (with and without an LM,
    batch and stream), learn (strict and not) and a save/load round trip,
    each on a fresh model, load no JAX module and no module of the JAX
    package."""
    script = textwrap.dedent(
        """
        import os
        import sys
        import tempfile
        import torch
        torch.set_num_threads(1)
        import analiticcl_tpu_torch as at
        from analiticcl_tpu_torch.ops.pipeline import DevicePipeline
        from analiticcl_tpu_torch.parallel.mesh import make_mesh
        from analiticcl_tpu_torch.testing import (
            ALPHABET, populate, synthetic_bigrams, synthetic_lexicon,
            synthetic_text,
        )
        words = synthetic_lexicon(seed=1, n=300)
        texts = synthetic_text(words, 2, 6)
        bigrams = synthetic_bigrams(words, 3, 50)

        def fresh(lm=False):
            return populate(at.VariantModel(alphabet=ALPHABET, device="cpu"),
                            words, bigrams=bigrams if lm else None)

        params = at.SearchParameters(
            max_anagram_distance=at.DistanceThreshold.absolute(3),
            max_edit_distance=at.DistanceThreshold.absolute(2),
        )
        model = fresh()
        res = model.find_variants_batch([words[0][:-1] + "x"], params)
        res += list(model.find_variants_stream([words[1]], params))
        assert res[1], res
        models = [model]
        model = fresh()
        model.use_mesh(make_mesh(["cpu"] * 4, dp=2))
        assert model.find_variants_batch([words[1]], params) == [res[1]]
        models.append(model)
        model = fresh()
        assert model.find_all_matches(texts[0], params)
        models.append(model)
        model = fresh(lm=True)
        assert model.have_lm
        assert model.find_all_matches(texts[1], params)
        models.append(model)
        model = fresh(lm=True)
        assert len(list(model.find_all_matches_stream(texts, params))) == 6
        models.append(model)
        for strict in (True, False):
            model = fresh()
            assert model.learn_variants(texts if not strict else
                                        [w + "e" for w in words[:40]],
                                        params, strict=strict) > 0
            models.append(model)
        for m in models:
            assert isinstance(m._device, DevicePipeline), m._device
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "model.npz")
            model.save(path)
            back = at.VariantModel.load(path, device="cpu")
            q = [w + "e" for w in words[:8]]
            assert back.find_variants_batch(q, params) == \
                model.find_variants_batch(q, params)
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        ref = sorted(m for m in sys.modules if m.split(".")[0] == "analiticcl_tpu")
        assert not ref, ref
        print("ok")
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _imported_modules(path: Path):
    """Every module an ``import`` or ``from ... import`` in ``path`` names,
    at any depth (lazy imports inside functions included); relative imports
    come back with their leading dots."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_port_sources_import_nothing_of_the_jax_package():
    """No file of the port, not chip_smoke.py and not the port's tools
    (``tools/*_torch.py``) imports ``analiticcl_tpu`` or JAX, and no
    relative import climbs out of the port's package."""
    root = Path(REPO)
    files = sorted((root / "analiticcl_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    tools = sorted((root / "tools").glob("*_torch.py"))
    assert len(files) > 20 and len(tools) >= 4
    files += tools
    bad = []
    for path in files:
        depth = len(path.relative_to(root).parts) - 1  # package depth
        for name in _imported_modules(path):
            top = name.lstrip(".").split(".")[0]
            level = len(name) - len(name.lstrip("."))
            if top in ("analiticcl_tpu", "jax", "jaxlib") or level > depth:
                bad.append(f"{path.relative_to(root)}: {name}")
    assert not bad, bad
