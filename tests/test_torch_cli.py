"""The port's CLI against the JAX package's CLI on the CPU, byte for byte:
query mode (every output flag, confusables late and early, variant and
error lists, the default backend), index and testinput, the Rust-style
float formatting, the ``--device`` flag's missing fallback, a subprocess
run that loads neither JAX nor ``analiticcl_tpu``, and the console script
in ``pyproject.toml``. Search and learn mode are in
``test_torch_cli_modes.py``, which uses this file's helpers.

Both ``main(argv)`` functions run in-process, each building its own model
from files in a temporary directory: a seeded 3,000-entry lexicon with
frequencies, a second disjoint lexicon, the alphabet, corrupted queries,
running text, and confusable, context-rule, variant and error lists made
from the seeded words. The JAX package runs with ``--backend device`` on
JAX's CPU backend, the port with ``--backend device --device cpu``.
"""

import contextlib
import gc
import io
import os
import subprocess
import sys
import tomllib
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from analiticcl_tpu.cli import main as jax_main
from analiticcl_tpu_torch import cli as port_cli
from analiticcl_tpu_torch.editscript import script_to_str, shortest_edit_script
from analiticcl_tpu_torch.testing import (
    ALPHABET,
    corrupt_queries,
    synthetic_bigrams,
    synthetic_contextrules,
    synthetic_errors,
    synthetic_frequencies,
    synthetic_lexicon,
    synthetic_text,
    synthetic_variants,
)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N_WORDS = 3000


def _write(path: Path, lines) -> str:
    path.write_text("".join(f"{line}\n" for line in lines), encoding="utf-8")
    return str(path)


def _confusables(words, seed: int):
    """Weighted confusables: the changed part of the edit script from a
    corrupted word to its lexicon word, for the first distinct scripts, one
    of them anchored at the word's start."""
    rng = np.random.default_rng(seed)
    seen, out = set(), []
    for w in (words[int(k)] for k in rng.integers(len(words), size=400)):
        bad = corrupt_queries([w], int(rng.integers(1 << 30)), 1)[0]
        core = [ins for ins in shortest_edit_script(bad, w)
                if ins.op.value != "="]
        pat = script_to_str(core)
        if (len(core) == 2 and core[0].text != core[1].text
                and pat not in seen):
            seen.add(pat)
            out.append(pat)
        if len(out) == 6:
            break
    weights = (1.2, 0.8, 1.1, 1.05, 0.9, 1.3)
    lines = [f"{p}\t{wt}" for p, wt in zip(out, weights)]
    lines.append(f"^=[{words[0][0].lower()}]-[e]\t1.15")
    return lines


@pytest.fixture(scope="session")
def cli_files(tmp_path_factory):
    """The inputs of every CLI case, written once: paths by name."""
    d = tmp_path_factory.mktemp("cli")
    words = synthetic_lexicon(seed=21, n=N_WORDS)
    freqs = synthetic_frequencies(22, N_WORDS)
    known = set(words)
    other = [w for w in synthetic_lexicon(seed=23, n=600) if w not in known][:400]
    bigrams = synthetic_bigrams(words, 27, 300)
    text = synthetic_text(words, 26, 24, bigrams)
    # variant and error lists: a lexicon word, then one or two corrupted
    # forms with a score
    variants = synthetic_variants(words[100:140], 30, scores=(0.9,))
    errors = synthetic_errors(words[200:240], 80, scores=(1, 0.75), stride=50)
    queries = (corrupt_queries(words, 24, 112) + corrupt_queries(other, 25, 16)
               + [line.split("\t")[1] for line in variants[:8]]
               + [line.split("\t")[1] for line in errors[:8]]
               + words[:4] + [words[5].upper(), ""])
    # context rules over word pairs of the bigram list that the text holds,
    # and single words
    rules = synthetic_contextrules(words, bigrams, text)
    unicode_text = [
        line.replace(" ", " café ", 1).replace(" ", " naïve—", 3)
        + " Grüße"
        for line in text[:12]
    ]
    files = {
        "alphabet": _write(d / "alphabet.tsv", ["\t".join(c) for c in ALPHABET]),
        "lexicon": _write(d / "lexicon.tsv",
                          [f"{w}\t{f}" for w, f in zip(words, freqs)]),
        "lexicon2": _write(d / "other.tsv", [f"{w}\t5" for w in other]),
        "lm": _write(d / "lm.tsv", [f"{b}\t{f}" for b, f in bigrams]),
        "confusables": _write(d / "confusables.tsv", _confusables(words, 28)),
        "rules": _write(d / "rules.tsv", rules),
        "variants": _write(d / "variants.tsv", variants),
        "errors": _write(d / "errors.tsv", errors),
    }
    inputs = {
        "queries": "\n".join(queries) + "\n",
        "text": "\n".join(text) + "\n",
        "unicode": "\n".join(unicode_text) + "\n",
        "paragraphs": "\n".join(text[:6] + [""] + text[6:12]) + "\n",
        "learn_words": "\n".join(corrupt_queries(words, 29, 64)) + "\n",
        "learn_text": "\n".join(synthetic_text(words, 31, 12)) + "\n",
    }
    return files, inputs


def run_main(main, argv, stdin: str) -> str:
    """``main(argv)`` with ``stdin`` as its standard input: its standard
    output (its standard error is dropped)."""
    out = io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = main(list(argv))
    finally:
        sys.stdin = old
    assert rc == 0, argv
    return out.getvalue()


def both(argv, stdin: str, backend=("--backend", "device")):
    """The JAX package's and the port's output for one command line; the
    port on the CPU."""
    want = run_main(jax_main, [*argv, *backend], stdin)
    got = run_main(port_cli.main, [*argv, *backend, "--device", "cpu"], stdin)
    return want, got


def _common(files, *resources):
    argv = ["-a", files["alphabet"], "-l", files["lexicon"]]
    for r in resources:
        argv += ["-l", files[r]]
    return argv


QUERY_CASES = {
    "tsv": [],
    "json": ["--json"],
    "lexmatch_two_lexicons": ["--output-lexmatch", "@lexicon2"],
    "stop_exact": ["-s"],
    "freq_ranking": ["-F", "1"],
    "ratio_thresholds": ["-k", "0.5;6", "-d", "0.5;12"],
    "confusables_late": ["-C", "@confusables"],
    "confusables_early": ["-C", "@confusables", "--early-confusables"],
    "variants_errors": ["-V", "@variants", "-E", "@errors", "--json"],
}


def _expand(files, extra):
    """``@name`` in a case's arguments is the path of that input file; an
    ``@lexicon2`` stands for a second ``-l``."""
    argv = []
    for a in extra:
        if a == "@lexicon2":
            argv += ["-l", files["lexicon2"]]
        elif a.startswith("@"):
            argv.append(files[a[1:]])
        else:
            argv.append(a)
    return argv


@pytest.mark.parametrize("case", sorted(QUERY_CASES))
def test_query_matches_jax_cli(cli_files, case):
    files, inputs = cli_files
    argv = ["query", *_common(files), *_expand(files, QUERY_CASES[case])]
    want, got = both(argv, inputs["queries"])
    assert got == want
    assert got.count("\n") >= inputs["queries"].count("\n")
    if case != "json" and case != "variants_errors":
        assert got.count("\t") > 400


def test_query_confusables_change_the_ranking(cli_files):
    """The confusable list is not inert on these queries: late and early
    rescoring each change the port's output."""
    files, inputs = cli_files
    base = ["query", *_common(files), "--backend", "device", "--device", "cpu"]
    plain = run_main(port_cli.main, base, inputs["queries"])
    late = run_main(port_cli.main, base + ["-C", files["confusables"]],
                    inputs["queries"])
    early = run_main(port_cli.main, base + ["-C", files["confusables"],
                                            "--early-confusables"],
                     inputs["queries"])
    assert plain != late and plain != early


def test_query_interactive_matches_jax_cli(cli_files):
    files, inputs = cli_files
    stdin = "\n".join(inputs["queries"].split("\n")[:12]) + "\n"
    want, got = both(["query", *_common(files), "-x"], stdin)
    assert got == want and got.count("\n") == 12


def test_query_default_backend_matches_jax_cli(cli_files):
    """``--backend auto``: the device path from 64 index entries up, in
    both packages."""
    files, inputs = cli_files
    want, got = both(["query", *_common(files)], inputs["queries"], backend=())
    assert got == want


def test_index_matches_jax_cli(cli_files):
    files, _ = cli_files
    want, got = both(["index", *_common(files, "lexicon2")], "")
    assert got == want
    assert got.count("\n") > N_WORDS // 2


def test_testinput_matches_jax_cli(cli_files):
    files, inputs = cli_files
    stdin = inputs["queries"] + inputs["unicode"]
    want = run_main(jax_main, ["testinput", "-a", files["alphabet"]], stdin)
    got = run_main(port_cli.main, ["testinput", "-a", files["alphabet"]], stdin)
    assert got == want and got.startswith("OK: ")


def test_testinput_builds_no_model(cli_files, monkeypatch):
    """testinput runs without a card even at the default ``--device cuda``."""
    files, _ = cli_files

    def no_model(*a, **k):
        raise AssertionError("testinput built a model")

    monkeypatch.setattr(port_cli, "VariantModel", no_model)
    got = run_main(port_cli.main, ["testinput", "-a", files["alphabet"]],
                   "hello\n")
    assert got.startswith("OK: hello\t")


@pytest.mark.parametrize("backend", ["device", "oracle"])
def test_default_device_has_no_fallback(cli_files, backend):
    """Without ``--device`` the model goes to CUDA; without a card that
    raises at the model's construction, whatever the backend."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    files, inputs = cli_files
    argv = ["query", *_common(files), "--backend", backend]
    with pytest.raises(RuntimeError, match="cuda"):
        run_main(port_cli.main, argv, inputs["queries"])


def test_main_releases_the_model(cli_files, monkeypatch):
    """main() freezes the GC heap while it serves and thaws it on return,
    so a model (a reference cycle with its pipeline) is freed for the next
    main() in the same process."""
    files, inputs = cli_files
    made = []
    real = port_cli.build_model_from_args

    def spy(args):
        model, params = real(args)
        made.append(weakref.ref(model))
        return model, params

    monkeypatch.setattr(port_cli, "build_model_from_args", spy)
    argv = ["query", *_common(files), "--backend", "device", "--device", "cpu"]
    first = run_main(port_cli.main, argv, inputs["queries"])
    assert gc.get_freeze_count() == 0
    assert run_main(port_cli.main, argv, inputs["queries"]) == first
    gc.collect()
    assert len(made) == 2 and all(ref() is None for ref in made)


def test_provenance_and_gc_helpers():
    """The port's provenance stamps name the checkout's commit, as the JAX
    package's do; the heap freeze freezes the live objects."""
    from analiticcl_tpu.utils import provenance as jax_provenance
    from analiticcl_tpu_torch.utils import gc_tuning, provenance

    assert Path(provenance._REPO) == REPO
    assert provenance.git_state() == jax_provenance.git_state()
    rec = provenance.stamp({"kernels": []})
    assert set(rec) == {"kernels", "commit", "dirty", "timestamp"}
    assert rec["timestamp"].endswith("Z")
    try:
        assert gc_tuning.freeze_model_heap() > 0
    finally:
        gc.unfreeze()
    assert gc.get_freeze_count() == 0


def test_fmt_float_rust_display_semantics():
    """Rust's `{}` f64 Display: shortest round-trip digits, plain decimal
    (never scientific), integers without '.0'."""
    from analiticcl_tpu.cli import _fmt_float as jax_fmt

    cases = [
        (1.0, "1"),
        (0.0, "0"),
        (0.734375, "0.734375"),
        (0.7083333333333334, "0.7083333333333334"),
        (1e-05, "0.00001"),
        (1.5e-07, "0.00000015"),
        (1e-09, "0.000000001"),
        (1e16, "10000000000000000"),
        (1.23e17, "123000000000000000"),
        (-0.5, "-0.5"),
        (-1e-06, "-0.000001"),
    ]
    for x, want in cases:
        got = port_cli._fmt_float(x)
        assert got == want == jax_fmt(x), (x, got, want)
        assert float(got) == x
    for x in (float("nan"), float("inf"), float("-inf")):
        assert port_cli._fmt_float(x) == jax_fmt(x)


def test_cli_subprocess_loads_no_jax(cli_files):
    """``python -m analiticcl_tpu_torch.cli`` gives the in-process output
    and imports no module of JAX or of the JAX package (``-X importtime``
    lists every module the process imported)."""
    files, inputs = cli_files
    argv = ["query", *_common(files), "--backend", "device", "--device", "cpu"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "analiticcl_tpu_torch.cli",
         *argv],
        input=inputs["queries"], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == run_main(port_cli.main, argv, inputs["queries"])
    imported = [line.rsplit("|", 1)[1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:") and "|" in line]
    assert any(m.startswith("analiticcl_tpu_torch") for m in imported)
    bad = [m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "analiticcl_tpu")]
    assert not bad, bad


def test_pyproject_names_the_console_script_and_stub():
    project = tomllib.loads((REPO / "pyproject.toml").read_text())
    scripts = project["project"]["scripts"]
    assert scripts["analiticcl-tpu-torch"] == "analiticcl_tpu_torch.cli:_main_cli"
    assert scripts["analiticcl-tpu"] == "analiticcl_tpu.cli:_main_cli"
    data = project["tool"]["setuptools"]["package-data"]["analiticcl_tpu_torch"]
    port = REPO / "analiticcl_tpu_torch"
    shipped = {p for pat in data for p in port.glob(pat)}
    assert port / "api.pyi" in shipped
    assert callable(port_cli._main_cli)
