"""Search and learn mode of the port's CLI against the JAX package's CLI on
the CPU, byte for byte (stdout, and the per-lexicon files of
``--multi-output``). The inputs and helpers are ``test_torch_cli.py``'s."""

import shutil

import pytest
import torch

from analiticcl_tpu.cli import main as jax_main
from analiticcl_tpu_torch import cli as port_cli
from test_torch_cli import (  # noqa: F401 (cli_files is a fixture)
    _common, both, cli_files, run_main,
)

torch.set_num_threads(2)

# (arguments, input): ``@name`` is the path of that input file
SEARCH_CASES = {
    "bigrams_tsv": (["-N", "2"], "text"),
    "bigrams_json": (["-N", "2", "--json"], "text"),
    "lm": (["-N", "2", "--lm", "@lm"], "text"),
    "context_rules": (["-N", "2", "-R", "@rules", "--json"], "text"),
    "unicode_offsets": (["-N", "1", "-u"], "unicode"),
    "per_line": (["-N", "1", "--per-line"], "paragraphs"),
    "retain_linebreaks": (["-N", "1", "--retain-linebreaks"], "paragraphs"),
}

LEARN_CASES = {
    "strict_tsv": (["--strict"], "learn_words"),
    "strict_json": (["--strict", "--json"], "learn_words"),
    "iterations": (["-I", "2", "-N", "2"], "learn_text"),
}


def _args(files, extra):
    return [files[a[1:]] if a.startswith("@") else a for a in extra]


@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_search_matches_jax_cli(cli_files, case):
    files, inputs = cli_files
    extra, source = SEARCH_CASES[case]
    want, got = both(["search", *_common(files), *_args(files, extra)],
                     inputs[source])
    assert got == want
    assert got.count("\n") > 100
    if case == "context_rules":
        assert '"tag": [' in got


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_learn_matches_jax_cli(cli_files, case):
    files, inputs = cli_files
    extra, source = LEARN_CASES[case]
    want, got = both(["learn", *_common(files), *_args(files, extra)],
                     inputs[source])
    assert got == want
    assert got.count("\n") > 4


@pytest.mark.parametrize("fmt", ["tsv", "json"])
def test_learn_multi_output_matches_jax_cli(cli_files, tmp_path, fmt):
    """``--multi-output`` writes ``<lexicon>.variants.<fmt>`` beside each
    lexicon: both packages write the same files and the same stdout."""
    files, inputs = cli_files
    lexicons = []
    for name in ("lexicon", "lexicon2"):
        path = tmp_path / f"{name}.tsv"
        shutil.copy(files[name], path)
        lexicons.append(path)
    argv = ["learn", "-a", files["alphabet"], "--strict", "--multi-output",
            "-V", files["variants"]]
    for path in lexicons:
        argv += ["-l", str(path)]
    if fmt == "json":
        argv.append("--json")
    stdin = inputs["learn_words"] + inputs["queries"]

    def run(main, device=()):
        out = run_main(main, [*argv, "--backend", "device", *device], stdin)
        written = {}
        for lex in lexicons:
            path = lex.with_name(lex.name + f".variants.{fmt}")
            if path.exists():
                written[path.name] = path.read_text(encoding="utf-8")
                path.unlink()
        return out, written

    want = run(jax_main)
    got = run(port_cli.main, ("--device", "cpu"))
    assert got == want
    assert got[1] and all(got[1].values())
