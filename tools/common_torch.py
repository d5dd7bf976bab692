"""Set-up shared by the port's profiling tools (``tools/*_torch.py``): the
model, its queries and parameters, and the card's line.

The model is built on ``testing.py``'s seeded synthetic lexicon (120,000
entries, eng.aspell's size, by default) or, with ``--lexicon``, read from a
lexicon file over the synthetic lexicon's alphabet. Queries are its words under one or two random edits; the
parameters are the main path's (``k_ana`` 3, ``k_ed`` 2, ``max_matches``
10, ``score_threshold`` 0.25). ``--device cuda`` without a card raises.
"""

from __future__ import annotations

import os
import subprocess
import sys

SEED = 0  # the synthetic lexicon's; queries and corpora take SEED + k

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def add_args(ap, batch: int = 4096) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default cuda; no fallback)")
    ap.add_argument("--lexicon", default=None,
                    help="a lexicon file instead of the seeded synthetic one")
    ap.add_argument("--n-lexicon", type=int, default=120_000,
                    help="entries of the synthetic lexicon")
    ap.add_argument("--batch", type=int, default=batch,
                    help="queries per batch")


def setup(args, n_queries: int):
    """``(model, words, queries, params)`` for the parsed ``args``."""
    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_lexicon,
    )
    from analiticcl_tpu_torch.vocab import VocabParams

    model = VariantModel(alphabet=ALPHABET, device=args.device)
    if args.lexicon:
        model.read_vocabulary(args.lexicon, VocabParams())
        model.build()
        words = [v.text for v in model.decoder]
    else:
        words = synthetic_lexicon(SEED, args.n_lexicon)
        populate(model, words)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    return model, words, corrupt_queries(words, SEED + 1, n_queries), \
        params


def card_line(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    that this is a CPU run."""
    if device != "cuda":
        return "cpu run: no card, device metrics not measured"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sync(device: str) -> None:
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
