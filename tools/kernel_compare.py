#!/usr/bin/env python3
"""The query core's kernels K1 and glue in two checkouts, timed in turns
on one CUDA card.

    python3 tools/kernel_compare.py OTHER_ROOT

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists. The turns run other, this, this, other, each in a fresh process
that imports ``analiticcl_tpu_torch`` and ``chip_smoke`` from its
checkout (and builds that checkout's kernels): it builds chip_smoke's main
model (the seeded 120,000-entry lexicon), holds the kernels against their
plain versions on the main path's first batch of 4,096 queries and times
them there by its checkout's ``chip_smoke.glue_records`` (K3, K2's slot
entry with its epilogue at W 3/6/12, K4, K5: CUDA events over 10
back-to-back calls and the profiler's device time). It times K1 the same
way, held bit for bit against its plain version first: on that batch
(the main instance, planes 224 wide), on seeded planes 608, 864, 960
and 1,664 wide (``chip_smoke.k1_direct_inputs``: 4,096 queries over a
band of 89 blocks of 131,072 rows, every block at the full width), and
on the first batch of 4,096 of chip_smoke's phase 13 (the main lexicon
plus ``chip_smoke.planes_words()``: planes 1,664 wide, whose band reaches
the block of the two long entries) and on its 4,096 shortest other
queries, each at the instance its checkout routes it to (a checkout
with block extents passes them and the band plan's width); a width the
checkout refuses is recorded as refused.
Prints the card's name and power limit, one JSON line per turn and, per
kernel, the device times in turn order. Imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
KEYS = ("ms", "device_ms", "bound_ms", "bound_full_ms")
K1_T = (20, 28, 32, 55)  # planes 30 x T wide: 608, 864, 960, 1,664


def k1_record(chip_smoke, args, at: int, peaks) -> dict:
    """K1 on ``args`` (its wrapper's arguments, with the block extents and
    the width where the checkout takes them; planes ``at`` wide before
    padding): held bit for bit, then timed, at the checkout's instance."""
    from analiticcl_tpu_torch.ops import stage_a
    from analiticcl_tpu_torch.utils.roofline import k1_bound_ms

    def run():
        stage_a.stage_a_masks(*args)

    try:
        chip_smoke.hold_k1(*args)
    except ValueError as e:  # a width the checkout's wrapper refuses
        return {"ms": None, "device_ms": None, "bound_ms": None,
                "bound_full_ms": None, "refused": str(e)}
    extents = len(args) > 9
    route = stage_a.kernel_instance
    B, start_blk, nb_band = args[3].shape[0], args[7], args[8]
    rec = {"ms": chip_smoke.time_ms(run, 10, inner=10),
           "device_ms": chip_smoke.device_ms(run, "stage_a_kernel", 10),
           "bound_full_ms": k1_bound_ms(at, B, start_blk, nb_band, peaks)[0],
           "instance": (route(args[10], args[0].shape[1], 128, "cuda")
                        if extents else route(args[0].shape[1], 128, "cuda"))}
    if extents:
        from analiticcl_tpu_torch.convert import block_columns

        rec["width"] = args[10]
        # the least work: each band block at the columns its rows use
        rec["bound_ms"] = k1_bound_ms(at, B, start_blk, nb_band, peaks,
                                      columns=block_columns(args[0]))[0]
    return rec


def batch_args(chip_smoke, pipe, lookups, params) -> tuple:
    """K1's wrapper arguments on ``lookups`` as one batch of ``pipe``, as
    the checkout's path gives them."""
    st = chip_smoke.prepared(pipe, lookups, params)
    (q_counts, q_cc, _qn, _ql, _qf, k_ana, _ke, k_len, _se, start_blk, _w,
     _thr) = st["args"]
    idx = pipe.index
    qbin, _totals = chip_smoke.hold_k5(idx, q_counts)
    if hasattr(chip_smoke, "index_k1_args"):
        return chip_smoke.index_k1_args(idx, qbin, st, q_cc, k_ana, k_len,
                                        start_blk)
    return (idx.bins, idx.cc, idx.validrows, qbin, q_cc, k_ana, k_len,
            start_blk, st["nb_band"])


def direct_args(chip_smoke, seed: int, T: int) -> tuple:
    """K1's wrapper arguments on seeded planes 30 x T wide: 4,096 queries
    over a band of 89 blocks of 131,072 rows."""
    if hasattr(chip_smoke, "k1_args"):
        return chip_smoke.k1_args(seed, 131_072, 4096, 89, T=T)
    return chip_smoke.k1_direct_inputs(seed, 131_072, 4096, 89, T=T) + (89,)


def k1_records(chip_smoke, pipe, queries, params, peaks) -> dict:
    """K1 at the main batch and at the direct widths of K1_T."""
    idx = pipe.index
    out = {"stage_a_main": k1_record(
        chip_smoke, batch_args(chip_smoke, pipe, queries[:chip_smoke.BATCH],
                               params), idx.at, peaks)}
    for T in K1_T:
        args = direct_args(chip_smoke, chip_smoke.SEED + 50 + T, T)
        out[f"stage_a_AT{args[0].shape[1]}"] = k1_record(chip_smoke, args,
                                                         30 * T, peaks)
        del args
    return out


def planes_records(chip_smoke, words, params, peaks) -> dict:
    """K1 on chip_smoke's phase 13 model: its first batch of 4,096 (the
    queries near the two long entries among them) and its 4,096 shortest
    other queries."""
    from analiticcl_tpu_torch import VariantModel
    from analiticcl_tpu_torch.testing import ALPHABET, corrupt_queries, populate

    cs = chip_smoke
    longs = cs.planes_words()
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"),
                     list(words) + longs)
    pipe = model._pipeline()
    near = [q for q in corrupt_queries(longs, cs.SEED + 38,
                                       2 * cs.N_PLANES_NEAR)
            if len(q) <= 1000][:cs.N_PLANES_NEAR - 2] + longs
    queries = near + corrupt_queries(words, cs.SEED + 39,
                                     cs.N_PLANES_QUERIES - len(near))
    at = pipe.index.at
    out = {
        "stage_a_planes_first": k1_record(cs, batch_args(
            cs, pipe, queries[:cs.PLANES_BATCH], params), at, peaks),
        "stage_a_planes_short": k1_record(cs, batch_args(
            cs, pipe, sorted(queries[len(near):], key=len)[:cs.PLANES_BATCH],
            params), at, peaks),
    }
    del model, pipe
    return out


def worker(root: str) -> int:
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_lexicon,
    )
    from analiticcl_tpu_torch.utils.roofline import card_peaks

    if not chip_smoke.__file__.startswith(root):
        raise SystemExit(f"worker imported {chip_smoke.__file__}, not {root}")
    _build.load_all(chip_smoke.KERNEL_SOURCES)
    card = chip_smoke.gpu_line()
    words = synthetic_lexicon(chip_smoke.SEED, chip_smoke.N_LEXICON)
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    queries = corrupt_queries(words, chip_smoke.SEED + 1,
                              chip_smoke.N_QUERIES)
    peaks = card_peaks(0)
    out = k1_records(chip_smoke, model._pipeline(), queries, params, peaks)
    out.update(planes_records(chip_smoke, words, params, peaks))
    _pairs, n_valid, _slots, _P, main = chip_smoke.k2_main_pairs(
        model._pipeline(), queries, params)
    records = chip_smoke.glue_records(main, n_valid, card, peaks)
    torch.cuda.synchronize()
    out.update({r["name"]: {k: r.get(k) for k in KEYS} for r in records})
    slot = next(r for r in records if r["name"] == "dl_lcs_slots")
    for W, w in slot["by_window"].items():
        out[f"dl_lcs_slots_W{W}"] = {k: w.get(k) for k in KEYS}
    print("RESULT " + json.dumps({"root": root, "card": card, **out}),
          flush=True)
    return 0


def main(argv) -> int:
    if len(argv) >= 2 and argv[1] == "--worker":
        return worker(argv[2])
    if len(argv) != 2:
        raise SystemExit(__doc__)
    other = str(Path(argv[1]).resolve())
    this = str(HERE)
    turns = []
    for root in (other, this, this, other):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root], cwd=root,
            capture_output=True, text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode or not lines:
            raise SystemExit(f"worker for {root} failed ({proc.returncode}):"
                             f"\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        rec = json.loads(lines[-1][len("RESULT "):])
        rec["side"] = "other" if root == other else "this"
        print(json.dumps(rec), flush=True)
        turns.append(rec)
    print(turns[0]["card"])
    names = dict.fromkeys(n for t in turns for n in t)
    for name in names:
        if name in ("root", "card", "side"):
            continue
        got = [t.get(name, {}) for t in turns]
        seq = ", ".join(f"{t['side']} {g.get('device_ms')}"
                        for t, g in zip(turns, got))
        print(f"{name}: device ms in turns {seq}; events ms "
              + ", ".join(str(g.get("ms")) for g in got))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
