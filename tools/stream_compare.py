#!/usr/bin/env python3
"""The port's query stream in two checkouts, timed in turns on one CUDA
card.

    python3 tools/stream_compare.py OTHER_ROOT [--passes N]

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked by ``git archive`` into a directory that ``.gitignore``
lists. The turns run other, this, this, other, each in a fresh process
that imports ``analiticcl_tpu_torch`` from its checkout (and builds that
checkout's kernels). A turn builds chip_smoke's main model (the seeded
120,000-entry lexicon) on ``cuda`` and runs ``find_variants_stream`` over
chip_smoke's 16,384 corrupted queries in batches of 4,096: one warm-up pass,
then N timed passes (q/s each, the StageTimer totals of the last) and one
pass under ``torch.profiler`` (device busy time, idle share and device ops,
``chip_smoke.profile_pass`` of this checkout); then the same on a 1x4 mesh
of ``cuda:0`` repeated. Every pass of every turn must give the same results
(a digest of the result tuples). Prints the card's name and power limit,
one JSON line per turn, and the median q/s per checkout. Imports no JAX.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
BATCH = 4096


def _smoke():
    """This checkout's chip_smoke, whichever checkout the worker imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(model, results) -> str:
    h = hashlib.sha256()
    for res in results:
        h.update(repr([(model.decoder[r.vocab_id].text, r.dist_score,
                        r.freq_score, r.via) for r in res]).encode())
    return h.hexdigest()[:16]


def _passes(model, queries, params, n: int, smoke) -> dict:
    import torch

    list(model.find_variants_stream(queries, params, BATCH))  # warm-up
    qps, digests = [], set()
    for _ in range(n):
        stats = model._device.stats
        stats.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(model.find_variants_stream(queries, params, BATCH))
        torch.cuda.synchronize()
        qps.append(len(queries) / (time.perf_counter() - t0))
        digests.add(_digest(model, got))
    if len(digests) != 1:
        raise SystemExit(f"passes gave different results: {digests}")
    profile = smoke.profile_pass(
        lambda: list(model.find_variants_stream(queries, params, BATCH)))
    return {"qps": qps, "digest": digests.pop(),
            "stages_ms": {k: v * 1e3 for k, v in sorted(
                model._device.stats.totals.items())},
            "profile": profile}


def worker(root: str, n: int) -> int:
    sys.path.insert(0, root)
    smoke = _smoke()
    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.parallel.mesh import make_mesh
    from analiticcl_tpu_torch.testing import (
        ALPHABET, corrupt_queries, populate, synthetic_lexicon,
    )

    words = synthetic_lexicon(smoke.SEED, smoke.N_LEXICON)
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"), words)
    model._pipeline()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10,
        score_threshold=0.25,
    )
    queries = corrupt_queries(words, smoke.SEED + 1, smoke.N_QUERIES)
    out = {"root": root, "single": _passes(model, queries, params, n, smoke)}
    model.use_mesh(make_mesh(["cuda:0"] * 4, dp=1))
    out["mesh_1x4"] = _passes(model, queries, params, n, smoke)
    print(json.dumps(out), flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        return worker(argv[1], int(argv[2]))
    other = str(Path(argv[0]).resolve())
    n = int(argv[argv.index("--passes") + 1]) if "--passes" in argv else 3
    print(_smoke().gpu_line(), flush=True)
    turns = {}
    digests = set()
    for root in (other, str(HERE), str(HERE), other):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", root, str(n)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"the turn of {root} failed")
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rec = json.loads(line)
        turns.setdefault(root, []).append(rec)
        digests.update(rec[k]["digest"] for k in ("single", "mesh_1x4"))
    if len(digests) != 1:
        raise SystemExit(f"the checkouts gave different results: {digests}")
    for root, recs in turns.items():
        for k in ("single", "mesh_1x4"):
            qps = [q for r in recs for q in r[k]["qps"]]
            print(f"{root} {k}: median {statistics.median(qps):.1f} q/s over "
                  f"{len(qps)} passes (min {min(qps):.1f}, max "
                  f"{max(qps):.1f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
