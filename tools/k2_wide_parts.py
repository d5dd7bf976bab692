#!/usr/bin/env python3
"""Which part of K2's wide path holds its time, on one CUDA card.

    python3 tools/k2_wide_parts.py [OTHER_DL_LCS_CU]

Builds ``analiticcl_tpu_torch/csrc/dl_lcs.cu`` ("this") and, if given,
OTHER (for example the parent commit's copy, unpacked by ``git archive``
into a directory that ``.gitignore`` lists) as they are and in variants
made by replacing source text in the wide path: without its LCS (the band
DP alone: ``WIDE_LCS`` off), without its band DP (the LCS alone:
``WIDE_BAND`` off), and with each wide pair's work cut (``scan``: what
the launch pays to find and hand out its pairs). The variants compute
wrong outputs; only their times are read. Each source's design is
recognised by its text, so the wide path's first design (a per-block
scan of the slots, the LCS along diagonals) and the current one (the
byte launch's work list, the LCS row by row on packed runs) both take
their own cuts.

Then, in turns other, this, this, other (or this, this without OTHER),
each turn a fresh process, it times every variant on three inputs:

- phase 12's first batch (``chip_smoke.wide_batch``: the main lexicon
  plus ``chip_smoke.wide_words``, L 300, its first 1,024 queries at the
  batch's budget) through the scored slot entry, the main path's;
- the 4,096 shortest of phase 12's main-lexicon queries
  (``chip_smoke.short_queries``) through the same entry: a batch without
  a pair over 64, where the wide launch has nothing to do;
- 1,048,576 pairs at L 100 and at L 300, W=3
  (``chip_smoke.wide_pair_strings``, three in four over 64) through the
  pair-string entry;

by CUDA events (10 back-to-back calls of the entry, both launches) and
by the profiler's device time of the wide kernel by its name, and of the
byte launch on the batch. It also gives the wide pairs of each input.
Prints ptxas's registers per variant, the card's name and power limit,
one line per turn and variant, and one JSON line. Needs ``nvcc``; imports
no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "k2_wide_parts"
PER_1M = ((100, 3), (300, 3))

# The cuts of each design, as (old, new) source replacements. "first":
# the wide path's first design (a block's warps take its list of each
# turn's wide slots; the LCS along each lane's diagonals); "list": the
# byte launch's work list, the band DP and the LCS rows as functions.
DESIGNS = {
    "first": {
        "marker": "int best = lcs_diagonals(ap, al, bp, bl, lane, 32);",
        "band": [("int best = lcs_diagonals(ap, al, bp, bl, lane, 32);",
                  "int best = 0;")],
        "lcs": [("  int mine = INT_MAX;  // cell (al, bl), in the lane that "
                 "computes it\n  for (int i = 1; i <= al; ++i) {",
                 "  int mine = INT_MAX;  // cell (al, bl), in the lane that "
                 "computes it\n  for (int i = 1; i <= 0; ++i) {")],
        "scan": [("    for (int k = warp; k < nlist; k += WIDE_WARPS) "
                  "run(list[k], st[warp]);\n", "")],
    },
    "list": {
        "marker": "constexpr bool WIDE_LCS = true;",
        "band": [("constexpr bool WIDE_LCS = true;",
                  "constexpr bool WIDE_LCS = false;")],
        "lcs": [("constexpr bool WIDE_BAND = true;",
                 "constexpr bool WIDE_BAND = false;")],
        "scan": [("run(wl.items[e], ring);  // cut: scan", "(void)ring;"),
                 ("run2(wl.items[e], wl.items[e + 1], ring);  // cut: scan",
                  "(void)ring;")],
    },
}


def variants(src: str) -> dict:
    for design in ("list", "first"):  # the first design's marker is in both
        cuts = DESIGNS[design]
        if cuts["marker"] in src:
            out = {"full": src}
            for var in ("band", "lcs", "scan"):
                text = src
                for old, new in cuts[var]:
                    if text.count(old) != 1:
                        raise SystemExit(f"k2_wide_parts: {design} cut {var}"
                                         f" does not match the source once")
                    text = text.replace(old, new)
                out[var] = text
            return out
    raise SystemExit("k2_wide_parts: the source is of no known design")


def build_all(sources: dict) -> dict:
    """Every variant of every source, one nvcc each, all at once; keyed by
    a hash of the text, so a later turn loads them. Returns {tag: {var:
    path}} and prints ptxas's registers of the wide kernels."""
    from analiticcl_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs, paths = {}, {}
    for tag, src in sources.items():
        paths[tag] = {}
        for var, text in variants(src.read_text()).items():
            h = hashlib.sha256(text.encode()).hexdigest()[:12]
            cu, so = OUT / f"{tag}_{var}_{h}.cu", OUT / f"{tag}_{var}_{h}.so"
            paths[tag][var] = so
            if so.exists():
                continue
            cu.write_text(text)
            procs[(tag, var)] = subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    for (tag, var), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {tag} {var}:\n{log}")
        print(f"{tag} {var}: ptxas (wide kernels) {wide_ptxas(log)}",
              flush=True)
    return paths


def wide_ptxas(report: str) -> dict:
    """ptxas's registers and spills of each wide kernel instance, keyed by
    its mangled name from ``dl_lcs`` on."""
    out, key = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\S*?(dl_lcs\w*)'", line)
        if m:
            key = m.group(1) if "wide" in m.group(1) else None
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            out.setdefault(key, {})["spill_stores"] = int(m[1])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(key, {})["registers"] = int(m[1])
    return out


class _Unlisted:
    """A library whose entries take no work list after the stream (the
    first design's): calls through the wrappers drop those two arguments."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        return lambda *args: fn(*args[:-2])


def load(path: Path):
    """K2's library at ``path`` with its entries' argument types, to stand
    in ``_build._libs["dl_lcs"]`` for the wrappers; a library of the first
    design (no ``analiticcl_dl_lcs_work_list``) drops the work list."""
    from analiticcl_tpu_torch.ops import _build

    lib = ctypes.CDLL(str(path))
    listed = hasattr(lib, "analiticcl_dl_lcs_work_list")
    drop = 0 if listed else 2
    for fn, argtypes in _build.SIGNATURES["dl_lcs"].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes[:len(argtypes) - drop]
        f.restype = ctypes.c_int
    return _Unlisted(lib) if drop else lib


def turn(tag: str, paths: dict) -> dict:
    import torch

    import chip_smoke
    from analiticcl_tpu_torch import (
        DistanceThreshold, SearchParameters, VariantModel,
    )
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.ops import dl as tdl
    from analiticcl_tpu_torch.testing import (
        ALPHABET, populate, synthetic_lexicon,
    )

    card = chip_smoke.gpu_line()
    libs = {var: load(Path(p)) for var, p in paths.items()}
    _build._libs["dl_lcs"] = libs["full"]
    words = synthetic_lexicon(chip_smoke.SEED, chip_smoke.N_LEXICON)
    longs = chip_smoke.wide_words()
    model = populate(VariantModel(alphabet=ALPHABET, device="cuda"),
                     list(words) + longs)
    pipe = model._pipeline()
    params = SearchParameters(
        max_anagram_distance=DistanceThreshold.absolute(3),
        max_edit_distance=DistanceThreshold.absolute(2),
        max_matches=10, score_threshold=0.25)
    queries, _near = chip_smoke.wide_queries(words, longs)
    inputs = {}
    for name, lookups in (
            ("batch", queries[:chip_smoke.WIDE_BATCH]),
            ("short", chip_smoke.short_queries(words))):
        s_args, score, pr, P, n_valid = chip_smoke.wide_batch(
            pipe, lookups, params)
        wide = torch.maximum(pr.ql, pr.cl) > tdl.NARROW_LEN
        if (name == "short") == bool(wide.any()):
            raise SystemExit(f"k2_wide_parts: the {name} batch has "
                             f"{int(wide.sum())} pairs over 64")
        inputs[name] = {"P": P, "valid": n_valid, "wide": int(wide.sum()),
                        "call": (lambda a=s_args, s=score:
                                 tdl.dl_lcs_slots(*a, score=s)),
                        "kernel": "dl_lcs_slots_wide_kernel"}
        if name == "batch":  # the full variant against plain on its pairs
            sel = wide.nonzero()[:, 0]
            a, al, b, bl = (x[sel].contiguous()
                            for x in (pr.a, pr.ql, pr.b, pr.cl))
            W = s_args[-1]
            ld, lcs = tdl.dl_lcs(a, al, b, bl, pipe.L, W)
            ld_p, lcs_p, _, _ = tdl.dl_metrics_windowed_plain(
                a, al, b, bl, pipe.L, W)
            if not (torch.equal(ld.clamp(max=W + 1), ld_p.clamp(max=W + 1))
                    and torch.equal(lcs, lcs_p)):
                raise SystemExit(f"k2_wide_parts: {tag} differs from plain "
                                 f"on the batch's wide pairs")
    del model, pipe
    for L, W in PER_1M:
        a, al, b, bl = chip_smoke.wide_pair_strings(
            chip_smoke.SEED + 7 * L + W, L, chip_smoke.WIDE_PAIRS)
        wide = torch.maximum(al, bl) > tdl.NARROW_LEN
        inputs[f"L{L}_W{W}"] = {
            "P": chip_smoke.WIDE_PAIRS, "wide": int(wide.sum()),
            "call": (lambda a=a, al=al, b=b, bl=bl, L=L, W=W:
                     tdl.dl_lcs(a, al, b, bl, L, W)),
            "kernel": "dl_lcs_wide_kernel"}
    rows = {}
    for var, lib in libs.items():
        _build._libs["dl_lcs"] = lib
        rows[var] = {}
        for name, inp in inputs.items():
            reps = 10 if name in ("batch", "short") else 3
            r = {"events_ms": chip_smoke.time_ms(inp["call"], reps,
                                                 inner=10 if reps == 10
                                                 else 1),
                 "wide_device_ms": chip_smoke.device_ms(
                     inp["call"], inp["kernel"], reps)}
            if name == "batch":
                r["byte_device_ms"] = chip_smoke.device_ms(
                    inp["call"], "dl_lcs_slots_kernel", reps)
            rows[var][name] = r
            print(f"[{tag}] {var} {name}: entry {r['events_ms']:.4f} ms "
                  f"(CUDA events), wide kernel "
                  f"{chip_smoke.ms4(r['wide_device_ms'])} device | {card}",
                  flush=True)
    torch.cuda.synchronize()
    return {"tag": tag, "card": card, "rows": rows,
            "inputs": {k: {f: v for f, v in inp.items()
                           if f not in ("call", "kernel")}
                       for k, inp in inputs.items()}}


def main(argv) -> int:
    import torch

    if len(argv) == 4 and argv[1] == "--turn":  # one turn, in its process
        print("TURN " + json.dumps(turn(argv[2], json.loads(argv[3]))),
              flush=True)
        return 0
    if len(argv) > 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("k2_wide_parts: no CUDA card")
    from analiticcl_tpu_torch.ops import _build

    import chip_smoke

    card = chip_smoke.gpu_line()
    print(card, flush=True)
    sources = {"this": _build.CSRC / "dl_lcs.cu"}
    order = ["this", "this"]
    if len(argv) == 2:
        sources["other"] = Path(argv[1]).resolve()
        order = ["other", "this", "this", "other"]
    paths = build_all(sources)
    record = {"card": card, "turns": []}
    for tag in order:
        arg = json.dumps({v: str(p) for v, p in paths[tag].items()})
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", tag, arg],
            capture_output=True, text=True)
        sys.stdout.write("".join(ln + "\n" for ln in proc.stdout.splitlines()
                                 if not ln.startswith("TURN ")))
        if proc.returncode:
            sys.stderr.write(proc.stderr[-4000:])
            raise SystemExit(f"k2_wide_parts: the {tag} turn failed")
        rec = next(json.loads(ln[5:]) for ln in proc.stdout.splitlines()
                   if ln.startswith("TURN "))
        record["turns"].append(rec)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
