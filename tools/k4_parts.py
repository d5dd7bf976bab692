#!/usr/bin/env python3
"""Which part of the survivor compaction (K4) and of the query planes (K5)
holds their time, on one CUDA card.

    python3 tools/k4_parts.py

Builds ``analiticcl_tpu_torch/csrc/compact.cu`` as it is and in variants
made by replacing source text: without the survivors' loads and stores
(the second round trip), without the counts' loads and sums, without
either (the keep flags' loads, the scan, the list, the fill and the small
outputs only), with the kernel's body cut to a return (an empty launch of
the same grid: the floor any launch of it pays), with 8 warps a block
(half the blocks) and with 2 (twice the blocks), and without the fill's
stores. Likewise ``planes.cu`` as it is, with an empty body, without the
counts' loads, with blocks of 128 threads, without the totals' zeroing
and without the pieces' arithmetic. Each is launched back to
back through its C entry point at the main path's shape (K4: B 4,096,
P 393,216 slots of which the first 301,181 are valid and 31,214 kept,
P2 49,152, K2's blocks of 128; K5: B 4,096, A 30, T 7, planes 224 wide;
seeded inputs) and timed with CUDA events (20 back-to-back launches,
median of 10) and by the profiler (device time per launch). K4 runs at
uint8 and at int32 metrics. Beside them the library call's time
(``torch.nonzero_static`` of the keep flags and the gathers of the
survivors' query, row and metrics) by events and by the device time of
all its kernels. The variants compute wrong outputs; only their times are
read. Prints ptxas's registers per variant, the card's name and power
limit, one line per variant and one JSON line. Needs ``nvcc``; imports no
JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

B, P, VALID, KEPT, P2, BLOCK = 4096, 393_216, 301_181, 31_214, 49_152, 128
A, T, AT_PAD = 30, 7, 224


def _cut(src: str, start: str, end: str, by: str = "") -> str:
    i, j = src.index(start), src.index(end)
    assert i < j
    return src[:i] + by + src[j:]


def compact_variants(src: str) -> dict:
    body = "  __shared__ short s_list[CHUNK];"
    counts0 = "  const long long first_blk = c0 / blk_slots;"
    counts1 = "  // ---- in the SM:"
    pay0 = "  // ---- the second round trip:"
    pay1 = "  // this block's share of the fill"
    assert body in src
    no_counts = _cut(src, counts0, counts1,
                     "  long long pre = 0, all = 0;\n\n")
    warps = "constexpr int WARPS = 4;"
    assert warps in src
    return {
        "full": src,
        "no_payload": _cut(src, pay0, pay1),
        "no_counts": no_counts,
        "flags_only": _cut(no_counts, pay0, pay1),
        "empty": src.replace(body, "  return;\n" + body),
        # 8 (2) warps a block: chunks of 4,096 (1,024) slots, half (twice)
        # the blocks, each of which reads every count
        "warps8": src.replace(warps, "constexpr int WARPS = 8;"),
        "warps2": src.replace(warps, "constexpr int WARPS = 2;"),
        # without the fill's stores
        "no_fill": src.replace("    write_fill(r, B, P2, o);\n", ""),
    }


def planes_variants(src: str) -> dict:
    body = "  extern __shared__ int s_cnt[];"
    load = "s_cnt[i] = src[i];"
    threads = "constexpr int THREADS = 256;"
    assert body in src and load in src and threads in src
    return {
        "full": src,
        "empty": src.replace(body, "  return;\n" + body),
        # the counts not loaded (the staging's round trip cut out)
        "no_loads": src.replace(load, "s_cnt[i] = i;"),
        # blocks of 128 threads: 9 rows a group, twice the blocks
        "threads128": src.replace(threads, "constexpr int THREADS = 128;"),
        # without the totals' zeroing, and with zeros stored in place of
        # the pieces' arithmetic
        "no_totals": src.replace("      totals[i] = 0;\n", ""),
        "no_compute": src.replace("plane_piece(s_cnt + r * A, p, A, T, w);",
                                  "w[0] = w[1] = w[2] = w[3] = s_cnt[r];"),
    }


def build(out: Path, name: str, sources: dict) -> dict:
    from analiticcl_tpu_torch.ops import _build

    procs = {}
    for var, text in sources.items():
        (out / f"{name}_{var}.cu").write_text(text)
        procs[var] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{name}_{var}.so"), str(out / f"{name}_{var}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for var, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {var}:\n{log}")
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{name} {var}: ptxas {info}", flush=True)
        entry = f"analiticcl_{name}"
        fn = getattr(ctypes.CDLL(str(out / f"{name}_{var}.so")), entry)
        fn.argtypes = _build.SIGNATURES[name][entry]
        fn.restype = ctypes.c_int
        fns[var] = fn
    return fns


def k4_inputs(met_dtype):
    import torch

    g = torch.Generator(device="cuda").manual_seed(16)
    keep = torch.zeros(P, dtype=torch.bool, device="cuda")
    keep[:VALID] = torch.rand(VALID, generator=g, device="cuda") < KEPT / VALID
    counts = torch.nn.functional.pad(keep, (0, -P % BLOCK)).view(
        -1, BLOCK).sum(1, dtype=torch.int32)
    q = torch.sort(torch.randint(0, B, (P,), generator=g, device="cuda",
                                 dtype=torch.int32)).values
    pc = torch.randint(0, 120_832, (P,), generator=g, device="cuda",
                       dtype=torch.int32)
    met = torch.randint(0, 200, (5, P), generator=g, device="cuda",
                        dtype=torch.int32).to(met_dtype)
    max_freq = torch.randint(1, 1 << 40, (B,), generator=g, device="cuda",
                             dtype=torch.int64)
    total = torch.tensor(VALID, dtype=torch.int64, device="cuda")
    return keep, counts, q, pc, met, max_freq, total


def main() -> int:
    import torch

    import chip_smoke
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.ops.pipeline import (
        _output_views, compact_survivors_plain,
    )
    from analiticcl_tpu_torch.utils.roofline import (
        card_peaks, k4_bound_ms, k5_bound_ms,
    )

    if not torch.cuda.is_available():
        raise SystemExit("k4_parts: no CUDA card")
    card = chip_smoke.gpu_line()
    print(card, flush=True)
    peaks = card_peaks(0)
    out = ROOT / "build" / "k4_parts"
    out.mkdir(parents=True, exist_ok=True)
    k4 = build(out, "compact",
               compact_variants((_build.CSRC / "compact.cu").read_text()))
    k5 = build(out, "planes",
               planes_variants((_build.CSRC / "planes.cu").read_text()))
    stream = torch.cuda.current_stream().cuda_stream
    record = {"card": card}

    def times(call, kernel):
        return {"events_ms": chip_smoke.time_ms(call, 10, inner=20),
                "device_ms": chip_smoke.device_ms(call, kernel, 20)}

    for met_dtype in (torch.uint8, torch.int32):
        keep, counts, q, pc, met, max_freq, total = k4_inputs(met_dtype)
        mb = met.element_size()
        flat = torch.empty(8 * (B + 2) + (8 + 5 * mb) * P2,
                           dtype=torch.uint8, device="cuda")
        n_keep = int(keep.sum())
        bound, by = k4_bound_ms(P, P2, B, n_keep, BLOCK, peaks, mb)
        rows = {}
        for var, fn in k4.items():
            def call(fn=fn):
                _build.check(fn(counts.data_ptr(), counts.numel(), BLOCK,
                                keep.data_ptr(), q.data_ptr(), pc.data_ptr(),
                                met.data_ptr(), mb, max_freq.data_ptr(),
                                total.data_ptr(), flat.data_ptr(), B, P, P2,
                                stream), "compact launch")
            if var == "full":
                call()
                got = _output_views(flat, B, P2, met_dtype)
                want = compact_survivors_plain(keep, counts, BLOCK, q, pc,
                                               met, max_freq, total, P2)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise SystemExit("k4_parts: K4 differs from plain")
            rows[var] = times(call, "compact_kernel")
            print(f"K4 {var} ({met_dtype}): {rows[var]['events_ms']:.4f} ms "
                  f"(CUDA events, 20 back-to-back launches), device "
                  f"{chip_smoke.ms4(rows[var]['device_ms'])} | {card}",
                  flush=True)

        def library():
            at = torch.nonzero_static(keep, size=P2)[:, 0]
            return q[at], pc[at], met[:, at]

        rows["library"] = {
            "events_ms": chip_smoke.time_ms(library, 10, inner=20),
            "device_ms": chip_smoke.device_all_ms(library, 20)}
        rows["bound_ms"], rows["bound_by"] = bound, by
        print(f"K4 library (nonzero_static + gathers, {met_dtype}): "
              f"{rows['library']['events_ms']:.4f} ms (CUDA events), device "
              f"time of its kernels "
              f"{chip_smoke.ms4(rows['library']['device_ms'])}; bound "
              f"{bound:.4f} ms ({by}), {n_keep} kept | {card}", flush=True)
        record[f"k4_{mb}"] = rows

    g = torch.Generator(device="cuda").manual_seed(17)
    q_counts = torch.randint(0, 10, (B, A), generator=g, device="cuda",
                             dtype=torch.int32)
    planes = torch.empty((B, AT_PAD), dtype=torch.int8, device="cuda")
    totals = torch.empty((2, B), dtype=torch.int32, device="cuda")
    rows = {}
    for var, fn in k5.items():
        def call(fn=fn):
            _build.check(fn(q_counts.data_ptr(), planes.data_ptr(),
                            totals.data_ptr(), B, A, T, AT_PAD, stream),
                         "planes launch")
        rows[var] = times(call, "planes_kernel")
        print(f"K5 {var}: {rows[var]['events_ms']:.4f} ms (CUDA events, 20 "
              f"back-to-back launches), device "
              f"{chip_smoke.ms4(rows[var]['device_ms'])} | {card}", flush=True)
    rows["bound_ms"], rows["bound_by"] = k5_bound_ms(B, A, A * T, peaks)
    record["k5"] = rows
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
