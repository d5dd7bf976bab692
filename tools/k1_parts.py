#!/usr/bin/env python3
"""Which part of the stage-A kernel (K1) holds its time, on one CUDA card.

    python3 tools/k1_parts.py

Builds ``analiticcl_tpu_torch/csrc/stage_a.cu`` as it is and in three
variants of its main instance made by replacing source text: without the
epilogue (the accumulators are folded into one word per lane and
stored), without the int8 products (the accumulators stay zero), and
without either (the chunk loads, the ring, the bit tile and the stores
only). Each is launched 20 times back to back through its C entry point
at the main path's shape (B = 4,096 queries, a band of 89 x 1,024 rows of
a 120,832-row index, AT 224; seeded planes from
``chip_smoke.k1_direct_inputs``) and timed with CUDA events. Then the
streamed instance at planes 1,664 wide (T 55, the same band), as it is
and with the queries' plane pieces loaded for the first 64-row chunk
only (the later chunks reuse stale pieces: what re-reading them from L2
costs), on two sets of planes: every block at the full width, and
phase 13's shape (every block's counts capped at 7, extent 224, but the
last, at 1,664, which every tile's band reads last). On the second also
the streamed instance without the main body for its narrow blocks (each
walks its extent in k-chunks), with its band blocks in grid
order (not the last, widest, first), and at the full width in every
block (the design before the block extents); and on both, the streamed
instance with 64-byte k-chunks in a ring of four stages, and with
its 128-byte k-chunks in a ring of three (one block an SM). The variants compute wrong bits (or, the last
five, the same bits otherwise); only their times are read. Last, on the
main path's planes (224 wide, every block within 224), the main
instance and the streamed one (whose blocks then all run the main body)
in turns: main, stream, stream, main, twice.
Prints ptxas's registers and spills per variant, one line per variant, and
the card's name and power limit. Needs ``nvcc``; imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

B, NI, NB_BAND, AT, BT = 4096, 120_832, 89, 224, 1024
STREAM_T = 55  # the streamed instance's planes: 30 x 55, padded to 1,664


def variants(src: str) -> dict:
    """The source of each variant, by name (``stream*``: the streamed
    instance's)."""
    kloop = ("      for (int ks = 0; ks < KS; ++ks) "
             "kstep(acc, a_res[ks], b_addr, rstride, ks);\n")
    e0 = src.index("    const int* cc_s")
    e1 = src.index("    ex_w[w] = pick(ew, t);\n") + len("    ex_w[w] = pick(ew, t);\n")
    assert kloop in src and e0 < e1
    folded = ("    unsigned x = 0;\n"
              "    for (int i = 0; i < NACC; ++i) x ^= acc[i];\n"
              "    const int w = (qg * 32 + 8 * t + g) * WSTRIDE + chunk * 2 + rg;\n"
              "    hit_w[w] = x;\n    ex_w[w] = x;\n")
    no_epi = src[:e0] + folded + src[e1:]
    qload = ("      if (stream_piece(i, qt, qs, q0, r0, at_pad, kc, w16, &dst, "
             "&src, &from_q))\n        cp_async16(")
    assert src.count(qload) == 1
    main_body = "  if (kw <= MAIN_WIDTH) {  // block-uniform\n"
    order = "  const int band_blk = nb_band - 1 - blockIdx.y;\n"
    kw = "\n  const int kw = block_width(extents, blk, at_pad);\n"
    kc, ring = "constexpr int KC = 128;\n", "constexpr int SSTAGE = 2;\n"
    assert all(src.count(x) == 1 for x in (main_body, order, kw, kc, ring))
    return {
        "full": src,
        "no_epilogue": no_epi,
        "no_products": src.replace(kloop, "      acc[0] = b_addr;\n"),
        "loads_and_stores_only": no_epi.replace(kloop, "      acc[0] = b_addr;\n"),
        "stream": src,
        "stream_no_query_reload": src.replace(qload, qload.replace(
            "&from_q))", "&from_q) &&\n          (!from_q || chunk == 0))")),
        "stream_no_main_body": src.replace(main_body,
                                           "  if (false) {\n"),
        "stream_grid_order": src.replace(
            order, "  const int band_blk = blockIdx.y;\n"),
        "stream_full_width": src.replace(kw, "\n  const int kw = at_pad;\n"),
        "stream_kc64_s4": src.replace(kc, "constexpr int KC = 64;\n")
                             .replace(ring, "constexpr int SSTAGE = 4;\n"),
        "stream_kc128_s3": src.replace(ring, "constexpr int SSTAGE = 3;\n"),
    }


# the variants timed on phase 13's shape too, and those only there
ON_MIXED = ("stream", "stream_no_query_reload", "stream_kc64_s4",
            "stream_kc128_s3")
MIXED_ONLY = ("stream_no_main_body", "stream_grid_order", "stream_full_width")


def main() -> int:
    import torch

    import chip_smoke
    from analiticcl_tpu_torch.convert import block_extents
    from analiticcl_tpu_torch.ops import _build
    from analiticcl_tpu_torch.ops.stage_a import INSTANCES

    if not torch.cuda.is_available():
        raise SystemExit("k1_parts: no CUDA card")
    print(chip_smoke.gpu_line(), flush=True)
    out = ROOT / "build" / "k1_parts"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "stage_a.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / f"{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: ptxas {info}", flush=True)

    Nb = NB_BAND * 1024
    outs = [torch.empty((B, Nb // 8), dtype=torch.uint8, device="cuda"),
            torch.empty((B, Nb // 8), dtype=torch.uint8, device="cuda"),
            torch.empty((Nb // 128, B), dtype=torch.int32, device="cuda"),
            torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.zeros(B, dtype=torch.int32, device="cuda")]
    stream = torch.cuda.current_stream().cuda_stream
    M = NI // 1024
    caps = [7] * M
    caps[-1] = STREAM_T
    planes = {"main": chip_smoke.k1_direct_inputs(1, NI, B, NB_BAND, T=7),
              "full": chip_smoke.k1_direct_inputs(1, NI, B, NB_BAND,
                                                  T=STREAM_T),
              "mixed": chip_smoke.k1_direct_inputs(1, NI, B, NB_BAND,
                                                   T=STREAM_T, caps=caps)}
    planes["mixed"][7].fill_(M - NB_BAND)  # every band ends at the wide block
    for name in procs:
        fn = ctypes.CDLL(str(out / f"{name}.so")).analiticcl_stage_a
        fn.argtypes = _build.SIGNATURES["stage_a"]["analiticcl_stage_a"]
        fn.restype = ctypes.c_int
        streamed = name.startswith("stream")
        kinds = (["mixed"] if name in MIXED_ONLY
                 else ["full", "mixed"] if name in ON_MIXED else ["main"])
        for kind in kinds:
            args = planes[kind]
            at = args[0].shape[1]
            ext = block_extents(args[0])
            ptrs = [x.data_ptr() for x in (*args[:8], ext, *outs)]
            instance = INSTANCES["stream" if streamed else "main"]
            width = int(ext.max())

            def call(fn=fn, ptrs=ptrs, at=at, width=width,
                     instance=instance):
                _build.check(fn(*ptrs, B, at, width, NB_BAND, BT, 128,
                                instance, stream), "stage_a variant")

            ms = chip_smoke.time_ms(call, 10, inner=20)
            exts = sorted(set(ext.tolist()))
            print(f"{name} on {kind} planes: {ms:.4f} ms per launch at "
                  f"planes {at} wide, block extents {exts} (CUDA events, "
                  f"median of 10 runs of 20 back-to-back launches)",
                  flush=True)
    # whether the streamed instance could serve the main path alone
    fn = ctypes.CDLL(str(out / "full.so")).analiticcl_stage_a
    fn.argtypes = _build.SIGNATURES["stage_a"]["analiticcl_stage_a"]
    fn.restype = ctypes.c_int
    args = planes["main"]
    ext = block_extents(args[0])
    ptrs = [x.data_ptr() for x in (*args[:8], ext, *outs)]
    for turn in ("main", "stream", "stream", "main") * 2:
        def call(instance=INSTANCES[turn]):
            _build.check(fn(*ptrs, B, AT, AT, NB_BAND, BT, 128, instance,
                            stream), "stage_a turn")

        ms = chip_smoke.time_ms(call, 10, inner=20)
        print(f"turn: {turn} instance on main planes: {ms:.4f} ms per "
              f"launch (CUDA events, median of 10 runs of 20 back-to-back "
              f"launches)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
