"""ctypes bindings for the native host kernels (native/ananorm.cpp).

The port's copy of ``analiticcl_tpu/utils/native.py``.

Loads ``native/libananorm.so`` if present (building it on first use when a
compiler is available); every caller has a pure-Python fallback, so the
native library is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libananorm.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_FASTEMIT_SO = os.path.join(_NATIVE_DIR, "_fastemit_torch.so")
_fastemit = None
_fastemit_tried = False


def _python_build_tag() -> str:
    """Identity of the interpreter a CPython extension must match."""
    import sysconfig

    return f"{sys.implementation.name}-{sys.version_info.major}.{sys.version_info.minor}-{sysconfig.get_platform()}"


def _pyinc() -> str:
    """Include dir of the RUNNING interpreter (not whichever python3 is on
    PATH) — passed explicitly to make so venv/multi-python hosts compile
    the extension against the headers that match the loading process."""
    import sysconfig

    return sysconfig.get_paths()["include"]


def _fastemit_stale(src: str) -> bool:
    """Rebuild when the source is newer OR the recorded interpreter tag
    mismatches. The tag file (written after each successful build) guards
    against dlopen'ing an ABI-incompatible .so from another machine or
    Python minor version — mtimes alone can tie after a fresh checkout."""
    if not os.path.exists(_FASTEMIT_SO):
        return True
    if os.path.exists(src) and (
        os.path.getmtime(src) > os.path.getmtime(_FASTEMIT_SO)
    ):
        return True
    tag_path = _FASTEMIT_SO + ".build"
    try:
        with open(tag_path) as f:
            return f.read().strip() != _python_build_tag()
    except OSError:
        return True


def fastemit_build_result_lists():
    """The CPython bulk result-list constructor (native/fastemit.c), or
    None when unavailable. Built lazily alongside libananorm (same make);
    loaded by filename via ExtensionFileLoader, so the .so needs no
    ABI-tagged name. The Python tail_emit path is the fallback/oracle."""
    global _fastemit, _fastemit_tried
    with _lock:
        if _fastemit_tried:
            return _fastemit
        _fastemit_tried = True
    src = os.path.join(_NATIVE_DIR, "fastemit.c")
    if _fastemit_stale(src):
        try:
            subprocess.run(
                [
                    "make", "-C", _NATIVE_DIR, "-B", "_fastemit_torch.so",
                    f"PYINC={_pyinc()}",
                ],
                check=True, capture_output=True, timeout=120,
            )
            with open(_FASTEMIT_SO + ".build", "w") as f:
                f.write(_python_build_tag() + "\n")
        except Exception as e:
            warn_once("fastemit", f"fastemit build unavailable ({e})")
            return None
    if not os.path.exists(_FASTEMIT_SO):
        return None
    try:
        import importlib.util
        from importlib.machinery import ExtensionFileLoader

        loader = ExtensionFileLoader("_fastemit_torch", _FASTEMIT_SO)
        spec = importlib.util.spec_from_file_location(
            "_fastemit_torch", _FASTEMIT_SO, loader=loader
        )
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except Exception as e:
        warn_once("fastemit", f"fastemit extension failed to load ({e})")
        return None
    _fastemit = mod.build_result_lists
    return _fastemit

_warned: set = set()


def warn_once(key: str, message: str) -> None:
    """stderr warning emitted once per process per key.

    Native-path failures degrade to slower (but equivalent) Python fallbacks;
    they must not be silent — a broken .so would otherwise mask itself as a
    mere slowdown."""
    if key not in _warned:
        _warned.add(key)
        print(f"WARNING: {message}", file=sys.stderr)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        src = os.path.join(_NATIVE_DIR, "ananorm.cpp")
        stale = os.path.exists(_SO_PATH) and (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(_SO_PATH)
        )
        if not os.path.exists(_SO_PATH) or stale:
            if os.path.exists(src):
                try:
                    subprocess.run(
                        ["make", "-C", _NATIVE_DIR, f"PYINC={_pyinc()}"],
                        check=True,
                        capture_output=True,
                        timeout=120,
                    )
                except Exception as e:  # no compiler / build failure: fall back
                    print(
                        f"note: native ananorm build unavailable ({e}); "
                        "using pure-Python normalization",
                        file=sys.stderr,
                    )
                    return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None
        lib.ananorm_build.restype = ctypes.c_void_p
        lib.ananorm_build.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.ananorm_free.argtypes = [ctypes.c_void_p]
        lib.ananorm_normalize_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ananorm_normalize_se.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ananorm_normalize_se8.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ananorm_counts_batch8.argtypes = [
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ananorm_anavalue_batch8.argtypes = [
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ananorm_counts_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ananorm_edit_script.restype = ctypes.c_int64
        lib.ananorm_edit_script.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.ananorm_edit_script_batch.restype = ctypes.c_int64
        lib.ananorm_edit_script_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.ananorm_anavalue_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.ananorm_confusables_build.restype = ctypes.c_void_p
        lib.ananorm_confusables_build.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.ananorm_confusables_free.argtypes = [ctypes.c_void_p]
        lib.ananorm_confusable_weights.restype = ctypes.c_int64
        lib.ananorm_confusable_weights.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.ananorm_confusable_weights_multi.restype = ctypes.c_int64
        lib.ananorm_confusable_weights_multi.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.ananorm_rank_tail.restype = ctypes.c_int64
        lib.ananorm_rank_tail.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),  # o_q
            ctypes.POINTER(ctypes.c_int32),  # o_c_dev
            ctypes.POINTER(ctypes.c_uint8),  # o_ld
            ctypes.POINTER(ctypes.c_uint8),  # o_lcs
            ctypes.POINTER(ctypes.c_uint8),  # o_pf
            ctypes.POINTER(ctypes.c_uint8),  # o_sf
            ctypes.POINTER(ctypes.c_uint8),  # o_case
            ctypes.POINTER(ctypes.c_int64),  # canon_of
            ctypes.c_int32,                  # ni_pad
            ctypes.POINTER(ctypes.c_int32),  # q_lens
            ctypes.POINTER(ctypes.c_double),  # freq_tab (nullable)
            ctypes.POINTER(ctypes.c_uint8),  # has_var (nullable)
            ctypes.POINTER(ctypes.c_int64),  # vocab_ids
            ctypes.c_int32,                  # index_size
            ctypes.POINTER(ctypes.c_uint32),  # floors
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # weights
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # thresholds
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # mm/have_freq/sbc
            ctypes.POINTER(ctypes.c_int32),   # out_seg
            ctypes.POINTER(ctypes.c_int64),   # out_vid
            ctypes.POINTER(ctypes.c_double),  # out_ds
            ctypes.POINTER(ctypes.c_double),  # out_fq
            ctypes.POINTER(ctypes.c_uint8),   # out_elig
            ctypes.POINTER(ctypes.c_int32),   # out_perm
            ctypes.POINTER(ctypes.c_int32),   # out_bounds
        ]
        lib.ananorm_segment.restype = ctypes.c_int64
        lib.ananorm_segment.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # data blob
            ctypes.c_int32,                  # n_texts
            ctypes.POINTER(ctypes.c_int64),  # text_off [n_texts+1]
            ctypes.c_int32,                  # max_ngram
            ctypes.POINTER(ctypes.c_int32),  # b_text_off
            ctypes.POINTER(ctypes.c_int32),  # bb
            ctypes.POINTER(ctypes.c_int32),  # be
            ctypes.POINTER(ctypes.c_int32),  # c_text_off
            ctypes.POINTER(ctypes.c_int32),  # c_begin
            ctypes.POINTER(ctypes.c_int32),  # c_end
            ctypes.POINTER(ctypes.c_int32),  # c_blo
            ctypes.POINTER(ctypes.c_int32),  # c_bhi
            ctypes.POINTER(ctypes.c_int32),  # s_chain
            ctypes.POINTER(ctypes.c_int32),  # s_order
            ctypes.POINTER(ctypes.c_int32),  # s_begin
            ctypes.POINTER(ctypes.c_int32),  # s_end
            ctypes.POINTER(ctypes.c_int32),  # s_q
            ctypes.POINTER(ctypes.c_int32),  # u_text
            ctypes.POINTER(ctypes.c_int32),  # u_begin
            ctypes.POINTER(ctypes.c_int32),  # u_end
            ctypes.c_int64, ctypes.c_int64,  # caps_b, caps_c
            ctypes.c_int64, ctypes.c_int64,  # caps_s, caps_u
            ctypes.POINTER(ctypes.c_int64),  # out_counts [4]
        ]
        lib.ananorm_nbest_lm.restype = ctypes.c_int64
        lib.ananorm_nbest_lm.argtypes = [
            ctypes.c_int64,                   # n_arcs (sorted)
            ctypes.POINTER(ctypes.c_int32),   # a_chain
            ctypes.POINTER(ctypes.c_int32),   # a_src
            ctypes.POINTER(ctypes.c_int32),   # a_tgt
            ctypes.POINTER(ctypes.c_double),  # a_cost
            ctypes.POINTER(ctypes.c_int64),   # a_orig
            ctypes.POINTER(ctypes.c_int64),   # chain_arc_off
            ctypes.POINTER(ctypes.c_int32),   # arc_vid_idx
            ctypes.POINTER(ctypes.c_int32),   # arc_b_idx
            ctypes.POINTER(ctypes.c_int32),   # vid_tok
            ctypes.POINTER(ctypes.c_int64),   # vid_tok_off
            ctypes.POINTER(ctypes.c_int32),   # tail_tok
            ctypes.POINTER(ctypes.c_int64),   # tail_off
            ctypes.c_int32,                   # nchain
            ctypes.POINTER(ctypes.c_int32),   # nstates
            ctypes.POINTER(ctypes.c_int32),   # finals_flat
            ctypes.POINTER(ctypes.c_int64),   # finals_off
            ctypes.c_int32,                   # nbest
            ctypes.c_int64,                   # eps_base
            ctypes.POINTER(ctypes.c_int64),   # bi_keys
            ctypes.POINTER(ctypes.c_double),  # bi_contrib
            ctypes.c_int64,                   # n_bi
            ctypes.c_double,                  # smoothing
            ctypes.c_int32, ctypes.c_int32,   # bos, eos
            ctypes.c_double, ctypes.c_double, ctypes.c_double,  # weights
            ctypes.POINTER(ctypes.c_int64),   # out_arcs
            ctypes.c_int64,                   # out_cap
            ctypes.POINTER(ctypes.c_int64),   # out_off
        ]
        _lib = lib
        return _lib


def _ptr(arr: "np.ndarray", ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def rank_tail_native(
    o_q: "np.ndarray",
    o_c_dev: "np.ndarray",
    metrics,  # (o_ld, o_lcs, o_pf, o_sf, o_case) uint8, or int32 from L 256
    canon_of: "np.ndarray",  # int64 [ni_pad]
    q_lens: "np.ndarray",  # int32 [>= nseg]
    freq_tab,  # float64 [index_size] or None
    has_var,  # uint8/bool [index_size] or None
    vocab_ids: "np.ndarray",  # int64 [index_size]
    floors_u32: "np.ndarray",  # uint32 [>= nseg]
    nseg: int,
    weights,  # (ld, lcs, prefix, suffix, case, sum) floats
    score_threshold: float,
    cutoff_threshold: float,
    freq_weight: float,
    max_matches: int,
    have_freq: bool,
    stop_before_cutoff: bool,
):
    """One-call native ranking tail; returns None if the library is absent,
    and for int32 metrics (an index of width 256 or more): the library
    reads them as bytes, and an LCS, prefix or suffix above 255 would wrap,
    so those batches take the numpy tail.

    Returns (n_out, out_seg, out_vid, out_ds, out_fq, elig, perm, bounds):
    survivors of every ELIGIBLE segment in final rank order (seg-major), an
    eligibility bitmap (segments containing expandable pairs are left for
    the host's exact object path), and the (seg, canonical)-sorted pair
    permutation + per-segment bounds for those fallback rows."""
    lib = _load()
    if lib is None or any(np.asarray(m).dtype != np.uint8 for m in metrics):
        return None
    n_pairs = int(len(o_q))
    o_q = np.ascontiguousarray(o_q, dtype=np.int32)
    o_c_dev = np.ascontiguousarray(o_c_dev, dtype=np.int32)
    o_ld, o_lcs, o_pf, o_sf, o_case = (
        np.ascontiguousarray(m, dtype=np.uint8) for m in metrics
    )
    q_lens = np.ascontiguousarray(q_lens, dtype=np.int32)
    floors_u32 = np.ascontiguousarray(floors_u32, dtype=np.uint32)
    canon_of = np.ascontiguousarray(canon_of, dtype=np.int64)
    vocab_ids = np.ascontiguousarray(vocab_ids, dtype=np.int64)
    null_d = ctypes.POINTER(ctypes.c_double)()
    null_u8 = ctypes.POINTER(ctypes.c_uint8)()
    if freq_tab is not None:
        freq_tab = np.ascontiguousarray(freq_tab, dtype=np.float64)
    if has_var is not None:
        has_var = np.ascontiguousarray(has_var, dtype=np.uint8)
    out_seg = np.empty(n_pairs, dtype=np.int32)
    out_vid = np.empty(n_pairs, dtype=np.int64)
    out_ds = np.empty(n_pairs, dtype=np.float64)
    out_fq = np.empty(n_pairs, dtype=np.float64)
    out_elig = np.empty(nseg, dtype=np.uint8)
    out_perm = np.empty(max(n_pairs, 1), dtype=np.int32)
    out_bounds = np.empty(nseg + 1, dtype=np.int32)
    w_ld, w_lcs, w_prefix, w_suffix, w_case, w_sum = weights
    n = lib.ananorm_rank_tail(
        n_pairs, nseg,
        _ptr(o_q, ctypes.c_int32), _ptr(o_c_dev, ctypes.c_int32),
        _ptr(o_ld, ctypes.c_uint8), _ptr(o_lcs, ctypes.c_uint8),
        _ptr(o_pf, ctypes.c_uint8), _ptr(o_sf, ctypes.c_uint8),
        _ptr(o_case, ctypes.c_uint8),
        _ptr(canon_of, ctypes.c_int64), int(len(canon_of)),
        _ptr(q_lens, ctypes.c_int32),
        _ptr(freq_tab, ctypes.c_double) if freq_tab is not None else null_d,
        _ptr(has_var, ctypes.c_uint8) if has_var is not None else null_u8,
        _ptr(vocab_ids, ctypes.c_int64), int(len(vocab_ids)),
        _ptr(floors_u32, ctypes.c_uint32),
        float(w_ld), float(w_lcs), float(w_prefix), float(w_suffix),
        float(w_case), float(w_sum),
        float(score_threshold), float(cutoff_threshold), float(freq_weight),
        int(max_matches), int(bool(have_freq)), int(bool(stop_before_cutoff)),
        _ptr(out_seg, ctypes.c_int32), _ptr(out_vid, ctypes.c_int64),
        _ptr(out_ds, ctypes.c_double), _ptr(out_fq, ctypes.c_double),
        _ptr(out_elig, ctypes.c_uint8), _ptr(out_perm, ctypes.c_int32),
        _ptr(out_bounds, ctypes.c_int32),
    )
    if n < 0:
        return None
    return (
        int(n), out_seg, out_vid, out_ds, out_fq, out_elig, out_perm,
        out_bounds,
    )


def segment_unit(texts, max_ngram: int):
    """Native search-unit segmentation (ananorm_segment); None when the
    library is absent or a cap overflows (caller uses the Python path).

    Returns (per-text (bb, be) int32 arrays, per-text chain slices,
    chain arrays (begin, end, blo, bhi), segment arrays (chain, order,
    begin, end, q), unique-key arrays (text, begin, end)). Offsets are
    text-local; texts must be ASCII (caller gates)."""
    lib = _load()
    if lib is None:
        return None
    n_texts = len(texts)
    blobs = [t.encode() for t in texts]
    text_off = np.zeros(n_texts + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=text_off[1:])
    data = b"".join(blobs)
    total = len(data)
    caps_b = total + n_texts + 2
    caps_c = caps_b
    caps_s = caps_b * max_ngram + 16
    caps_u = caps_s
    buf = np.frombuffer(data, dtype=np.uint8) if total else np.zeros(
        1, dtype=np.uint8
    )
    b_text_off = np.empty(n_texts + 1, dtype=np.int32)
    bb = np.empty(caps_b, dtype=np.int32)
    be = np.empty(caps_b, dtype=np.int32)
    c_text_off = np.empty(n_texts + 1, dtype=np.int32)
    c_begin = np.empty(caps_c, dtype=np.int32)
    c_end = np.empty(caps_c, dtype=np.int32)
    c_blo = np.empty(caps_c, dtype=np.int32)
    c_bhi = np.empty(caps_c, dtype=np.int32)
    s_chain = np.empty(caps_s, dtype=np.int32)
    s_order = np.empty(caps_s, dtype=np.int32)
    s_begin = np.empty(caps_s, dtype=np.int32)
    s_end = np.empty(caps_s, dtype=np.int32)
    s_q = np.empty(caps_s, dtype=np.int32)
    u_text = np.empty(caps_u, dtype=np.int32)
    u_begin = np.empty(caps_u, dtype=np.int32)
    u_end = np.empty(caps_u, dtype=np.int32)
    out_counts = np.zeros(4, dtype=np.int64)
    i32 = ctypes.c_int32
    rc = lib.ananorm_segment(
        _ptr(buf, ctypes.c_uint8), n_texts, _ptr(text_off, ctypes.c_int64),
        int(max_ngram),
        _ptr(b_text_off, i32), _ptr(bb, i32), _ptr(be, i32),
        _ptr(c_text_off, i32),
        _ptr(c_begin, i32), _ptr(c_end, i32), _ptr(c_blo, i32),
        _ptr(c_bhi, i32),
        _ptr(s_chain, i32), _ptr(s_order, i32), _ptr(s_begin, i32),
        _ptr(s_end, i32), _ptr(s_q, i32),
        _ptr(u_text, i32), _ptr(u_begin, i32), _ptr(u_end, i32),
        caps_b, caps_c, caps_s, caps_u,
        _ptr(out_counts, ctypes.c_int64),
    )
    if rc != 0:
        return None
    nb, nc, ns, nu = (int(x) for x in out_counts)
    return (
        b_text_off, bb[:nb], be[:nb],
        c_text_off, c_begin[:nc], c_end[:nc], c_blo[:nc], c_bhi[:nc],
        s_chain[:ns], s_order[:ns], s_begin[:ns], s_end[:ns], s_q[:ns],
        u_text[:nu], u_begin[:nu], u_end[:nu],
    )


def available() -> bool:
    return _load() is not None


class NativeMatcher:
    """Native greedy alphabet matcher (one per Alphabet)."""

    def __init__(self, alphabet: Sequence[Sequence[str]]):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.n_classes = len(alphabet)
        elements: List[bytes] = []
        classes: List[int] = []
        for cls, group in enumerate(alphabet):
            for element in group:
                elements.append(element.encode("utf-8"))
                classes.append(cls)
        blob = b"".join(elements)
        offsets = np.zeros(len(elements) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in elements], out=offsets[1:])
        cls_arr = np.asarray(classes, dtype=np.int32)
        self._handle = lib.ananorm_build(
            blob,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cls_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(elements),
            self.n_classes,
        )

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ananorm_free(self._handle)
        except Exception:
            pass

    def normalize_batch(
        self, texts: Sequence[str], max_len: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (norms int32 [n, max_len] 0-padded, lens int32 [n]).

        lens may exceed max_len for over-long texts (norm truncated).
        The blob is built with ONE str.join + ONE encode (a per-text
        encode/join pair costs ~10 s per million entries in pure Python);
        boundaries come from a vectorized newline scan. Texts containing
        newlines (impossible for line-based loaders, possible via the API)
        take the exact per-text offsets path.
        """
        n = len(texts)
        norms = np.zeros((n, max_len), dtype=self._norm_dtype())
        lens = np.zeros(n, dtype=np.int32)
        if n == 0:
            return norms, lens
        joined = "\n".join(texts)
        if joined.count("\n") == n - 1:
            blob = joined.encode("utf-8")
            arr = np.frombuffer(blob, dtype=np.uint8)
            nl = np.flatnonzero(arr == 10).astype(np.int64)
            starts = np.concatenate(([0], nl + 1))
            ends = np.concatenate((nl, [len(blob)]))
        else:
            encoded = [t.encode("utf-8") for t in texts]
            blob = b"".join(encoded)
            ends = np.cumsum(
                np.fromiter((len(e) for e in encoded), dtype=np.int64, count=n)
            )
            starts = np.concatenate(([0], ends[:-1]))
        self.normalize_se(blob, starts, ends, norms, lens)
        return norms, lens

    def normalize_batch_auto(
        self, texts: Sequence[str]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Like normalize_batch but derives the pad width from the batch
        itself (max per-text byte length, an upper bound on norm length since
        every norm symbol consumes >= 1 byte) — avoiding the caller's
        per-text ``len(t.encode())`` pass."""
        n = len(texts)
        if n == 0:
            return np.zeros((0, 1), dtype=np.int32), np.zeros(0, dtype=np.int32)
        joined = "\n".join(texts)
        if joined.count("\n") != n - 1:
            pad = max(max((len(t.encode("utf-8")) for t in texts), default=1), 1)
            return self.normalize_batch(texts, pad)
        blob = joined.encode("utf-8")
        arr = np.frombuffer(blob, dtype=np.uint8)
        nl = np.flatnonzero(arr == 10).astype(np.int64)
        starts = np.concatenate(([0], nl + 1))
        ends = np.concatenate((nl, [len(blob)]))
        pad = max(int((ends - starts).max()), 1)
        norms = np.zeros((n, pad), dtype=self._norm_dtype())
        lens = np.zeros(n, dtype=np.int32)
        self.normalize_se(blob, starts, ends, norms, lens)
        return norms, lens

    def _norm_dtype(self):
        """int8 whenever every class index incl. UNK (n_classes + 1) fits —
        million-entry ingestion then keeps 4x fewer bytes end-to-end."""
        return np.int8 if self.n_classes + 1 <= 126 else np.int32

    def normalize_se(
        self,
        blob: bytes,
        starts: np.ndarray,
        ends: np.ndarray,
        norms: np.ndarray,
        lens: np.ndarray,
    ) -> None:
        """Normalize byte ranges [starts[i], ends[i]) of ``blob`` in place
        into preallocated ``norms`` [n, max_len] int8/int32 / ``lens`` [n]
        int32."""
        if norms.dtype == np.int8:
            fn = self._lib.ananorm_normalize_se8
            out_ptr = norms.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
        else:
            fn = self._lib.ananorm_normalize_se
            out_ptr = norms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        fn(
            self._handle,
            blob,
            np.ascontiguousarray(starts, dtype=np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)
            ),
            np.ascontiguousarray(ends, dtype=np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)
            ),
            norms.shape[0],
            norms.shape[1],
            out_ptr,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )


def counts_batch(
    norms: np.ndarray, lens: np.ndarray, n_slots: int
) -> Optional[np.ndarray]:
    """Count vectors [n, n_slots] uint8 from padded norms; None if no native.

    Accepts int8 or int32 norm matrices (the int8 layout is what ingestion
    produces for small alphabets)."""
    lib = _load()
    if lib is None:
        return None
    if norms.dtype == np.int8:
        norms = np.ascontiguousarray(norms)
        fn = lib.ananorm_counts_batch8
        ptr = norms.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    else:
        norms = np.ascontiguousarray(norms, dtype=np.int32)
        fn = lib.ananorm_counts_batch
        ptr = norms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    out = np.zeros((norms.shape[0], n_slots), dtype=np.uint8)
    fn(
        ptr,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        norms.shape[0],
        norms.shape[1],
        n_slots,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def anavalue_bytes_batch(
    norms: np.ndarray,
    lens: np.ndarray,
    primes: Sequence[int],
    unk_norm_index: int,
) -> Optional[np.ndarray]:
    """64-byte big-endian prime products per row; None if native unavailable.

    Accepts int8 or int32 norm matrices."""
    lib = _load()
    if lib is None:
        return None
    if norms.dtype == np.int8:
        norms = np.ascontiguousarray(norms)
        fn = lib.ananorm_anavalue_batch8
        ptr = norms.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    else:
        norms = np.ascontiguousarray(norms, dtype=np.int32)
        fn = lib.ananorm_anavalue_batch
        ptr = norms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    primes_arr = np.asarray(primes, dtype=np.uint32)
    out = np.zeros((norms.shape[0], 64), dtype=np.uint8)
    fn(
        ptr,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        norms.shape[0],
        norms.shape[1],
        primes_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(primes_arr),
        unk_norm_index,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def edit_script_native(a: str, b: str):
    """Encoded shortest edit script from the native library; None if absent.

    Returns a list of (op_char, run_text) with op in '=', '-', '+'.
    """
    lib = _load()
    if lib is None:
        return None
    ab = a.encode("utf-8")
    bb = b.encode("utf-8")
    cap = 2 * (len(ab) + len(bb)) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.ananorm_edit_script(ab, len(ab), bb, len(bb), out, cap)
    if n < 0:
        return None
    data = out.raw[:n]
    ops = []
    i = 0
    while i < n:
        op = chr(data[i])
        i += 1
        ln = 0
        shift = 0
        while True:
            byte = data[i]
            i += 1
            ln |= (byte & 0x7F) << shift
            if byte < 0x80:
                break
            shift += 7
        ops.append((op, data[i : i + ln].decode("utf-8")))
        i += ln
    return ops


def _decode_script(data: bytes):
    ops = []
    i = 0
    n = len(data)
    while i < n:
        op = chr(data[i])
        i += 1
        ln = 0
        shift = 0
        while True:
            byte = data[i]
            i += 1
            ln |= (byte & 0x7F) << shift
            if byte < 0x80:
                break
            shift += 7
        ops.append((op, data[i : i + ln].decode("utf-8")))
        i += ln
    return ops


def edit_scripts_batch(a: str, bs: "Sequence[str]"):
    """Shortest edit scripts from `a` to each of `bs` in one native call;
    None if the native library is unavailable."""
    lib = _load()
    if lib is None or not bs:
        return None
    ab = a.encode("utf-8")
    enc = [b.encode("utf-8") for b in bs]
    blob = b"".join(enc)
    offs = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum(
        np.fromiter((len(e) for e in enc), dtype=np.int64, count=len(enc)),
        out=offs[1:],
    )
    cap = sum(2 * (len(ab) + len(e)) + 64 for e in enc)
    out = ctypes.create_string_buffer(cap)
    out_offs = np.zeros(len(bs) + 1, dtype=np.int64)
    n = lib.ananorm_edit_script_batch(
        ab,
        len(ab),
        blob,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(bs),
        out,
        cap,
        out_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        return None
    raw = out.raw
    return [
        _decode_script(raw[out_offs[k] : out_offs[k + 1]])
        for k in range(len(bs))
    ]


class NativeConfusables:
    """A confusable set compiled into the native matcher (confusables.rs
    semantics; see ananorm.cpp). Weights for one input against a batch of
    candidate texts compute in a single call, edit scripts included."""

    def __init__(self, confusables) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        import struct

        parts = [struct.pack("<I", len(confusables))]
        for conf in confusables:
            parts.append(
                struct.pack(
                    "<dBBI",
                    conf.weight,
                    1 if conf.strictbegin else 0,
                    1 if conf.strictend else 0,
                    len(conf.editscript),
                )
            )
            for ins in conf.editscript:
                options = ins.text if ins.is_options else (ins.text,)
                parts.append(
                    struct.pack("<cI", ins.op.value.encode(), len(options))
                )
                for opt in options:
                    ob = opt.encode("utf-8")
                    parts.append(struct.pack("<I", len(ob)) + ob)
        blob = b"".join(parts)
        self._lib = lib
        self._handle = lib.ananorm_confusables_build(blob, len(blob))

    def __del__(self):  # pragma: no cover - interpreter shutdown ordering
        try:
            if self._handle:
                self._lib.ananorm_confusables_free(self._handle)
        except Exception:
            pass

    def weights_batch(self, a: str, bs: "Sequence[str]") -> "np.ndarray":
        """Product of matching confusable weights for each edit script
        a -> bs[k]."""
        ab = a.encode("utf-8")
        enc = [b.encode("utf-8") for b in bs]
        blob = b"".join(enc)
        offs = np.zeros(len(bs) + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter((len(e) for e in enc), dtype=np.int64, count=len(enc)),
            out=offs[1:],
        )
        out = np.ones(len(bs), dtype=np.float64)
        r = self._lib.ananorm_confusable_weights(
            self._handle,
            ab,
            len(ab),
            blob,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(bs),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if r < 0:
            raise RuntimeError("confusable weight computation failed")
        return out

    def weights_pairs(
        self,
        inputs: "Sequence[str]",
        texts: "Sequence[str]",
        input_of_text: "np.ndarray",
    ) -> "np.ndarray":
        """Weights for many (input, candidate) pairs in ONE call: pair k is
        inputs[input_of_text[k]] -> texts[k]."""
        enc_a = [a.encode("utf-8") for a in inputs]
        a_blob = b"".join(enc_a)
        a_off = np.zeros(len(enc_a) + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter(
                (len(e) for e in enc_a), dtype=np.int64, count=len(enc_a)
            ),
            out=a_off[1:],
        )
        enc_b = [b.encode("utf-8") for b in texts]
        b_blob = b"".join(enc_b)
        b_off = np.zeros(len(enc_b) + 1, dtype=np.int64)
        np.cumsum(
            np.fromiter(
                (len(e) for e in enc_b), dtype=np.int64, count=len(enc_b)
            ),
            out=b_off[1:],
        )
        a_idx = np.ascontiguousarray(input_of_text, dtype=np.int32)
        out = np.ones(len(texts), dtype=np.float64)
        r = self._lib.ananorm_confusable_weights_multi(
            self._handle,
            a_blob,
            a_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            a_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            b_blob,
            b_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(texts),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if r < 0:
            raise RuntimeError("confusable weight computation failed")
        return out


def nbest_lm_native(
    arcs_sorted,  # (a_chain i32, a_src i32, a_tgt i32, a_cost f64, a_orig i64)
    chain_arc_off: "np.ndarray",  # int64 [nchain+1]
    arc_vid_idx: "np.ndarray",  # int32 per ORIGINAL arc (-1 = OOV)
    arc_b_idx: "np.ndarray",  # int32 per ORIGINAL arc
    vid_tok: "np.ndarray",
    vid_tok_off: "np.ndarray",
    tail_tok: "np.ndarray",
    tail_off: "np.ndarray",
    nstates: "np.ndarray",  # int32 [nchain]
    finals_flat: "np.ndarray",
    finals_off: "np.ndarray",
    nbest: int,
    eps_base: int,
    bi_keys: "np.ndarray",
    bi_contrib: "np.ndarray",
    smoothing: float,
    bos: int,
    eos: int,
    lm_w: float,
    vm_w: float,
    ctx_w: float,
):
    """Native n-best + LM lattice decode (ananorm_nbest_lm); returns
    (out_arcs, out_off) — selected original arc ids per chain, forward
    order, epsilon arcs dropped — or None when the library is absent."""
    lib = _load()
    if lib is None:
        return None
    a_chain, a_src, a_tgt, a_cost, a_orig = (
        np.ascontiguousarray(a, dt)
        for a, dt in zip(
            arcs_sorted,
            (np.int32, np.int32, np.int32, np.float64, np.int64),
        )
    )
    chain_arc_off = np.ascontiguousarray(chain_arc_off, np.int64)
    arc_vid_idx = np.ascontiguousarray(arc_vid_idx, np.int32)
    arc_b_idx = np.ascontiguousarray(arc_b_idx, np.int32)
    vid_tok = np.ascontiguousarray(vid_tok, np.int32)
    vid_tok_off = np.ascontiguousarray(vid_tok_off, np.int64)
    tail_tok = np.ascontiguousarray(tail_tok, np.int32)
    tail_off = np.ascontiguousarray(tail_off, np.int64)
    nstates = np.ascontiguousarray(nstates, np.int32)
    finals_flat = np.ascontiguousarray(finals_flat, np.int32)
    finals_off = np.ascontiguousarray(finals_off, np.int64)
    bi_keys = np.ascontiguousarray(bi_keys, np.int64)
    bi_contrib = np.ascontiguousarray(bi_contrib, np.float64)
    nchain = len(nstates)
    out_cap = int(nstates.sum()) + 1
    out_arcs = np.empty(out_cap, np.int64)
    out_off = np.empty(nchain + 1, np.int64)
    n = lib.ananorm_nbest_lm(
        int(len(a_chain)),
        _ptr(a_chain, ctypes.c_int32), _ptr(a_src, ctypes.c_int32),
        _ptr(a_tgt, ctypes.c_int32), _ptr(a_cost, ctypes.c_double),
        _ptr(a_orig, ctypes.c_int64),
        _ptr(chain_arc_off, ctypes.c_int64),
        _ptr(arc_vid_idx, ctypes.c_int32), _ptr(arc_b_idx, ctypes.c_int32),
        _ptr(vid_tok, ctypes.c_int32), _ptr(vid_tok_off, ctypes.c_int64),
        _ptr(tail_tok, ctypes.c_int32), _ptr(tail_off, ctypes.c_int64),
        nchain, _ptr(nstates, ctypes.c_int32),
        _ptr(finals_flat, ctypes.c_int32), _ptr(finals_off, ctypes.c_int64),
        int(nbest), int(eps_base),
        _ptr(bi_keys, ctypes.c_int64), _ptr(bi_contrib, ctypes.c_double),
        int(len(bi_keys)),
        float(smoothing), int(bos), int(eos),
        float(lm_w), float(vm_w), float(ctx_w),
        _ptr(out_arcs, ctypes.c_int64), out_cap,
        _ptr(out_off, ctypes.c_int64),
    )
    if n < 0:
        return None
    return out_arcs[: int(n)], out_off
