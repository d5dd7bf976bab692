"""Lexicon and batch sharding over a ("dp", "lex") mesh of devices.

The port of ``analiticcl_tpu/parallel/mesh.py``:

* **Batch data parallelism** ("dp"): the charcount-sorted query batch is cut
  into ``n_dp`` contiguous parts, one per mesh row.
* **Lexicon sharding** ("lex"): the index rows, sorted globally by
  charcount, are dealt round-robin over ``n_lex`` shards, so each shard is
  charcount-sorted and sees the whole charcount range. Each shard has its
  own :class:`~..convert.DeviceIndex` on the devices of its mesh column and
  its own band plan.

One process drives every device of the mesh, as ``jax.shard_map`` over a
single-controller mesh does; devices may repeat (``["cuda:0"] * 4``), and a
shard that one device holds for several mesh rows is stored there once. The
device call of a batch runs, for each mesh row, stage A
(:func:`~..ops.pipeline.query_stage_a`, kernel K1) on every shard, sums the
shards' per-query exact-anagram counts, and then stage B
(:func:`~..ops.pipeline.query_stage_b`, kernel K2) on every shard with that
global count. The JAX mesh runs the whole core per shard, so under
StopAtExactMatch a shard without an exact anagram of a query keeps every
pair within the edit threshold (ROADMAP F8); here the sum repairs that. The
shards' survivors are merged on the host in ``collect`` (device rows and
query rows made global, the frequency maximum taken over the shards), and
the ranking tails run unchanged. ``refresh_freqs`` also refreshes the
variant flags, which the JAX mesh leaves stale.

Budgets are the JAX mesh's: sticky (P, P2) per batch size for every shard
call, sized on the card from the shard's rows, held against the largest
shard's totals, and on overflow the whole mesh call runs again at the new
budget (``DevicePipeline.collect``). Every shard call is enqueued on its
device's stream without waiting for the card, and its outputs are copied
into pinned host buffers there.

What stays behind (ROADMAP P9): the ``_sharded_fn`` jit cache, the budget
hint keys, the band-width buckets, sticky widths and compile ceilings (each
shard's band is exact here), the 2048-row pad unit, and the packed
per-shard output buffer with its unpacking.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..convert import DeviceIndex, band_width, device_index, host_layout
from ..device import resolve_device
from ..ops.pipeline import (
    DevicePipeline, Fetched, _batch_rows, query_stage_a, query_stage_b,
)
from ..ops.stage_a import ROW_BLOCK, _b_tile
from ..utils.profiling import StageTimer


def initialize_distributed(**kwargs) -> None:
    """Multi-process initialization passthrough: the counterpart of
    ``jax.distributed.initialize``. The caller names the rendezvous
    (``init_method="tcp://localhost:<port>"``), ``world_size`` and ``rank``.
    The mesh takes devices this process drives, as the JAX package's does
    in effect: its sharded step returns one array over every process's
    devices, which no process can fetch whole."""
    torch.distributed.init_process_group(**kwargs)


class Mesh:
    """A ``[dp, lex]`` grid of devices. ``shape`` gives ``{"dp": n_dp,
    "lex": n_lex}``, as a JAX mesh's does."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices  # object array [dp, lex] of torch.device

    @property
    def shape(self) -> dict:
        return {"dp": self.devices.shape[0], "lex": self.devices.shape[1]}


def make_mesh(devices: Optional[Sequence] = None,
              dp: Optional[int] = None) -> Mesh:
    """A ("dp", "lex") mesh over ``devices`` (default: every visible CUDA
    device; without one it raises). ``dp`` defaults to 1 (pure lexicon
    sharding); it must divide the device count. Devices may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= to "
                "build a mesh over others"
            )
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [resolve_device(d) for d in devices]
    dp = dp or 1
    if not devs or dp < 1 or len(devs) % dp:
        raise ValueError(f"{len(devs)} devices not divisible by dp={dp}")
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(dp, len(devs) // dp))


class ShardedPipeline(DevicePipeline):
    """DevicePipeline with the index sharded over a ("dp", "lex") mesh."""

    def __init__(self, model, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_dp = self.mesh.shape["dp"]
        self.n_lex = self.mesh.shape["lex"]
        self.model = model
        # prepare() puts a batch here; each shard call copies its part over
        self.device = self.mesh.devices[0, 0]
        lay = host_layout(model, pad_unit=ROW_BLOCK * self.n_lex)
        self.A = model.alphabet_size()
        self.L = lay.L
        self.Ni_pad = len(lay.cc)
        self.Ni_shard = self.Ni_pad // self.n_lex
        self.M_shard = self.Ni_shard // ROW_BLOCK
        self._norm_dtype = lay.norms2.dtype

        # device row f = shard * Ni_shard + local holds global sorted
        # position local * n_lex + shard (the JAX mesh's to_dev)
        def to_shards(x):
            """[Ni_pad, ...] in global sorted order -> [n_lex, Ni_shard, ...]."""
            return np.ascontiguousarray(
                x.reshape((self.Ni_shard, self.n_lex) + x.shape[1:])
                .swapaxes(0, 1)
            )

        self._canon_of = to_shards(lay.canon_of).reshape(-1)
        self._cc_shard = to_shards(lay.cc)  # ascending per shard: band plans
        cols = [to_shards(x) for x in (
            lay.bins, lay.cc, lay.validrows, lay.norms2, lay.norm_lens,
            lay.freqs, lay.first_lower,
        )]
        # one copy of shard s per device that holds it; the shard's block
        # extents are reckoned once, with its first copy
        self._copies = {}
        self._extents = [None] * self.n_lex  # host tables: the band plans
        for d in range(self.n_dp):
            for s in range(self.n_lex):
                key = (s, self.mesh.devices[d, s])
                if key not in self._copies:
                    self._copies[key] = device_index(
                        *(c[s] for c in cols), key[1],
                        extents=self._extents[s],
                    )
                    self._extents[s] = self._copies[key].extents_host
        self._init_async(list(self.mesh.devices.flat), self.Ni_shard)
        for idx in self._copies.values():
            self._share_with_stream(idx)
        self._refresh_variant_flags()
        self.stats = StageTimer()
        self.candidates = 0
        self.survivors = 0
        self._oracle_memo: dict = {}

    def shard(self, d: int, s: int) -> DeviceIndex:
        """Lexicon shard ``s`` on the device of mesh row ``d``."""
        return self._copies[(s, self.mesh.devices[d, s])]

    def index_bytes(self) -> int:
        """Bytes of one lexicon shard's index tensors."""
        idx = self._copies[next(iter(self._copies))]
        return sum(t.numel() * t.element_size() for t in idx[:8])

    def refresh_freqs(self, freqs_canonical: np.ndarray, linked=None) -> None:
        """Re-upload each shard's frequency column on each device that holds
        it, and refresh the variant flags (see
        :meth:`DevicePipeline.refresh_freqs`)."""
        freqs = np.asarray(
            freqs_canonical[self._canon_of], dtype=np.int64
        ).reshape(self.n_lex, self.Ni_shard)
        for (s, dev), idx in self._copies.items():
            self._copies[(s, dev)] = idx._replace(
                freqs=torch.from_numpy(freqs[s]).to(dev)
            )
            self._share_with_stream(self._copies[(s, dev)])
        self._refresh_variant_flags(linked)
        self._oracle_memo.clear()

    # ------------------------------------------------------------------

    def _batch_rows(self, n: int) -> int:
        # every mesh row gets the same number of queries
        return -(-_batch_rows(n) // self.n_dp) * self.n_dp

    def _hit_bits(self, B: int, nb_band) -> int:
        # the largest shard call: B / n_dp queries over its shard's band
        return B // self.n_dp * int(nb_band.max()) * ROW_BLOCK

    def _band_plan(self, q_cc: np.ndarray, k_ana: np.ndarray, B: int):
        """Exact band plan per (mesh row, lex shard, tile).

        Returns (start_blk int32 [n_dp, n_lex, nqt], nb_band int
        [n_dp, n_lex], width int [n_dp, n_lex]): the tiles of mesh row
        ``d`` cover, in shard ``s``, every row whose charcount is within
        their queries' bands (as :meth:`DevicePipeline._band_plan` does for
        one index) with windows of ``nb_band[d, s]`` blocks, whose largest
        extent in the shard is ``width[d, s]``. The tile is ``_b_tile`` of
        the row's batch and the shard's rows, as ``resolve_pairs`` computes
        it."""
        B_local = B // self.n_dp
        bt = _b_tile(B_local, self.Ni_shard)
        nqt = B_local // bt
        cc_t = q_cc.reshape(self.n_dp, nqt, bt)
        k_t = k_ana.reshape(self.n_dp, nqt, bt)
        act = k_t >= 0
        lo_t = np.where(act, cc_t - k_t, np.iinfo(np.int32).max).min(axis=2)
        hi_t = np.where(act, cc_t + k_t, -1).max(axis=2)  # [n_dp, nqt]
        starts = np.zeros((self.n_dp, self.n_lex, nqt), dtype=np.int32)
        nb_band = np.zeros((self.n_dp, self.n_lex), dtype=np.int64)
        width = np.zeros((self.n_dp, self.n_lex), dtype=np.int64)
        for s in range(self.n_lex):
            cc_s = self._cc_shard[s]
            lo_row = np.searchsorted(cc_s, lo_t, side="left")
            hi_row = np.searchsorted(cc_s, hi_t, side="right")
            st = lo_row // ROW_BLOCK
            need = np.maximum(-(-hi_row // ROW_BLOCK) - st, 1)
            nb = np.minimum(need.max(axis=1), self.M_shard)  # [n_dp]
            st = np.minimum(st, (self.M_shard - nb)[:, None])
            starts[:, s, :] = np.maximum(st, 0)
            nb_band[:, s] = nb
            for d in range(self.n_dp):
                width[d, s] = band_width(self._extents[s], starts[d, s],
                                         int(nb[d]))
        return starts, nb_band, width

    def _query(self, args, window: int, nb_band, width, use_stop_exact: bool,
               P: int, P2: int):
        """Per mesh row: stage A on every shard, the shards' exact counts
        summed, stage B on every shard at budgets (P, P2), each on its
        device's stream. Returns ``[(device, outputs)]`` mesh row by mesh
        row, shard by shard, for :meth:`_finalize` to merge."""
        (q_counts, q_cc, q_norms, q_lens, q_first_lower, k_ana, k_ed, k_len,
         stop_exact, start_blk, weights, score_threshold) = args
        have_freq = bool(self.model.have_freq)
        B_local = q_counts.shape[0] // self.n_dp
        out = []
        for d in range(self.n_dp):
            rows = slice(d * B_local, (d + 1) * B_local)
            shard_args, stage_a, nexact = [], [], []
            for s in range(self.n_lex):
                idx = self.shard(d, s)
                dev = idx.bins.device
                with self._on(dev):
                    (qc, qcc, qn, ql, qf, ka, ke, kl, blk, w, thr) = (
                        x.to(dev, non_blocking=True) for x in (
                            q_counts[rows], q_cc[rows], q_norms[rows],
                            q_lens[rows], q_first_lower[rows], k_ana[rows],
                            k_ed[rows], k_len[rows], start_blk[d, s],
                            weights, score_threshold,
                        )
                    )
                    shard_args.append((idx, qn, ql, qf, ke, blk, w, thr))
                    sa = query_stage_a(
                        idx, qc, qcc, ka, kl, blk, int(nb_band[d, s]),
                        int(width[d, s]),
                    )
                    stage_a.append(sa)
                    # a copy between cards runs on the source card's
                    # current stream: here the pipeline stream K1 wrote
                    # nexact on, the stream that allocated it (F9)
                    nexact.append(sa.nexact.to(self.device, non_blocking=True))
            # a query keeps only its exact anagrams when ANY shard holds one
            nexact = sum(nexact)
            use_exact = stop_exact[rows] & (nexact > 0)
            for (idx, qn, ql, qf, ke, blk, w, thr), sa in zip(shard_args,
                                                              stage_a):
                dev = idx.bins.device
                with self._on(dev):
                    out.append((dev, query_stage_b(
                        idx, sa, use_exact.to(dev, non_blocking=True), qn, ql,
                        qf, ke, blk, w, thr, have_freq=have_freq, P=P, P2=P2,
                        window=window, use_stop_exact=use_stop_exact,
                    )))
        return out

    def _finalize(self, host, B: int, P2: int) -> Fetched:
        """The shards' survivors as one set of host arrays: query rows
        offset by their mesh row's first query, device rows by their shard's
        first row (``_canon_of``'s shard-major layout); the frequency
        maximum taken over the shards of a mesh row; the totals summed, and
        their largest per shard call kept for the budgets."""
        parts, max_freq = [], []
        total_match = total_keep = peak_match = peak_keep = 0
        B_local = B // self.n_dp
        for k, res in enumerate(host):
            d, s = divmod(k, self.n_lex)
            (o_q, o_c, o_ld, o_lcs, o_pf, o_sf, o_case, m_f, n_m,
             n_k) = (t.numpy() for t in res)
            n_m, n_k = int(n_m), int(n_k)
            n = min(n_k, P2)
            o_q = o_q[:n] + d * B_local
            o_c = o_c[:n] + s * self.Ni_shard
            parts.append((o_q, o_c, *(x[:n] for x in (
                o_ld, o_lcs, o_pf, o_sf, o_case))))
            if s == 0:
                max_freq.append(m_f)
            else:
                max_freq[-1] = np.maximum(max_freq[-1], m_f)
            total_match += n_m
            total_keep += n_k
            peak_match = max(peak_match, n_m)
            peak_keep = max(peak_keep, n_k)
        cols = tuple(np.concatenate(c) for c in zip(*parts))
        return Fetched(cols, np.concatenate(max_freq).astype(np.uint32),
                       total_match, total_keep, peak_match, peak_keep)


def get_sharded_pipeline(model, mesh: Optional[Mesh] = None) -> ShardedPipeline:
    return ShardedPipeline(model, mesh)
