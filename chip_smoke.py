#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: serving, training (both model
families), the tile experiment, row padding, the HTTP serving daemon, the
mesh, the propagation layouts, the scaled configuration and the CLI on an
on-disk dataset.

    python3 chip_smoke.py

Needs one CUDA card (an H100; the kernels are built for sm_90a) and
``nvcc``.  Phases, each of which fails the run (nonzero exit) when it
fails:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every CUDA kernel from ``gcn_recommendation_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
3. kernel check: the int8 quantizer (``csrc/quant_int8.cu``) in both
   rounding modes (``quantize_rows_int8``, stochastic; ``quantize_users_int8``,
   nearest) and through both entry points (the lane-group kernel and the
   first version, ``quantize_rows_int8_launch_v1``) against the plain
   PyTorch versions at the catalog shape [20000, 64], at [2000000, 64], at
   the largest request [1024, 64], at ragged [1000, 48] and [37, 50] and at
   the north-star catalog of phase 13, [200000, 256]; q
   and scales must be bit-equal.  Times are CUDA-event medians over 5
   windows: of 20 back-to-back eager calls (plain version, ``call_ms``) or
   of replays of a CUDA graph of 20 launches (``ms``), beside a kernel that
   does nothing on the same grid (``floor_ms``);
4. the serving path: the books-shaped bench bundle (72,000 nodes, ~3.03M
   adjacency nonzeros), LightGCN dim 64, 3 layers, random weights from a
   seed; ``Retriever.from_params`` with the f32 and the int8 catalog,
   then requests of 1, 7, 64 and 1024 users at k=20 through
   ``recommend``, ``recommend_pipelined`` and ``recommend_many``.
   Checked: finite scores, no seen item returned, pipelined and
   micro-batched equal per-request results, the per-layer ELL propagation
   equal to the ``propagate_coo`` oracle within 1e-5, int8 top-20 overlapping f32
   top-20 by >= 0.9, and the kernel launched during the int8 load;
5. kernel check: ``tile_matvec`` in both layouts, compressed
   (``csrc/tile_gather_spmm.cu``) and dense (``csrc/tile_spmm.cu``), against
   the plain version on the same bundle's tile partition (min_fill 64, 8
   tiles per step, d = 64) with f32 tiles (max abs diff <= 1e-5) and bf16
   tiles (<= 1e-5 * max(1, max|plain|)), and on a ragged partition (N not
   a multiple of 128, d = 48); ``layout="auto"`` must pick compressed
   there; the ``propagate_ell_tiles`` gradient of ``sum(out**2)`` on the
   auto layout against the plain ELL path's within 1e-4; times of both
   layouts beside their bounds and beside ``torch.sparse.mm`` of the tile
   edges as a CSR matrix.  A kernel's ``ms`` is its time on the card, from
   replaying a CUDA graph of 20 launches; ``call_ms`` is the time of one
   call in a loop of eager calls, which the host bounds when the kernel is
   short;
6. the training path: a ``Trainer`` with ``tile_spmm=True`` (auto layout:
   the compressed kernel) and an ELL twin (the default ``Trainer``: the
   merge-skip ``propagate_sum_ell``) from the same params (dim 64, 3
   layers, batch 2048) take the same 20 steps on the same batches and
   negatives.  Checked: finite losses, the two paths' per-step losses
   within rtol 2e-3, the loss falling, ``tile_matvec`` launched exactly 6
   times a step plus 3 for the validation forward, Recall@20 / NDCG@20 in
   [0, 1], and the ``best`` checkpoint serving a 64-user request through
   ``Retriever``.  A per-layer twin (``graph_fuse_layers=False``) takes
   the same 20 steps from the same params: per-step losses within rtol
   2e-5 of the fused run, final params within 1e-6; ms per step and peak
   memory of each.  Then, measurement only and time-boxed: ms per step of
   the tile trainer at ``tile_min_fill`` 64, 32 and 16;
7. the tile experiment (``tools/exp_block_tiles.py``: the dense kernel of
   phase 5 on dense, balanced tiles, 16 tiles in each of 384 row blocks, 564
   column blocks, d = 64, seed 0; ``layout="auto"`` must pick dense there):
   kernel against the experiment's plain
   formula at one tile per step with f32 and with bf16 tiles and at 8
   tiles per step with f32 (all <= 1e-5 * max(1, max|plain|); the bf16
   kernel is also held against the product with the window left in f32,
   which must lie outside that limit), the one-tile result against the
   8-tile result,
   the 30-application chain of each, launches counted from 0 around the
   experiment's own calls (1 + 2 * 30 a case), times beside the bound and
   beside a ``torch.sparse_bsr_tensor`` product of the same tiles; then a
   fill scan: the same geometry cut to 1,536 tiles with values kept at
   random positions to fills of 0.35% to 100%, both kernels at each fill
   against the plain version, and the fill at which their times cross;
8. the ``LightGCN_Fusion`` path on the same bundle with a [20000, 64]
   content matrix from a seed: a tile ``Trainer`` and its ELL twin take
   the same 20 steps.  Checked: finite, falling losses, the two paths
   within rtol 2e-3, ``tile_matvec`` launched 6 a step plus 3 for the
   validation, the content buffer bit-equal before and after, the fusion
   kernel changed, a ``best`` checkpoint of six keys that reloads and
   serves 64 users from the f32 and the int8 catalog (the quantizer
   launched once, top-20 overlap >= 0.9);
9. row padding: the phase-4 LightGCN params in a model with
   ``set_row_multiple`` 8 and 48 over the padded graph give final
   embeddings within 1e-6 of the unpadded forward, on the fused and the
   per-layer ELL path and on the tile path;
10. the serving daemon, f32 then int8 catalog: a ``best`` checkpoint of
   seeded weights on disk, the server built through ``cli.make_server``
   (port 0, ``--warm_batch 64``, ``--max_coalesce 16``), then over HTTP
   from 16 client threads of a client process: ``/health``; 200 ``/recommend`` requests of
   1-64 users whose bodies must equal ``Retriever.recommend`` called
   directly: 20 distinct items in descending order of their exact scores
   (recomputed on the host), none scoring below the direct call's 20th
   (a coalesced dispatch sums at another batch shape: 1e-6 relative), and
   scores equal to the exact ones after the rounding to 4 digits; no seen
   item; the
   400 / 404 / 501 paths; a checkpoint of other weights, ``POST /reload``
   with requests in flight (each answered wholly from the old or wholly
   from the new weights), then answers from the new weights only;
   ``/stats`` consistent.  Launches counted from 0 around each server:
   the stochastic mode once per int8 build (start + reload = 2), the
   nearest mode once per int8 dispatch, neither on the f32 server.  A
   ``daemon: {...}`` line gives requests/s and users/s at 16 clients,
   mean and p99 latency, the mean coalesce factor, reload seconds, first
   against warm call latency and peak memory;
11. the multi-device layer (``core/mesh.py``, ``parallel/``) as a world of
   one process over NCCL with mesh (1, 1), both schedules forced
   (``auto`` takes neither at (1, 1)).  Training: a ``ShardedTrainer``
   (gspmd) and a ``HaloTrainer`` take the 20 steps of phase 6's per-layer
   ELL trainer (seed-42 params, the same batches and negatives), whose run
   is repeated here as the reference: losses and final params within rtol
   1e-4 / atol 1e-6, ms per step and peak memory beside the single-device
   step.  Evaluation: ``evaluate_sharded`` against ``evaluate_embeddings``
   on the val split (recall rtol 1e-6, NDCG rtol 1e-5).  Retrieval: the
   sharded ``Retriever``, f32 and int8, against the single-device one on
   requests of 1, 64 and 1024 users: equal indices, the int8 catalog
   bit-equal (the quantizer's row offset), the quantizer launched, with
   counts from 0, once in stochastic mode per load (one shard a rank) and
   once in nearest mode per request; latencies beside the single-device
   ones.  ``recommend --mesh 1,1`` through the CLI's parser and mode
   function; ``serve --mesh 1,1`` through ``cli.make_server`` over HTTP,
   before and after a ``/reload``.  With two cards, the same training and retrieval checks on a
   2-rank NCCL world (meshes (1, 2) and (2, 1)); with one, the line
   ``mesh_multi: skipped, 1 CUDA device``.  The process group is
   destroyed at the end of the phase.  Measurement only: a
   ``torch.profiler`` window of each trainer's steps and of 20 requests of
   64 users on each retriever (device time by kernel, the host's busiest
   ops, ``profile_mesh_*:`` lines);
12. the layouts, on the books bundle at d = 64, 3 layers (``layouts:``,
   ``knee_scan:``, ``bf16:``, ``native:`` lines): (a) ``propagate_sum_ell``
   against the sum of three ``propagate_ell`` calls (<= 1e-5), the
   gradients of ``sum(out**2)`` (<= 1e-4), bf16 storage against f32
   (rtol and atol 0.05, f32 out), fwd+bwd ms of each, the views' bytes;
   (b) the source-chunked layout at C = 2, 3, 4 against plain ELL
   (forward <= 1e-5, gradient <= 1e-4, bf16 with f32 accumulation within
   2e-2 of the scale), ``build_chunked_ell`` host seconds, ms of each;
   (c) the gather-knee scan of ``tools/exp_gather_knee.py`` (72k = the
   bundle, 180k, 400k, 1M nodes; f32 and bf16; plain ELL against C = 2
   and 4, three repeats; every chunked result equal to plain), time-boxed
   to 60 s, beside the ``GATHER_KNEE_ROWS`` the port uses; (d) the default
   trainer at ``compute_dtype="bfloat16"``, phase 6's params and batches:
   finite falling losses within rtol 2e-2 of the f32 run, ms per step and
   peak memory beside f32; (e) ``test`` mode through the CLI's parser and
   mode function on the fused trainer's checkpoint (one
   ``propagate_sum_ell``), its Recall@20 / NDCG@20 equal to
   ``Trainer.validate`` over the test split within rtol 1e-6; that
   checkpoint serving 64 users from an int8 catalog (K2 once in each
   mode, counted from 0); the native ETL library loaded, the bundle's
   graph on it equal to numpy's (indices identical, weights rtol 1e-6),
   the 20-core mask equal to numpy's, build seconds of each;
13. the scaled configuration, LightGCN at dim 256 and 4 layers
   (``BASELINE.json`` ``configs[4]``; ``scale_*:`` lines): (a) on the books
   bundle, K3 in both layouts with f32 and bf16 tiles against the plain
   version at d = 4, 50, 132, 200 and 256 (phase 5's limits), its times at
   d = 256 beside the bounds and ``torch.sparse.mm``; a tile trainer (the
   compressed K3 at d = 256, 8 launches a step and 4 a validation) and its
   fused ELL twin take the same 20 steps from the same params (finite,
   falling, per-step losses within rtol 2e-3), then 64 users from an int8
   catalog (K2 once in each mode, counted from 0; top-20 overlap with f32
   >= 0.9); (b) the north-star graph of ``tools/exp_scale.py`` (720,000
   nodes, ~33.0M nonzeros): the default ``Trainer`` on the source-chunked
   layout (two chunks by the knee rule) takes 3 steps and validates over
   all 500,000 validation users, then an int8 catalog serves 1, 64 and
   1024 users (K2 once stochastic, once nearest a request, counted from 0):
   ETL seconds, ms per step, peak GiB, validation seconds and users/s,
   request ms; measurement only, one evaluation batch in its pieces and a
   ``torch.profiler`` window of two steps;
14. the CLI on an on-disk dataset (``cli_dataset:`` line), through
   ``cli.main`` in this process so the launch counters see the kernels:
   ``prepare --recipe synthetic`` at the books regime of
   ``tools/run_regime_grids.py`` (10,000 users, 5,000 items, 278,034 train
   rows, written by ``data/parquet.py``), whose files ``read_columns``
   must give back as the generator's arrays, exactly; ``train`` 2 epochs
   (Val Recall@20 in (0, 1]) and ``test``; ``recommend --int8`` for 4 users
   (K2 once stochastic on load and once nearest for the request, counted
   from 0), each quantizer call of the command held bit-equal to its plain
   version on the inputs the command gave it (the trained catalog, the
   request rows), both as the command's own output and relaunched;
   ``train --tile_spmm`` 1 epoch (K3 6 a step plus 3 for the validation,
   counted from 0), with the first call on each tile partition of the
   command (the regime's own partition, forward and backward) held against
   plain on its inputs within the limits of phase 5, both as the command's
   own output and relaunched; ``tools/run_experiments.py`` for
   ``base_20e16c_brd``, whose best R@20 must lie within the band
   (``tools/regime_comparison.py::band_of`` of the committed grids) of the
   JAX grid's best over epochs <= 20 in
   ``exp_synth/results/base_150e16c_brd/``;
15. the measurement and drill tools of ``gcn_recommendation_tpu_torch/tools``
   (``tools:`` line), each through its ``main(argv)`` in this process:
   ``card_checks`` at its full size (K2 3 stochastic + 124 nearest launches,
   counted from 0) and ``exp_serve`` at 5,000 users x 2,000 items with
   3 requests (K2 once at the int8 load and once a request), every quantizer
   call of each bit-equal to its plain version on the inputs the tool gave
   it; ``exp_tile_spmm`` at min_fill 64 on a 10,000-user heavy-tailed graph
   (K3 50 launches, counted from 0; the first call of each pass and tile
   dtype held against plain within the limits of phase 5, as the tool's
   output and relaunched; f32 tiles within 1e-5 of plain ELL);
   ``exp_topk_mask`` at F = 8, ``exp_hub_threshold`` at 256 and 128,
   ``exp_min_width`` at width 8 with NB = 400,000, ``exp_step_profile``
   with 3-step chains, ``calibrate_regimes`` 2 epochs of the books regime
   (best R@20 under the oracle), ``multiproc_dryrun`` as a world of one
   over NCCL (``PASSED``) and ``real_data_dryrun`` on an
   ``amazon_books_emb`` dump drawn from a seed (exit 0; a missing input
   exits 2);
16. the seven studies ported from the JAX repo's root ``tools/``
   (``tools11:`` line with each tool's seconds), each through its
   ``main(argv)`` at a reduced size, with K2's and K3's
   counts set to 0 before them and read after (none of the seven launches
   either): ``exp_bf16_accuracy`` 5 epochs of both dtypes at 5,000 users x
   2,000 items (best Recall@20 in (0, 1]), ``exp_spmm_variants`` at the
   books regime's size with 5-call chains (bucketed within 1e-4 of flat,
   four forms timed with and without the host, CUDA kernels counted),
   ``exp_dim_split`` at 90k and 360k rows x d 128 and 256 and
   ``exp_knee_d192`` at 120k and 240k rows (1M gathered rows; across the
   port's 166,666-row knee), each gather equal to the CPU's ``emb[idx]``,
   ``exp_block_density`` on the heavy graph at 10,000 users,
   ``exp_block_matmul`` at 16 x 384 tiles (its f32 and bf16 variants held
   against the CPU's f32 formula on a small case: 1e-4 and 2e-2 of the
   largest value) and ``exp_compile_cost`` for the fused variant in a
   fresh process (``--keep_build``; finite losses).

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero without a result when
no CUDA card is present.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import glob
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import torch

from gcn_recommendation_tpu_torch import cli
from gcn_recommendation_tpu_torch.config import Config
from gcn_recommendation_tpu_torch.data import native_ext, parquet, synthetic
from gcn_recommendation_tpu_torch.data.sampler import (
    epoch_batches,
    membership_arrays,
    sample_negatives,
)
from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
from gcn_recommendation_tpu_torch.graph.build import build_chunked_ell, build_normalized_adjacency
from gcn_recommendation_tpu_torch.graph.tiles import TILE, partition_tiles
from gcn_recommendation_tpu_torch.kernels import _build
from gcn_recommendation_tpu_torch.models import get_model
from gcn_recommendation_tpu_torch.ops import block_spmm, quant, spmm
from gcn_recommendation_tpu_torch.ops.spmm import (
    propagate_ell,
    to_device_graph,
    to_device_graph_auto,
)
from gcn_recommendation_tpu_torch.serve import Retriever
from gcn_recommendation_tpu_torch.server import RecommendServer
from gcn_recommendation_tpu_torch.tools import (
    exp_block_tiles,
    exp_gather_knee,
    regime_comparison,
    run_experiments,
    run_regime_grids,
)
from gcn_recommendation_tpu_torch.train.trainer import Trainer
from gcn_recommendation_tpu_torch.utils import checkpoint as ckpt
from gcn_recommendation_tpu_torch.utils.timing import card_line, cuda_ms, graph_ms, host_ms

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense (bf16 x bf16 is exact in f32)
QUANT_OPS_PER_ELEMENT = 20    # hash (~12 integer ops) + divide, add, floor, clamp
REQUEST_SIZES = (1, 7, 64, 1024)
K = 20
PROPAGATION_ATOL = 1e-5       # f32 ELL vs f32 COO: same sums, other order
MIN_INT8_OVERLAP = 0.9
TILE_F32_ATOL = 1e-5          # f32 kernel vs plain: same products, other sum order
TILE_BF16_RTOL = 1e-5         # bf16 tiles, x max(1, max|plain|): the plain version rounds
                              # the window as the kernel does, so products are exact too
TILE_GRAD_ATOL = 1e-4         # tile vs ELL gradient of sum(out**2)
TRAIN_STEPS = 20
TRAIN_LOSS_RTOL = 2e-3        # tile vs ELL per-step loss (tests/test_tile_spmm.py)
PADDING_ATOL = 1e-6           # padded vs unpadded forward: same sums, tables of |x| <= 0.011
PAD_MULTIPLES = (8, 48)       # 8 pads only ELL bucket rows here; 48 pads every table too
SCAN_FILLS = (0.0035, 0.015, 0.06, 0.25, 1.0)   # the fill scan of the two tile kernels
SCAN_MIN_FILLS = (64, 32, 16)                   # tile_min_fill scan of the tile trainer
MIN_FILL_SCAN_BUDGET_S = 40.0
MESH_RTOL, MESH_ATOL = 1e-4, 1e-6   # sharded vs single-device training (tests/test_parallel.py)
MESH_REQUEST_SIZES = (1, 64, 1024)
MESH_MULTI_TIMEOUT_S = 300          # a 2-rank collective that waits longer fails the run
QUANT_CHECK_SHAPES = ((20_000, 64), (2_000_000, 64), (1_024, 64), (1_000, 48), (37, 50),
                      # phase 13's shapes: the catalogs and the requests at dim 256
                      (200_000, 256), (20_000, 256), (1_024, 256), (64, 256), (1, 256))
DAEMON_CLIENTS = 16
DAEMON_REQUESTS = 200         # a half before the reload, a half after
DAEMON_STRADDLE = 32          # requests in flight around the reload
DAEMON_MAX_USERS = 64
DAEMON_SCORE_ATOL = 0.6e-4    # bodies carry scores rounded to 4 digits: half a unit of the
                              # last one, and the f32 noise of scores of order 0.1
HTTP_TIMEOUT_S = 30
FUSED_LOSS_RTOL = 2e-5        # fused vs per-layer trainer, per-step loss (tests/test_spmm.py:214)
FUSED_PARAMS_ATOL = 1e-6      # and their params after the 20 steps
LAYOUT_FWD_ATOL = 1e-5        # fused / chunked vs per-layer forward: same sums, other order
LAYOUT_GRAD_ATOL = 1e-4       # their gradients of sum(out**2)
LAYOUT_BF16_TOL = 0.05        # fused bf16 storage vs f32, rtol and atol (tests/test_spmm.py:473)
CHUNK_BF16_RTOL = 2e-2        # chunked bf16 vs f32, x max|f32| (tests/test_spmm.py:251)
LAYOUT_CHUNKS = (2, 3, 4)
KNEE_SCAN_SIZES = (72_000, 180_000, 400_000, 1_000_000)   # the first: the books bundle
KNEE_SCAN_BUDGET_S = 60.0
BF16_LOSS_RTOL = 2e-2         # bf16 vs f32 training, per-step loss
TEST_MODE_RTOL = 1e-6         # test mode vs Trainer.validate: the same sums
NATIVE_RTOL = 1e-6            # native vs numpy weights: ~2 ULP (tests/test_native.py)
SCALE_DIM, SCALE_LAYERS = 256, 4            # BASELINE.json configs[4], the scaled LightGCN
SCALE_WIDTHS = (4, 50, 132, 200, 256)       # K3 against plain at each, both layouts and dtypes
SCALE_NORTH_STAR_STEPS = 3
SCALE_PARAMS_ATOL = 1e-5                    # tile vs ELL tables after the 20 steps at d = 256
CLI_GRID_EPOCHS = 20                        # phase 14's run of the grid runner
REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = {
    "compressed": "gcn_recommendation_tpu_torch/csrc/tile_gather_spmm.cu",
    "dense": "gcn_recommendation_tpu_torch/csrc/tile_spmm.cu",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")
    print(f"ok: {what}", flush=True)


def _quant_v1(x, seed: int, out=None):
    """The first version of the quantizer kernel, through its entry point
    (nothing on a path calls it)."""
    q, scales = quant._empty_out(x) if out is None else out
    err = _build.load_library("quant_int8").quantize_rows_int8_launch_v1(
        x.data_ptr(), q.data_ptr(), scales.data_ptr(), x.shape[0], x.shape[1], seed,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"chip_smoke FAILED: v1 quantizer launch, CUDA error {err}")
    return q, scales


def _quant_bound_ms(n: int, d: int):
    """Least time for one quantizer call: x read once, q and scales written
    once, against ``QUANT_OPS_PER_ELEMENT`` operations an element."""
    nbytes = 4 * n * d + n * d + 4 * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = QUANT_OPS_PER_ELEMENT * n * d / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes


def phase_kernel_check(dev):
    """Bit-equality of the quantizer kernel with its plain versions, in
    both modes and through both entry points, and its times beside the
    bound, the first version's and the launch floor."""
    gen = torch.Generator(device=dev).manual_seed(0)
    lib = _build.load_library("quant_int8")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    record = {
        "name": "quantize_rows_int8",
        "route": "cuda",
        "source": "gcn_recommendation_tpu_torch/csrc/quant_int8.cu",
        "replaces": "gcn_recommendation_tpu/ops/quant.py:35",
        "library_ms": None,  # no PyTorch call does stochastic int8 rounding
    }
    for n, d in QUANT_CHECK_SHAPES:
        x = torch.randn((n, d), generator=gen, device=dev) * 0.05
        seed = 1234 + n
        q_p, s_p = quant._quantize_rows_int8_reference(x, seed=seed)
        got = {"stochastic": quant.quantize_rows_int8(x, seed=seed),
               "stochastic, first version": _quant_v1(x, seed)}
        torch.cuda.synchronize()
        err = 0.0
        for name, (q_k, s_k) in got.items():
            err = max(err, (q_k.int() - q_p.int()).abs().max().item(),
                      (s_k - s_p).abs().max().item())
            check(torch.equal(q_k, q_p) and torch.equal(s_k, s_p),
                  f"quantizer kernel ({name}) bit-equal to plain at [{n}, {d}]")
        del q_p, s_p, got
        q_p, s_p = quant._quantize_users_int8_reference(x)
        q_k, s_k = quant.quantize_users_int8(x)
        torch.cuda.synchronize()
        err = max(err, (q_k.int() - q_p.int()).abs().max().item(),
                  (s_k - s_p).abs().max().item())
        check(torch.equal(q_k, q_p) and torch.equal(s_k, s_p),
              f"quantizer kernel (nearest) bit-equal to plain at [{n}, {d}]")
        del q_p, s_p, q_k, s_k

        out = quant._empty_out(x)
        bound_ms, bound_by, nbytes = _quant_bound_ms(n, d)
        if (n, d) == (20_000, 64):  # the catalog shape of the path
            # the floor: a kernel that does nothing on the same grid (32 rows a block
            # of 256 threads at d = 64); the stream is looked up inside the call,
            # which runs under the graph's capture stream
            blocks = min(-(-n // 32), 8 * sms)
            record.update({
                "shape": [n, d],
                "max_abs_err": err,
                "max_abs_diff_vs_plain": err,
                # on the card (CUDA graph replay), into the caller's buffers
                "ms": graph_ms(lambda: quant.quantize_rows_int8(x, seed=seed, out=out)),
                # one eager call in a loop: host-bound when short
                "call_ms": cuda_ms(lambda: quant.quantize_rows_int8(x, seed=seed)),
                "call_ms_out": cuda_ms(lambda: quant.quantize_rows_int8(x, seed=seed, out=out)),
                "plain_ms": cuda_ms(
                    lambda: quant._quantize_rows_int8_reference(x, seed=seed)),
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "v1_ms": graph_ms(lambda: _quant_v1(x, seed, out)),
                "floor_ms": graph_ms(lambda: lib.quant_int8_empty_launch(
                    blocks, 256, torch.cuda.current_stream().cuda_stream)),
                "floor_grid": [blocks, 256],
            })
        elif (n, d) == (2_000_000, 64):  # where the bytes decide, not the floor
            ms = graph_ms(lambda: quant.quantize_rows_int8(x, seed=seed, out=out))
            record.update({
                "shape_large": [n, d],
                "ms_large": ms,
                "call_ms_large": cuda_ms(lambda: quant.quantize_rows_int8(x, seed=seed, out=out)),
                "v1_ms_large": graph_ms(lambda: _quant_v1(x, seed, out)),
                "nearest_ms_large": graph_ms(lambda: quant.quantize_users_int8(x, out=out)),
                "bound_ms_large": bound_ms,
                # the nearest mode moves the same bytes with fewer operations
                "nearest_bound_ms_large": bound_ms,
                "gb_per_s_large": nbytes / ms / 1e6,
                "share_of_bound_large": bound_ms / ms,
            })
        elif (n, d) == (200_000, 256):  # the north-star catalog of phase 13
            ms = graph_ms(lambda: quant.quantize_rows_int8(x, seed=seed, out=out))
            record.update({
                "shape_catalog_d256": [n, d],
                "ms_catalog_d256": ms,
                "call_ms_catalog_d256": cuda_ms(lambda: quant.quantize_rows_int8(x, seed=seed)),
                "nearest_ms_catalog_d256": graph_ms(
                    lambda: quant.quantize_users_int8(x, out=out)),
                "plain_ms_catalog_d256": cuda_ms(
                    lambda: quant._quantize_rows_int8_reference(x, seed=seed), reps=5),
                "nearest_plain_ms_catalog_d256": cuda_ms(
                    lambda: quant._quantize_users_int8_reference(x), reps=5),
                "bound_ms_catalog_d256": bound_ms,
                "bound_by_catalog_d256": bound_by,
                "gb_per_s_catalog_d256": nbytes / ms / 1e6,
            })
        elif (n, d) == (1_024, 64):  # the largest request, nearest mode
            record.update({
                "shape_nearest": [n, d],
                "nearest_ms": graph_ms(lambda: quant.quantize_users_int8(x, out=out)),
                "nearest_call_ms": cuda_ms(lambda: quant.quantize_users_int8(x, out=out)),
                # the eager PyTorch launches that the nearest mode replaces
                "nearest_plain_ms": cuda_ms(lambda: quant._quantize_users_int8_reference(x)),
                "nearest_bound_ms": bound_ms,
                "v1_ms_request_shape": graph_ms(lambda: _quant_v1(x, seed, out)),
            })
        del x, out
    print("quantizer: " + json.dumps(record), flush=True)
    return record


def _seen_sets(bundle, users):
    f_ptr, f_items = membership_arrays(
        bundle.train.user_idx, bundle.train.item_idx, bundle.num_users
    )
    return [set(f_items[f_ptr[u] : f_ptr[u + 1]].tolist()) for u in users]


def _same_topk(a, b, tol: float) -> bool:
    """Equal top-k lists up to the order of near-tied scores: values
    within ``tol`` everywhere, and wherever the items differ the score
    ties another entry of the row within ``tol``."""
    (va, ia), (vb, ib) = a, b
    if va.shape != vb.shape or not np.allclose(va, vb, rtol=0, atol=tol):
        return False
    for r in range(va.shape[0]):
        for j in np.flatnonzero(ia[r] != ib[r]):
            gaps = np.abs(va[r] - va[r, j])
            gaps[j] = np.inf
            if gaps.min() > tol:
                return False
    return True


def books_bundle():
    """bench.py's books-shaped bundle, and the host seconds it took."""
    t0 = time.perf_counter()
    bundle = synthetic_bundle(50_000, 20_000, 2_000, mean_degree=28.0, core=8, seed=42)
    g = bundle.graph
    bundle_s = time.perf_counter() - t0
    print(f"bundle: {g.num_nodes} nodes, {g.nnz} nonzeros, "
          f"{len(g.buckets)} ELL buckets, hub matrix {tuple(g.dense_mat.shape)}, "
          f"built in {bundle_s:.1f} s on the host", flush=True)
    return bundle, bundle_s


def _user_quantizer_ab(rq, requests):
    """Measurement only: an int8 request with its users quantized by the
    kernel's nearest mode (one launch) against the same request with the
    plain PyTorch lines in its place (eight eager launches), in turns
    (kernel, eager, eager, kernel) at 1 and at 64 users."""
    kernel = quant.quantize_users_int8

    def eager(x, out=None):
        return quant._write_out(quant._quantize_users_int8_reference(x), x, out)

    out = {}
    try:
        for u in (requests[0], requests[2]):
            times = {"kernel": [], "eager": []}
            for name, fn in (("kernel", kernel), ("eager", eager), ("eager", eager),
                             ("kernel", kernel)):
                quant.quantize_users_int8 = fn
                times[name].append(host_ms(lambda: rq.recommend(u, k=K), reps=30))
            for name, t in times.items():
                out[f"int8_b{len(u)}_{name}_user_quantizer_ms"] = statistics.fmean(t)
    finally:
        quant.quantize_users_int8 = kernel
    return out


def phase_path(dev, bundle, bundle_s):
    """Drive the serving path and check it; returns the launch counts
    of the main path."""
    g = bundle.graph
    cfg = Config(embedding_dim=64, n_layers=3)
    model = get_model("LightGCN")(
        bundle.num_users, bundle.num_items, bundle.num_brands, cfg, device=dev
    )
    params = model.init(torch.Generator().manual_seed(42))

    rng = np.random.default_rng(0)
    active = np.unique(bundle.train.user_idx)
    requests = [rng.choice(active, n, replace=False).astype(np.int32) for n in REQUEST_SIZES]

    # --- the main path: counts from 0, read right after ---
    torch.cuda.reset_peak_memory_stats()
    quant.quantize_rows_int8.launches = 0
    quant.quantize_users_int8.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rf = Retriever.from_params(model, params, bundle)
    torch.cuda.synchronize()
    load_f32_ms = (time.perf_counter() - t0) * 1e3
    launches_f32 = quant.quantize_rows_int8.launches
    t0 = time.perf_counter()
    rq = Retriever.from_params(model, params, bundle, quantize=True)
    torch.cuda.synchronize()
    load_int8_ms = (time.perf_counter() - t0) * 1e3
    launches_int8 = quant.quantize_rows_int8.launches - launches_f32
    results = {}
    for name, r in (("f32", rf), ("int8", rq)):
        single = [r.recommend(u, k=K) for u in requests]
        piped = r.recommend_pipelined(requests, k=K)
        many = r.recommend_many(requests, k=K)
        results[name] = (single, piped, many)
    launches = {"quantize_rows_int8": quant.quantize_rows_int8.launches,
                "quantize_users_int8": quant.quantize_users_int8.launches}
    # --- end of the main path ---

    check(launches_f32 == 0, "f32 load launches no quantizer")
    check(launches_int8 == 1, f"int8 load launched the quantizer ({launches_int8}x)")
    # recommend and recommend_pipelined dispatch once a request, recommend_many once in all
    want_nearest = 2 * len(requests) + 1
    check(launches["quantize_users_int8"] == want_nearest,
          f"int8 requests launched the nearest mode {launches['quantize_users_int8']}x = "
          f"1 per dispatch ({want_nearest})")

    for name, (single, piped, many) in results.items():
        for u, (v, i) in zip(requests, single):
            check(v.shape == (len(u), K) and np.isfinite(v).all(),
                  f"{name}: {len(u)}-user request gives finite [{len(u)}, {K}] scores")
            seen = _seen_sets(bundle, u)
            check(all(not (set(i[j].tolist()) & seen[j]) for j in range(len(u))),
                  f"{name}: {len(u)}-user request returns no seen item")
        check(all(_same_topk(a, b, 1e-5) for a, b in zip(single, piped)),
              f"{name}: recommend_pipelined equals recommend")
        check(all(_same_topk(a, b, 1e-5) for a, b in zip(single, many)),
              f"{name}: recommend_many equals recommend")

    i_f, i_q = results["f32"][0][-1][1], results["int8"][0][-1][1]
    overlap = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(i_f, i_q)]))
    check(overlap >= MIN_INT8_OVERLAP,
          f"int8 top-{K} overlaps f32 top-{K} by {overlap:.4f} over {len(i_f)} users")

    # propagation against the COO oracle, and its time
    with torch.no_grad():
        graph = to_device_graph(g, include_coo=True, device=dev, fuse_layers=False)
        ell = torch.cat([t for t in model(graph, path="ell")[:3]])
        coo = torch.cat([t for t in model(graph, path="coo")[:3]])
        diff = (ell - coo).abs().max().item()
        check(diff <= PROPAGATION_ATOL,
              f"ELL propagation matches propagate_coo (max abs diff {diff:.3g})")
        propagate_ms = cuda_ms(lambda: model(graph), reps=5, warmup=2)
        coo_ms = cuda_ms(lambda: model(graph, path="coo"), reps=5, warmup=2)

    latency = {}
    for name, r in (("f32", rf), ("int8", rq)):
        for u in requests:
            latency[f"{name}_b{len(u)}_ms"] = host_ms(lambda: r.recommend(u, k=K))
        latency[f"{name}_many_ms"] = host_ms(lambda: r.recommend_many(requests, k=K))
        latency[f"{name}_pipelined_ms"] = host_ms(
            lambda: r.recommend_pipelined(requests, k=K))
    latency.update(_user_quantizer_ab(rq, requests))
    meas = {
        "bundle_host_s": bundle_s,
        "load_f32_ms": load_f32_ms,
        "load_int8_ms": load_int8_ms,
        "forward_3_layers_ms": propagate_ms,
        "forward_3_layers_coo_ms": coo_ms,
        "int8_overlap_top20": overlap,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        **latency,
    }
    print("path: " + json.dumps(meas), flush=True)
    return launches


def _tile_bound_ms(tiles, n: int, d: int):
    """Least time for one ``tile_matvec`` on the card: each input that the
    tiles' layout holds read once (dense: tile values, column ids, step
    pointers; compressed: edge sources, weights, row pointers; both: the
    [n, d] embedding), the output written once, against the operations this
    data needs (two per nonzero tile value and column, at the bf16
    tensor-core rate for dense bf16 tiles, else at the float32 rate outside
    the tensor cores).  Also returns the time of the dense tile products
    alone (the work the TPU kernel's formulation does)."""
    a = tiles.values
    if tiles.layout == "dense":
        nbytes = a.numel() * a.element_size() + 4 * tiles.num_tiles + 4 * (tiles.n_row_blocks + 1)
        nonzeros = int((a != 0).sum())
    else:
        nbytes = a.numel() * (a.element_size() + 4) + 4 * tiles.edge_row_ptr.numel()
        nonzeros = a.numel()
    nbytes += 4 * n * d + 4 * tiles.n_row_blocks * TILE * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # dense bf16 tiles meet a bf16-rounded window: exact products on the tensor cores
    on_tensor_cores = tiles.layout == "dense" and a.dtype == torch.bfloat16
    rate = BF16_OPS_PER_S if on_tensor_cores else FP32_OPS_PER_S
    ops_ms = 2 * nonzeros * d / rate * 1e3
    dense_ms = 2 * tiles.num_tiles * TILE * TILE * d / rate * 1e3
    bound = max(bytes_ms, ops_ms)
    return bound, "bytes" if bytes_ms >= ops_ms else "operations", dense_ms


def _tile_csr(part, n: int, dev):
    """The tile edges as one CSR matrix [R*128, n] (the library yardstick)."""
    t, i, j = np.nonzero(part.tile_a)
    rows = part.step_row[t // part.tiles_per_step].astype(np.int64) * TILE + i
    cols = part.tile_col[t].astype(np.int64) * TILE + j
    coo = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(part.tile_a[t, i, j]),
        (part.n_row_blocks * TILE, n),
    )
    return coo.coalesce().to(dev).to_sparse_csr()


def _check_tiles(tiles, emb, what: str, scaled: bool = False, k=None) -> float:
    """One kernel against the plain version of its layout on ``tiles``;
    returns the max abs diff.  f32 tiles are held to 1e-5 absolute unless
    ``scaled`` (sums that pass 1: the experiment's limit), bf16 tiles to
    1e-5 * max(1, max|plain|).  ``k``: a kernel output already in hand
    (else the kernel is launched here)."""
    if k is None:
        k = block_spmm.tile_matvec(emb, tiles)
    p = block_spmm._tile_matvec_reference(emb, tiles)
    torch.cuda.synchronize()
    err = (k - p).abs().max().item()
    scale = p.abs().max().item()
    name = f"tile_matvec {tiles.layout} {str(tiles.values.dtype).replace('torch.', '')}"
    if tiles.values.dtype == torch.float32 and not scaled:
        check(err <= TILE_F32_ATOL, f"{name} kernel matches plain on {what} (max abs diff {err:.3g})")
    else:
        check(err <= TILE_BF16_RTOL * max(1.0, scale),
              f"{name} kernel matches plain on {what} "
              f"(max abs diff {err:.3g}, max|plain| {scale:.3g})")
    return err


def _check_tile_kernels(part, n: int, d: int, dev, what: str):
    """Both kernels vs plain on one partition, f32 and bf16 tiles; returns
    {(layout, dtype): (tiles, max abs diff)} and the embedding."""
    gen = torch.Generator(device=dev).manual_seed(d)
    emb = torch.randn((n, d), generator=gen, device=dev)
    out = {}
    for layout in block_spmm.LAYOUTS:
        for dtype in (torch.float32, torch.bfloat16):
            tiles = block_spmm.to_device_tiles(part, tile_dtype=dtype, device=dev, layout=layout)
            check(tiles.layout == layout and (tiles.tile_a is None) == (layout == "compressed"),
                  f"{layout} tiles of {what} hold {'no ' if layout == 'compressed' else ''}tile_a")
            out[(layout, dtype)] = (tiles, _check_tiles(tiles, emb, what))
    return out, emb


def _tiles_nbytes(tiles) -> int:
    """Device bytes of the arrays ``tile_matvec`` reads from ``tiles``."""
    arrays = [tiles.tile_a, tiles.edge_row_ptr, tiles.edge_src, tiles.edge_w]
    if tiles.plan is not None:
        p = tiles.plan
        arrays += [p.list_tile, p.list_col, p.segments, p.block_seg_ptr, p.reduce_rows,
                   p.reduce_ptr]
    return sum(a.numel() * a.element_size() for a in arrays if a is not None)


def phase_tile_kernel_check(dev, bundle):
    """Both tile kernels against the plain version, the gradient against
    the ELL path, and the times beside the bounds and the library call."""
    g = bundle.graph
    n, d = g.num_nodes, 64
    t0 = time.perf_counter()
    part = partition_tiles(g, min_fill=64, tiles_per_step=8)
    partition_s = time.perf_counter() - t0
    check(part is not None, "the books bundle has qualifying tiles at min_fill 64")
    real = part.tile_a.reshape(part.num_tiles, -1).any(axis=1)
    per_rb = np.bincount(part.step_row[np.arange(part.num_tiles) // part.tiles_per_step][real],
                         minlength=part.n_row_blocks)
    fill = float((part.tile_a != 0).sum()) / part.tile_a.size
    edges_per_row = np.diff(part.edge_row_ptr)
    stats = {
        "partition_s": partition_s, "tiles": part.num_tiles, "real_tiles": int(real.sum()),
        "steps": len(part.step_row), "row_blocks": part.n_row_blocks,
        "covered_edges": part.covered_edges, "nnz": g.nnz,
        "tile_bytes_f32": part.tile_a.nbytes, "tile_fill": fill,
        "tiles_per_row_block_max": int(per_rb.max()),
        "tiles_per_row_block_mean": float(per_rb.mean()),
        "edges_per_compact_row_max": int(edges_per_row.max()),
        "edges_per_compact_row_mean": float(edges_per_row.mean()),
        "residual_buckets": len(part.residual.buckets),
    }
    print("partition: " + json.dumps(stats), flush=True)

    upload = {}
    for layout in ("auto", "dense"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shipped = block_spmm.to_device_tiles(part, device=dev, layout=layout)
        torch.cuda.synchronize()
        upload[shipped.layout] = (time.perf_counter() - t0, _tiles_nbytes(shipped))
        if layout == "auto":
            check(shipped.layout == "compressed" and shipped.tile_a is None,
                  f"layout auto picks compressed on the books partition (fill {fill:.4g} < "
                  f"{block_spmm.AUTO_DENSE_MIN_FILL})")
        del shipped
    t0 = time.perf_counter()
    to_device_graph(part.residual, device=dev, fuse_layers=False)
    torch.cuda.synchronize()
    print("upload: tiles " + ", ".join(
        f"{k} {s:.3f} s ({b / 1e6:.1f} MB on the card)" for k, (s, b) in upload.items())
        + f", residual graph {time.perf_counter() - t0:.3f} s", flush=True)

    checked, emb = _check_tile_kernels(part, n, d, dev, f"the books partition (d={d})")

    small = synthetic_bundle(1000, 700, 30, mean_degree=20.0, core=4, seed=1).graph
    small_part = partition_tiles(small, min_fill=16, tiles_per_step=8)
    check(small.num_nodes % TILE != 0 and small_part is not None,
          f"ragged partition: {small.num_nodes} nodes")
    _check_tile_kernels(small_part, small.num_nodes, 48, dev,
                        f"a ragged partition ({small.num_nodes} nodes, d=48)")

    # gradient of sum(out**2): tile partition (auto layout) vs the plain ELL path
    tiles = block_spmm.to_device_tiles(part, device=dev)
    res = to_device_graph(part.residual, device=dev, fuse_layers=False)
    full = to_device_graph(g, device=dev, fuse_layers=False)
    x = emb.clone().requires_grad_(True)
    (g_tile,) = torch.autograd.grad(
        (block_spmm.propagate_ell_tiles(x, res, tiles) ** 2).sum(), x)
    (g_ell,) = torch.autograd.grad((propagate_ell(
        x, full.bucket_nbr_idx, full.bucket_nbr_w, full.gather_idx, full.dense_mat) ** 2).sum(),
        x)
    gerr = (g_tile - g_ell).abs().max().item()
    check(gerr <= TILE_GRAD_ATOL,
          f"propagate_ell_tiles gradient on the {tiles.layout} layout matches the ELL gradient "
          f"(max abs diff {gerr:.3g})")

    csr = _tile_csr(part, n, dev)
    lib = torch.sparse.mm(csr, emb)
    ker = block_spmm.tile_matvec(emb, tiles)
    torch.cuda.synchronize()
    lerr = (lib - ker).abs().max().item()
    check(lerr <= TILE_F32_ATOL, f"torch.sparse.mm of the tile edges equals the kernel "
                                 f"(max abs diff {lerr:.3g})")

    def times(layout, dtype):
        t = checked[(layout, dtype)][0]
        return (graph_ms(lambda: block_spmm.tile_matvec(emb, t)),
                cuda_ms(lambda: block_spmm.tile_matvec(emb, t)))

    main = checked[("compressed", torch.float32)]
    ms, call_ms = times("compressed", torch.float32)
    bf16_ms, bf16_call_ms = times("compressed", torch.bfloat16)
    dense_ms, dense_call_ms = times("dense", torch.float32)
    dense_bf16_ms, _ = times("dense", torch.bfloat16)
    dense_tiles = checked[("dense", torch.float32)][0]
    plain_ms = cuda_ms(lambda: block_spmm._tile_matvec_reference(emb, main[0]))
    dense_plain_ms = cuda_ms(lambda: block_spmm._tile_matvec_reference(emb, dense_tiles))
    library_ms = graph_ms(lambda: torch.sparse.mm(csr, emb))
    library_call_ms = cuda_ms(lambda: torch.sparse.mm(csr, emb))
    bound_ms, bound_by, dense_products_ms = _tile_bound_ms(main[0], n, d)
    dense_bound_ms, dense_bound_by, _ = _tile_bound_ms(dense_tiles, n, d)
    bf16_bound_ms, _, _ = _tile_bound_ms(checked[("compressed", torch.bfloat16)][0], n, d)
    dense_bf16_bound_ms, _, _ = _tile_bound_ms(checked[("dense", torch.bfloat16)][0], n, d)
    return {
        "name": "tile_matvec",
        "route": "cuda",
        "layout": "compressed",
        "source": KERNEL_SOURCE["compressed"],
        "replaces": "gcn_recommendation_tpu/ops/block_spmm.py:79",
        "shape": [part.num_tiles, TILE, TILE, d],
        "edges": part.covered_edges,
        "max_abs_err": main[1],
        "max_abs_diff_vs_plain": main[1],
        "ms": ms,                      # on the card (CUDA graph replay)
        "call_ms": call_ms,            # one eager call in a loop: host-bound when short
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,      # torch.sparse.mm, CSR of the tile edges, on the card
        "library_call_ms": library_call_ms,
        "bf16_ms": bf16_ms,
        "bf16_call_ms": bf16_call_ms,
        "bf16_bound_ms": bf16_bound_ms,
        "dense_products_ms": dense_products_ms,
        # the same partition through the other kernel
        "dense_layout_source": KERNEL_SOURCE["dense"],
        "dense_layout_max_abs_err": checked[("dense", torch.float32)][1],
        "dense_layout_ms": dense_ms,
        "dense_layout_call_ms": dense_call_ms,
        "dense_layout_bf16_ms": dense_bf16_ms,
        "dense_layout_plain_ms": dense_plain_ms,
        "dense_layout_bound_ms": dense_bound_ms,
        "dense_layout_bound_by": dense_bound_by,
        "dense_layout_bf16_bound_ms": dense_bf16_bound_ms,
    }


def _profile_steps(trainer, users, pos, neg, steps: int = 5):
    """Device time by kernel over ``steps`` training steps
    (``torch.profiler``), in ms per step, and the device's idle share of
    the window (one stream: 1 - kernel time / wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a throwaway profile first: the first one of a process sets the tracer up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trainer.train_step(users[0], pos[0], neg[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            trainer.train_step(users[s], pos[s], neg[s])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.events():  # device-side events only, as the profiler's own total
        if evt.device_type == DeviceType.CUDA and not evt.is_user_annotation:
            name = evt.name[:80]
            kernels[name] = kernels.get(name, 0.0) + evt.self_device_time_total / 1e3 / steps
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
                   for e in prof.key_averages()), key=lambda kv: -kv[1])[:10]
    return {"wall_ms_per_step": wall_ms / steps, "device_ms_per_step": busy,
            "idle_share": 1.0 - busy * steps / wall_ms if busy else None,
            "top_kernels_ms_per_step": top,
            "top_host_self_ms_and_calls_per_step": {k: [ms, n] for k, ms, n in host}}


def _twin_trainers(dev, bundle, tmp, model_name, content=None, dim=64, layers=3):
    """A ``tile_spmm`` trainer and its ELL twin from the same params;
    returns ({True: tile, False: ell}, build seconds of each)."""
    trainers, build_s = {}, {}
    params = None
    for tile in (True, False):
        cfg = Config(embedding_dim=dim, n_layers=layers, batch_size=2048, tile_spmm=tile,
                     tile_min_fill=64, checkpoint_dir=tmp, results_dir=tmp,
                     model_name=model_name)
        model = get_model(model_name)(
            bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
            pretrained_item_emb=content, device=dev)
        if params is None:
            params = model.init(torch.Generator().manual_seed(42))
        else:
            model.load_params(params)
        t0 = time.perf_counter()
        trainers[tile] = Trainer(cfg, model, bundle)
        torch.cuda.synchronize()
        build_s[tile] = time.perf_counter() - t0
    graph = trainers[True].graph
    check(isinstance(graph, block_spmm.TiledDeviceGraph) and graph.tiles.layout == "compressed"
          and graph.tiles.tile_a is None,
          f"{model_name}: the tile trainer runs the tiles, in the compressed layout")
    return trainers, build_s


def _twin_batches(dev, tr, bundle):
    """The same ``TRAIN_STEPS`` batches and negatives for both twins."""
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = epoch_batches(gen, tr.n_train, 2048, dev)[:TRAIN_STEPS]
    users, pos = tr.train_users[idx], tr.train_items[idx]
    neg = sample_negatives(gen, users, tr.pos_keys, num_items=bundle.num_items)
    return users, pos, neg


def _twin_steps(trainers, users, pos, neg):
    """``TRAIN_STEPS`` steps on each twin; per-step losses and ms per step
    (host clock around synchronised work, the first step left out)."""
    losses, step_ms = {}, {}
    for tile in (True, False):
        t = trainers[tile]
        out = [t.train_step(users[0], pos[0], neg[0])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, TRAIN_STEPS):
            out.append(t.train_step(users[s], pos[s], neg[s]))
        torch.cuda.synchronize()
        step_ms[tile] = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
        losses[tile] = torch.stack(out).cpu().numpy()
    return losses, step_ms


def _check_twin_run(name, losses, launches, recall, ndcg, layers=3):
    """Finite falling losses, the two paths together, the launch count
    (2 a layer a step, 1 a layer for the validation forward); returns the
    largest relative loss gap."""
    for tile, path in ((True, "tile"), (False, "ELL")):
        lo = losses[tile]
        check(np.isfinite(lo).all(), f"{name} {path} path: {TRAIN_STEPS} finite step losses")
        check(lo[-5:].mean() < lo[:5].mean(),
              f"{name} {path} path: loss falls ({lo[:5].mean():.5f} -> {lo[-5:].mean():.5f})")
    rel = np.abs(losses[True] - losses[False]) / np.abs(losses[False])
    check(rel.max() <= TRAIN_LOSS_RTOL,
          f"{name}: tile and ELL step losses agree (max rel diff {rel.max():.3g})")
    want = 2 * layers * TRAIN_STEPS + layers
    check(launches == want,
          f"{name}: tile_matvec launched {launches}x = {2 * layers} per step x {TRAIN_STEPS} "
          f"+ {layers} for validation")
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in (recall, ndcg)),
          f"{name}: validation Recall@20 {recall:.4f}, NDCG@20 {ndcg:.4f}")
    return float(rel.max())


class PerLayerTrainer(Trainer):
    """The single-device trainer on the per-layer ELL path, without the
    merge-skip views: phase 6's twin of the fused default and phase 11's
    reference."""

    graph_fuse_layers = False


def _graph_gib(graph) -> float:
    """Device GiB of every tensor a device graph holds."""
    def walk(x):
        if torch.is_tensor(x):
            return x.numel() * x.element_size()
        if isinstance(x, (tuple, list)):
            return sum(walk(v) for v in x)
        if dataclasses.is_dataclass(x):
            return sum(walk(getattr(x, f.name)) for f in dataclasses.fields(x))
        return 0
    return walk(graph) / 2**30


def _steps_alone(dev, bundle, tmp, cls, users, pos, neg, **cfg_kw):
    """A ``cls`` trainer built from the seed-42 LightGCN params, then
    ``TRAIN_STEPS`` steps (``_mesh_steps``): (losses, ms per step, GiB it
    holds at the peak of the steps, graph and state included, the
    trainer)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated() / 2**30
    cfg = Config(embedding_dim=64, n_layers=3, batch_size=2048, checkpoint_dir=tmp,
                 results_dir=tmp, **cfg_kw)
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    model.init(torch.Generator().manual_seed(42))
    tr = cls(cfg, model, bundle)
    losses, ms, peak = _mesh_steps(tr, users, pos, neg)
    return losses, ms, peak - base, tr


def phase_train(dev, bundle):
    """Drive the training path with tiles and its ELL twin (fused, the
    default), then a per-layer twin; returns the tile kernel's launches on
    the path, the ms per step of the first two twins and what later phases
    compare with (the batches, each ELL twin's losses, the fused trainer's
    checkpoint and its step time and memory)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    trainers, build_s = _twin_trainers(dev, bundle, tmp, "LightGCN")
    tr = trainers[True]
    users, pos, neg = _twin_batches(dev, tr, bundle)

    # --- the main path: counts from 0, read right after ---
    torch.cuda.reset_peak_memory_stats()
    block_spmm.tile_matvec.launches = 0
    losses, step_ms = _twin_steps(trainers, users, pos, neg)
    recall, ndcg = tr.validate()
    launches = {"tile_matvec": block_spmm.tile_matvec.launches}
    # --- end of the main path ---

    rel_max = _check_twin_run("LightGCN", losses, launches["tile_matvec"], recall, ndcg)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(trainers[False].graph.fused,
          "the default Trainer's ELL graph carries the merge-skip views")

    # the per-layer twin and the fused default, each built from the same
    # params (seed 42) and run alone on the same 20 batches: losses, ms per
    # step, and the memory each takes from its build on
    pl_losses, pl_ms, pl_peak, per_layer = _steps_alone(
        dev, bundle, tmp, PerLayerTrainer, users, pos, neg)
    check(not per_layer.graph.fused, "graph_fuse_layers=False builds no merge-skip views")
    pl_params = {k: v.clone() for k, v in per_layer.model.params().items()}
    pl_graph_gib = _graph_gib(per_layer.graph)
    print("profile_ell_per_layer: " + json.dumps(_profile_steps(per_layer, users, pos, neg)),
          flush=True)
    del per_layer
    f_losses, fused_ms, fused_peak, fused = _steps_alone(dev, bundle, tmp, Trainer, users,
                                                         pos, neg)
    fused_params = {k: v.clone() for k, v in fused.model.params().items()}
    fused_graph_gib = _graph_gib(fused.graph)
    fused_dir = tempfile.mkdtemp(prefix="chip_smoke_fused_")
    fused.save_checkpoint(fused_dir, "best", 1, 0.0)
    del fused
    check(np.allclose(f_losses, losses[False], rtol=1e-6, atol=0),
          "the fused trainer run alone repeats the ELL twin's 20 losses")
    rel = np.abs(f_losses - pl_losses) / np.abs(pl_losses)
    check(np.isfinite(pl_losses).all() and rel.max() <= FUSED_LOSS_RTOL,
          f"fused and per-layer trainers: 20 step losses within rtol {FUSED_LOSS_RTOL} "
          f"(max rel diff {rel.max():.3g})")
    fused_diff = max((fused_params[k] - pl_params[k]).abs().max().item() for k in pl_params)
    check(fused_diff <= FUSED_PARAMS_ATOL,
          f"fused and per-layer trainers: final params within {FUSED_PARAMS_ATOL} "
          f"(max abs diff {fused_diff:.3g})")

    tr.save_checkpoint(tmp, "best", 1, recall)
    served = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands,
                                   Config(embedding_dim=64, n_layers=3), device=dev)
    r = Retriever.from_params(served, ckpt.load_params(tmp, device=dev), bundle)
    users64 = np.unique(bundle.train.user_idx)[:64]
    v, i = r.recommend(users64, k=K)
    check(v.shape == (64, K) and np.isfinite(v).all(),
          "the training checkpoint serves a 64-user request through Retriever")

    def fwd_bwd(t):
        fu, fi, fb, _, _ = t.model(t.graph)
        (fu.sum() + fi.sum() + fb.sum()).backward()

    prop_ms = {tile: cuda_ms(lambda t=trainers[tile]: fwd_bwd(t), reps=5, warmup=2)
               for tile in (True, False)}
    meas = {
        "steps": TRAIN_STEPS,
        "batch": 2048,
        "ms_per_step_tile": step_ms[True],
        "ms_per_step_ell": step_ms[False],
        "ms_per_step_fused": fused_ms,
        "ms_per_step_per_layer": pl_ms,
        "examples_per_s_tile": 2048 / step_ms[True] * 1e3,
        "examples_per_s_ell": 2048 / step_ms[False] * 1e3,
        "trainer_build_s_tile": build_s[True],
        "trainer_build_s_ell": build_s[False],
        "propagation_fwd_bwd_ms_tile": prop_ms[True],
        "propagation_fwd_bwd_ms_ell": prop_ms[False],
        "loss_first_tile": float(losses[True][0]),
        "loss_last_tile": float(losses[True][-1]),
        "loss_max_rel_diff": rel_max,
        "fused_vs_per_layer_loss_max_rel_diff": float(rel.max()),
        "fused_vs_per_layer_params_max_abs_diff": fused_diff,
        # after 20 Adam steps: how far apart the two paths' tables are
        "params_max_abs_diff": max(
            (trainers[True].model.params()[k] - trainers[False].model.params()[k])
            .abs().max().item() for k in ("user_embedding", "item_embedding")),
        "val_recall20": recall,
        "val_ndcg20": ndcg,
        "peak_mem_gib": peak_gib,
        # each trainer alone: what it allocates from its build through 20 steps
        "peak_mem_gib_fused": fused_peak,
        "peak_mem_gib_per_layer": pl_peak,
        "graph_gib_fused": fused_graph_gib,
        "graph_gib_per_layer": pl_graph_gib,
    }
    print("train: " + json.dumps(meas), flush=True)
    for tile, name in ((True, "tile"), (False, "ell")):
        prof = _profile_steps(trainers[tile], users, pos, neg)
        print(f"profile_{name}: " + json.dumps(prof), flush=True)
    _min_fill_scan(dev, bundle, tmp, trainers[False], users, pos, neg)
    ref = {"users": users, "pos": pos, "neg": neg, "fused_losses": f_losses,
           "per_layer_losses": pl_losses, "fused_ms": fused_ms, "fused_peak_gib": fused_peak,
           "fused_dir": fused_dir}
    return launches, step_ms, ref


def _min_fill_scan(dev, bundle, tmp, ell_trainer, users, pos, neg):
    """Measurement only: ms per step of a tile trainer at each
    ``tile_min_fill`` of ``SCAN_MIN_FILLS`` beside the ELL trainer's, all
    on the same batches, the first step of each left out.  Stops starting
    new trainers once ``MIN_FILL_SCAN_BUDGET_S`` is spent."""
    t_start = time.perf_counter()

    def steps_ms(t):
        t.train_step(users[0], pos[0], neg[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(1, TRAIN_STEPS):
            t.train_step(users[s], pos[s], neg[s])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)

    scan = {"ell_ms_per_step": steps_ms(ell_trainer)}
    for min_fill in SCAN_MIN_FILLS:
        if time.perf_counter() - t_start > MIN_FILL_SCAN_BUDGET_S:
            scan[f"min_fill_{min_fill}"] = "not measured: time box spent"
            continue
        cfg = Config(embedding_dim=64, n_layers=3, batch_size=2048, tile_spmm=True,
                     tile_min_fill=min_fill, checkpoint_dir=tmp, results_dir=tmp)
        model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands,
                                      cfg, device=dev)
        model.init(torch.Generator().manual_seed(42))
        tiles = Trainer(cfg, model, bundle)
        t = tiles.graph.tiles
        scan[f"min_fill_{min_fill}"] = {
            "ms_per_step": steps_ms(tiles), "tiles": t.num_tiles, "layout": t.layout,
            "tile_edges": int(t.values.numel()) if t.layout == "compressed" else None,
            "row_blocks": t.n_row_blocks,
        }
        del tiles, model
    print("min_fill_scan: " + json.dumps(scan), flush=True)


def _tile_bsr(layout, dev):
    """The experiment's tiles as one BSR matrix [R*128, n_blocks*128] with
    128x128 blocks, duplicate (row block, column block) tiles summed
    first (the library yardstick)."""
    n_blocks = layout.e.shape[0] // TILE
    rows = np.repeat(np.arange(layout.r_blocks, dtype=np.int64), layout.m)
    uniq, inv = np.unique(rows * n_blocks + layout.tile_col, return_inverse=True)
    blocks = torch.zeros((len(uniq), TILE, TILE), device=dev)
    blocks.index_add_(0, torch.from_numpy(inv).to(dev), torch.from_numpy(layout.tile_a).to(dev))
    crow = np.searchsorted(uniq // n_blocks, np.arange(layout.r_blocks + 1), side="left")
    return torch.sparse_bsr_tensor(
        torch.from_numpy(crow).to(dev), torch.from_numpy(uniq % n_blocks).to(dev), blocks,
        size=(layout.r_blocks * TILE, n_blocks * TILE),
    )


def phase_exp_tiles(dev):
    """The tile experiment at its full layout: each case through the
    experiment's own run_case with the launches counted from 0, then the
    kernel alone beside its plain formula, its bound and the library's
    BSR product.  Returns the records of the single-tile and the batched
    kernel."""
    t0 = time.perf_counter()
    layout = exp_block_tiles.make_layout(seed=0)
    n, d = layout.e.shape
    print(f"exp_tiles layout: {layout.num_tiles} tiles, {layout.r_blocks} row blocks x "
          f"{layout.m}, embedding {list(layout.e.shape)}, made in "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)
    cases = {"x1_f32": (1, torch.float32), "x1_bf16": (1, torch.bfloat16),
             "x2_f32": (8, torch.float32)}

    # --- the experiment's path: counts from 0 before each case, read right after ---
    runs, launches = {}, {}
    for name, (tb, dtype) in cases.items():
        block_spmm.tile_matvec.launches = 0
        runs[name] = exp_block_tiles.run_case(layout, tb, dtype, dev)
        launches[name] = block_spmm.tile_matvec.launches
    # --- end of the experiment's path ---

    want = 1 + 2 * exp_block_tiles.CHAIN
    for name, r in runs.items():
        check(r["max_abs_err"] <= r["tol"],
              f"exp_tiles {name}: kernel matches the plain formula (max abs diff "
              f"{r['max_abs_err']:.3g} <= {r['tol']:.3g}, max|plain| {r['scale']:.3g})")
        check(launches[name] == want,
              f"exp_tiles {name}: launched {launches[name]}x = 1 check + 2 chains of "
              f"{exp_block_tiles.CHAIN}")
        check(np.isfinite(r["chain_sum"]),
              f"exp_tiles {name}: finite chain sum {r['chain_sum']:.6g}")
        print(f"exp_tiles {name}: " + json.dumps(r), flush=True)

    e = torch.from_numpy(layout.e).to(dev)
    tiles = {name: exp_block_tiles.device_tiles(layout, tb, dtype, dev)
             for name, (tb, dtype) in cases.items()}
    check(all(t.layout == "dense" and t.edge_w is None for t in tiles.values()),
          "exp_tiles: layout auto picks dense on the experiment's tiles (fill 1 >= "
          f"{block_spmm.AUTO_DENSE_MIN_FILL})")
    out1 = block_spmm.tile_matvec(e, tiles["x1_f32"])
    out2 = block_spmm.tile_matvec(e, tiles["x2_f32"])
    torch.cuda.synchronize()
    gap, scale = (out1 - out2).abs().max().item(), out1.abs().max().item()
    check(gap == 0.0,
          f"exp_tiles: one tile per step equals 8 tiles per step bit for bit (max abs diff "
          f"{gap:.3g}, max|out| {scale:.3g})")
    # the bf16 limit tells a rounded window from an unrounded one
    outb = block_spmm.tile_matvec(e, tiles["x1_bf16"])
    off = (outb - exp_block_tiles.reference(e, tiles["x1_bf16"], layout.m, round_window=False)
           ).abs().max().item()
    del outb
    check(off > 10 * runs["x1_bf16"]["tol"],
          f"exp_tiles x1_bf16: the limit {runs['x1_bf16']['tol']:.3g} refuses a window left in "
          f"f32 (the kernel is {off:.3g} from that product)")
    sums = [runs[k]["chain_sum"] for k in ("x1_f32", "x2_f32")]
    check(abs(sums[0] - sums[1]) <= 1e-3 * max(1.0, abs(sums[0])),
          f"exp_tiles: both chains end in the same sum ({sums[0]:.6g}, {sums[1]:.6g})")

    ms = {name: graph_ms(lambda t=t: block_spmm.tile_matvec(e, t)) for name, t in tiles.items()}
    call_ms = {name: cuda_ms(lambda t=t: block_spmm.tile_matvec(e, t))
               for name, t in tiles.items()}
    plain_ms = {name: cuda_ms(lambda t=t: exp_block_tiles.reference(e, t, layout.m),
                               reps=3, windows=3, warmup=1) for name, t in tiles.items()}
    bounds = {name: _tile_bound_ms(t, n, d) for name, t in tiles.items()}

    # the same tiles cut to 132 and 264 row blocks.  When one thread block
    # owned one row block these were one and two blocks per SM and 384 left a
    # partly filled last wave; equal ranges of tiles should scale with the
    # number of tiles instead
    by_rows = {}
    for r in sorted({132, 264, layout.r_blocks}):
        if r <= layout.r_blocks:
            sub = block_spmm.tiles_from_arrays(
                layout.tile_a[: r * layout.m], layout.tile_col[: r * layout.m],
                np.repeat(np.arange(r, dtype=np.int32), layout.m), 1, r, device=dev)
            by_rows[r] = graph_ms(lambda sub=sub: block_spmm.tile_matvec(e, sub))
    print("exp_tiles ms_by_row_blocks: " + json.dumps(by_rows), flush=True)
    del sub

    # library yardstick: one BSR product; "none" with the reason where this
    # PyTorch build has no such product on the card
    library_ms, library_note = None, None
    try:
        bsr = _tile_bsr(layout, dev)
        lib = torch.sparse.mm(bsr, e)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        library_note = f"none: {type(exc).__name__}: {str(exc).splitlines()[0][:200]}"
    else:
        lerr = (lib - out1).abs().max().item()
        check(lerr <= 1e-4 * max(1.0, scale),
              f"exp_tiles: the BSR product equals the kernel (max abs diff {lerr:.3g})")
        library_ms = cuda_ms(lambda: torch.sparse.mm(bsr, e), reps=5, windows=3, warmup=1)
        library_note = "torch.sparse.mm of a sparse_bsr_tensor with 128x128 blocks"
    print(f"exp_tiles library: {library_note}, ms {library_ms}", flush=True)

    def record(name, replaces, main, launched):
        bound_ms, bound_by, dense_ms = bounds[main]
        r = runs[main]
        return {
            "name": name,
            "route": "cuda",
            "layout": tiles[main].layout,
            "source": KERNEL_SOURCE[tiles[main].layout],
            "replaces": replaces,
            "shape": [layout.num_tiles, TILE, TILE, d],
            "tiles_per_step": r["tiles_per_step"],
            "launches": launched,
            "max_abs_err": r["max_abs_err"],
            "ms": ms[main],            # on the card (CUDA graph replay)
            "call_ms": call_ms[main],  # one eager call in a loop
            "plain_ms": plain_ms[main],
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_rate": "67 TFLOP/s float32 and 3.35 TB/s",
            "library_ms": library_ms,
            "library": library_note,
            "chain_ms_per_application": r["ms"],
            "chain_gb_per_s": r["gb_per_s"],
            "chain_ns_per_tile": r["ns_per_tile"],
            "ns_per_tile": ms[main] / layout.num_tiles * 1e6,
            "dense_products_ms": dense_ms,
        }

    x1 = record("exp_tiles_single (tile_matvec, 1 tile per step)",
                "tools/exp_block_pallas.py:73", "x1_f32",
                launches["x1_f32"] + launches["x1_bf16"])
    b_ms, b_by, _ = bounds["x1_bf16"]
    rb = runs["x1_bf16"]
    x1.update({
        "bf16_max_abs_err": rb["max_abs_err"], "bf16_ms": ms["x1_bf16"],
        "bf16_call_ms": call_ms["x1_bf16"],
        "bf16_plain_ms": plain_ms["x1_bf16"], "bf16_bound_ms": b_ms, "bf16_bound_by": b_by,
        "bf16_bound_rate": "989 TFLOP/s bf16 tensor cores and 3.35 TB/s",
        "bf16_chain_ms_per_application": rb["ms"], "bf16_chain_gb_per_s": rb["gb_per_s"],
        "bf16_chain_ns_per_tile": rb["ns_per_tile"],
    })
    x2 = record("exp_tiles_batched (tile_matvec, 8 tiles per step)",
                "tools/exp_block_pallas.py:185", "x2_f32", launches["x2_f32"])
    x2["max_abs_diff_vs_single"] = gap
    del tiles, e, out1, out2
    _fill_scan(dev)
    return x1, x2


def _crossing(fills, a_ms, b_ms):
    """The fill at which ``a_ms`` (rising with the fill) passes ``b_ms``,
    interpolated in log(fill) between the two scan points around it; None
    when they do not cross inside the scan."""
    gap = [a - b for a, b in zip(a_ms, b_ms)]
    for i in range(len(fills) - 1):
        if gap[i] <= 0 < gap[i + 1]:
            w = -gap[i] / (gap[i + 1] - gap[i])
            return float(np.exp(np.log(fills[i]) + w * (np.log(fills[i + 1]) - np.log(fills[i]))))
    return None


def _fill_scan(dev):
    """Both tile kernels on the experiment's geometry cut to 1,536 tiles
    (16 in each of 96 row blocks, d = 64, seed 0), with the values kept at
    random positions to each fill of ``SCAN_FILLS``: each kernel against
    the plain version of its layout, its time on the card, and the fill at
    which the compressed kernel's time passes the dense kernel's."""
    layout = exp_block_tiles.make_layout(seed=0, r_blocks=96)
    rows = np.repeat(np.arange(layout.r_blocks, dtype=np.int32), layout.m)
    e = torch.from_numpy(layout.e).to(dev)
    rng = np.random.default_rng(0)
    names = [f"{lay}_{dt}" for lay in block_spmm.LAYOUTS for dt in ("f32", "bf16")]
    scan = {"tiles": layout.num_tiles, "d": layout.d, "fills": list(SCAN_FILLS),
            **{f"{k}_ms": [] for k in names}, "edges": []}
    for fill in SCAN_FILLS:
        a = layout.tile_a
        if fill < 1.0:
            a = np.where(rng.random(a.shape, dtype=np.float32) < fill, a, np.float32(0))
        scan["edges"].append(int(np.count_nonzero(a)))
        for lay in block_spmm.LAYOUTS:
            f32 = block_spmm.tiles_from_arrays(a, layout.tile_col, rows, 1, layout.r_blocks,
                                               device=dev, layout=lay)
            key = "tile_a" if lay == "dense" else "edge_w"
            bf16 = dataclasses.replace(f32, **{key: f32.values.to(torch.bfloat16)})
            for dt, t in (("f32", f32), ("bf16", bf16)):
                _check_tiles(t, e, f"the fill scan at fill {fill:g}", scaled=True)
                scan[f"{lay}_{dt}_ms"].append(graph_ms(lambda t=t: block_spmm.tile_matvec(e, t)))
            del f32, bf16, t
    for dt in ("f32", "bf16"):
        scan[f"crossing_fill_{dt}"] = _crossing(
            SCAN_FILLS, scan[f"compressed_{dt}_ms"], scan[f"dense_{dt}_ms"])
    scan["auto_dense_min_fill"] = block_spmm.AUTO_DENSE_MIN_FILL
    print("fill_scan: " + json.dumps(scan), flush=True)


def phase_fusion(dev, bundle, lightgcn_step_ms):
    """Drive the LightGCN_Fusion path: tile trainer and ELL twin, a
    validation, the ``best`` checkpoint, and serving from it with the f32
    and the int8 catalog.  Returns the kernels' launches on the path."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fusion_")
    content = np.random.default_rng(7).standard_normal(
        (bundle.num_items, 64)).astype(np.float32)
    trainers, build_s = _twin_trainers(dev, bundle, tmp, "LightGCN_Fusion", content)
    tr = trainers[True]
    users, pos, neg = _twin_batches(dev, tr, bundle)
    before = {k: v.clone() for k, v in tr.model.params().items()}
    users64 = np.unique(bundle.train.user_idx)[:64]

    # --- the main path: counts from 0, read right after ---
    torch.cuda.reset_peak_memory_stats()
    block_spmm.tile_matvec.launches = 0
    quant.quantize_rows_int8.launches = 0
    losses, step_ms = _twin_steps(trainers, users, pos, neg)
    recall, ndcg = tr.validate()
    tr.save_checkpoint(tmp, "best", 1, recall)
    loaded = ckpt.load_params(tmp, device=dev)
    served = get_model("LightGCN_Fusion")(
        bundle.num_users, bundle.num_items, bundle.num_brands,
        Config(embedding_dim=64, n_layers=3), pretrained_item_emb=content, device=dev)
    rf = Retriever.from_params(served, loaded, bundle)
    rq = Retriever.from_params(served, loaded, bundle, quantize=True)
    (v_f, i_f), (v_q, i_q) = rf.recommend(users64, k=K), rq.recommend(users64, k=K)
    launches = {"tile_matvec": block_spmm.tile_matvec.launches,
                "quantize_rows_int8": quant.quantize_rows_int8.launches}
    # --- end of the main path ---

    rel_max = _check_twin_run("LightGCN_Fusion", losses, launches["tile_matvec"], recall, ndcg)
    check(launches["quantize_rows_int8"] == 1,
          f"Fusion int8 load launched the quantizer {launches['quantize_rows_int8']}x")
    after = tr.model.params()
    check(len(tr.optimizer.param_groups[0]["params"]) == 5
          and not tr.model.item_content_embedding.requires_grad
          and torch.equal(after["item_content_embedding"], before["item_content_embedding"])
          and torch.equal(after["item_content_embedding"].cpu(), torch.from_numpy(content)),
          "Fusion: the content buffer is outside the optimizer and bit-equal after training")
    moved = (after["fusion_kernel"] - before["fusion_kernel"]).abs().max().item()
    check(moved > 0, f"Fusion: fusion_kernel trained (max abs change {moved:.3g})")
    state = ckpt.load_state(tmp, "best")
    check(set(state["params"]) == set(tr.model.param_keys) and len(state["params"]) == 6
          and len(state["optimizer"]["state"]) == 5
          and all(torch.equal(loaded[k], after[k]) for k in tr.model.param_keys),
          "Fusion: the best checkpoint holds six keys and five moment pairs, and reloads")
    for name, v in (("f32", v_f), ("int8", v_q)):
        check(v.shape == (64, K) and np.isfinite(v).all(),
              f"Fusion: the checkpoint serves 64 users from the {name} catalog")
    overlap = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(i_f, i_q)]))
    check(overlap >= MIN_INT8_OVERLAP,
          f"Fusion: int8 top-{K} overlaps f32 top-{K} by {overlap:.4f} over 64 users")
    meas = {
        "steps": TRAIN_STEPS,
        "batch": 2048,
        "ms_per_step_tile": step_ms[True],
        "ms_per_step_ell": step_ms[False],
        "lightgcn_ms_per_step_tile": lightgcn_step_ms[True],
        "lightgcn_ms_per_step_ell": lightgcn_step_ms[False],
        "trainer_build_s_tile": build_s[True],
        "trainer_build_s_ell": build_s[False],
        "loss_first_tile": float(losses[True][0]),
        "loss_last_tile": float(losses[True][-1]),
        "loss_max_rel_diff": rel_max,
        "fusion_kernel_max_abs_change": moved,
        "val_recall20": recall,
        "val_ndcg20": ndcg,
        "int8_overlap_top20": overlap,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print("fusion: " + json.dumps(meas), flush=True)
    return launches


@torch.no_grad()
def phase_padding(dev, bundle):
    """Row padding on the card: one set of LightGCN params through an
    unpadded model and through models padded to each of ``PAD_MULTIPLES``,
    on the fused and the per-layer ELL path and on the tile path."""
    cfg = Config(embedding_dim=64, n_layers=3)

    def graphs(model):
        g = model.padded_graph(bundle.graph)
        part = partition_tiles(g, min_fill=64)
        return {
            "fused ELL": to_device_graph_auto(g, device=dev),
            "per-layer ELL": to_device_graph(g, device=dev, fuse_layers=False),
            "tile": block_spmm.TiledDeviceGraph(
                base=to_device_graph(part.residual, device=dev, fuse_layers=False),
                tiles=block_spmm.to_device_tiles(part, device=dev)),
        }

    base = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                 device=dev)
    params = base.init(torch.Generator().manual_seed(42))
    want = {path: torch.cat(base(g)[:3]) for path, g in graphs(base).items()}
    for m in PAD_MULTIPLES:
        model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands,
                                      cfg, device=dev)
        model.set_row_multiple(m)
        model.load_params(params)
        pads = (model.num_users_pad, model.num_items_pad, model.num_brands_pad)
        for path, g in graphs(model).items():
            got = torch.cat(model(g)[:3])
            diff = (got - want[path]).abs().max().item()
            check(got.shape == want[path].shape and diff <= PADDING_ATOL,
                  f"row multiple {m} (tables {pads}): padded {path} forward equals the "
                  f"unpadded one (max abs diff {diff:.3g})")


def _http(port: int, path: str, payload=None):
    """(status, body, seconds) of one call to the daemon on localhost;
    POST when a payload is given."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"}, method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t0


class _Reference:
    """One set of weights' exact scores, on the host: what a daemon's
    answer is held against, whatever batch its dispatch coalesced."""

    def __init__(self, retriever, requests):
        r = self.retriever = retriever
        self.user_emb = r.user_emb.cpu()
        if r.quantized:
            d = self.user_emb.shape[1]  # the table is padded to multiples of 8
            self.item_q = r.item_q[: r.num_items, :d].cpu().numpy().astype(np.int64)
            self.item_scale = r.item_scale[:, 0].cpu().numpy()
        else:
            self.item_emb = r.item_emb.double().cpu().numpy()
        # Retriever.recommend called directly: its k-th score is the bar
        self.direct = [r.recommend(u, k=K) for u in requests]

    def scores(self, users, items):
        """[n, k] scores of ``items`` for ``users`` as the retriever computes
        them: float64 dot products of the f32 tables, or the int8 path's
        exact integer products times the two f32 scales (in its order)."""
        u = self.user_emb[torch.from_numpy(np.asarray(users, np.int64))]
        if not self.retriever.quantized:
            return np.einsum("nd,nkd->nk", u.double().numpy(), self.item_emb[items])
        u_q, u_scale = quant._quantize_users_int8_reference(u)
        s32 = np.einsum("nd,nkd->nk", u_q.numpy().astype(np.int64), self.item_q[items])
        return (s32.astype(np.float32) * u_scale.numpy()) * self.item_scale[items]

    def holds(self, i, users, body) -> bool:
        """Is ``body`` a right answer to request ``i``: k distinct items in
        descending order of their exact scores, each scoring at least the
        direct call's k-th (f32 sums in another order: 1e-6 relative), and
        the body's scores equal to the exact ones after the rounding to 4
        digits (half a unit, and the f32 noise)."""
        got, items = np.asarray(body["scores"]), np.asarray(body["items"])
        direct_scores, direct_items = self.direct[i]
        if got.shape != direct_scores.shape or items.shape != direct_items.shape:
            return False
        if any(len(set(row)) != len(row) for row in items.tolist()):
            return False
        exact = self.scores(users, items)
        eps = 1e-6 * max(1.0, float(np.abs(direct_scores).max()))
        return bool(np.abs(got - exact).max() <= DAEMON_SCORE_ATOL
                    and (exact.min(axis=1) >= direct_scores[:, -1] - eps).all()
                    and (np.diff(exact, axis=1) <= eps).all())


# The daemon's clients: a process of its own (so that their JSON work does
# not compete with the server's threads for one interpreter lock), stdlib
# only.  It reads a job from stdin, {"port", "timeout", "waves": [{"workers",
# "calls": [[path, payload or null], ...]}, ...]}, runs each wave's calls
# from a pool of that many threads, and writes [{"seconds", "results":
# [[status, body, seconds], ...]}, ...] to stdout.
_CLIENT_CODE = r"""
import concurrent.futures, json, sys, time, urllib.error, urllib.request
job = json.load(sys.stdin)
def call(c):
    path, payload = c
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        "http://127.0.0.1:%d%s" % (job["port"], path), data=data,
        headers={"Content-Type": "application/json"}, method="GET" if data is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=job["timeout"]) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t0
out = []
for wave in job["waves"]:
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(wave["workers"]) as pool:
        results = list(pool.map(call, wave["calls"]))
    out.append({"seconds": time.perf_counter() - t0, "results": results})
json.dump(out, sys.stdout)
"""


def _run_clients(port: int, waves):
    """Run ``waves`` in the client process; returns its output."""
    job = {"port": port, "timeout": HTTP_TIMEOUT_S, "waves": waves}
    res = subprocess.run([sys.executable, "-c", _CLIENT_CODE], input=json.dumps(job),
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise SystemExit(f"chip_smoke FAILED: the daemon's client process: {res.stderr[-2000:]}")
    return json.loads(res.stdout)


def _daemon_catalog(dev, bundle, model, params_v1, params_v2, int8: bool):
    """One daemon, one catalog type; returns its measurements and its
    launch counts."""
    name = "int8" if int8 else "f32"
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_daemon_{name}_")
    rng = np.random.default_rng(10 + int8)
    active = np.unique(bundle.train.user_idx)
    n_total = DAEMON_REQUESTS + DAEMON_STRADDLE
    requests = [rng.choice(active, int(rng.integers(1, DAEMON_MAX_USERS + 1)), replace=False)
                .astype(np.int32) for _ in range(n_total)]

    # the direct answers, from retrievers of their own, before any count is zeroed
    refs, first_call_ms, warm_call_ms = [], None, None
    for params in (params_v1, params_v2):
        r = Retriever.from_params(model, params, bundle, quantize=int8)
        if first_call_ms is None:  # the first call of a new retriever at a shape, then warm
            users64 = active[:64].astype(np.int32)
            t0 = time.perf_counter()
            r.recommend(users64, k=K)
            first_call_ms = (time.perf_counter() - t0) * 1e3
            warm_call_ms = host_ms(lambda: r.recommend(users64, k=K))
        refs.append(_Reference(r, requests))
    f_ptr, f_items = membership_arrays(
        bundle.train.user_idx, bundle.train.item_idx, bundle.num_users)
    seen = [[set(f_items[f_ptr[u] : f_ptr[u + 1]].tolist()) for u in users]
            for users in requests]

    def right(answer, version) -> bool:
        i, (status, body, _) = answer
        return status == 200 and refs[version].holds(i, requests[i], body)

    def ask(i):
        return ["/recommend", {"users": requests[i].tolist(), "k": K}]

    half = DAEMON_REQUESTS // 2
    straddle_idx = list(range(DAEMON_REQUESTS, n_total))
    probes = [({"users": []}, "/recommend", 400),
              ({"users": [bundle.num_users + 5]}, "/recommend", 400),
              ({"users": [0], "k": 0}, "/recommend", 400),
              ({}, "/recommend", 400),
              ({"users": list(range(8193))}, "/recommend", 400),
              ({"users": [0]}, "/nope", 404)]
    waves = [
        {"workers": 1, "calls": [["/health", None], ask(0)]},
        {"workers": DAEMON_CLIENTS, "calls": [ask(i) for i in range(half)]},
        # requests in flight around the reload: a pool of one thread more
        {"workers": DAEMON_CLIENTS + 1, "calls":
            [ask(i) for i in straddle_idx[: DAEMON_STRADDLE // 2]] + [["/reload", {}]]
            + [ask(i) for i in straddle_idx[DAEMON_STRADDLE // 2:]]},
        {"workers": DAEMON_CLIENTS, "calls": [ask(i) for i in range(half, DAEMON_REQUESTS)]},
        {"workers": 1, "calls": [["/stats", None]]},
        {"workers": 1, "calls": [[path, payload] for payload, path, _ in probes]},
        {"workers": 1, "calls": [["/stats", None]]},
    ]

    ckpt.save_params(tmp, params_v1)
    args = cli.build_parser().parse_args(
        ["serve", "--model_path", tmp, "--port", "0", "--warm_batch", "64",
         "--max_coalesce", "16"] + (["--int8"] if int8 else []))
    config = Config(embedding_dim=64, n_layers=3)

    # --- the main path: counts from 0, read right after ---
    torch.cuda.reset_peak_memory_stats()
    quant.quantize_rows_int8.launches = 0
    quant.quantize_users_int8.launches = 0
    t0 = time.perf_counter()
    server = cli.make_server(config, args, bundle, model, dev)
    server.start_background()
    try:
        start_s = time.perf_counter() - t0
        ladder = 5  # m = 1, 2, 4, 8, 16
        deadline = time.perf_counter() + 60
        warm = {}
        while time.perf_counter() < deadline:
            warm = _http(server.port, "/stats")[1]
            if warm["warm_dispatches"] + warm["warm_failures"] >= ladder:
                break
            time.sleep(0.02)
        warm_s = time.perf_counter() - t0 - start_s
        # other weights land on disk; the server holds the old ones until /reload
        ckpt.save_params(tmp, params_v2)
        out = _run_clients(server.port, waves)
        torch.cuda.synchronize()
        launches = {"stochastic": quant.quantize_rows_int8.launches,
                    "nearest": quant.quantize_users_int8.launches}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    finally:
        server.shutdown()
    # --- end of the main path ---

    check(warm["warm_dispatches"] == ladder and warm["warm_failures"] == 0,
          f"daemon {name}: the warm ladder ran {ladder} dispatches, none failed")
    (health, first), before, straddle, after = (
        out[0]["results"], list(zip(range(half), out[1]["results"])),
        out[2]["results"], list(zip(range(half, DAEMON_REQUESTS), out[3]["results"])))
    check(health[0] == 200 and health[1] == {"status": "ok"}, f"daemon {name}: /health")
    check(right((0, first), 0), f"daemon {name}: the first request after the warm ladder is right")
    reload_status, reload_body, reload_http_s = straddle.pop(DAEMON_STRADDLE // 2)
    straddle = list(zip(straddle_idx, straddle))
    check(reload_status == 200 and reload_body["status"] == "reloaded",
          f"daemon {name}: POST /reload answered {reload_status} {reload_body}")
    for label, answers, version in (("before the reload", before, 0),
                                    ("after the reload", after, 1)):
        check(all(right(a, version) for a in answers),
              f"daemon {name}: {len(answers)} answers {label} equal Retriever.recommend "
              f"with the {'new' if version else 'old'} weights")
        other = sum(right(a, 1 - version) for a in answers)
        check(other == 0, f"daemon {name}: none of them is right for the other weights")
    sides = [(right(a, 0), right(a, 1)) for a in straddle]
    check(len(sides) == DAEMON_STRADDLE and all(a != b for a, b in sides),
          f"daemon {name}: each of {DAEMON_STRADDLE} requests in flight around the reload "
          f"was answered wholly from one set of weights ({sum(a for a, _ in sides)} old, "
          f"{sum(b for _, b in sides)} new)")
    everything = before + after + straddle
    check(all(not (set(row) & seen[i][j])
              for i, (_, bd, _) in everything for j, row in enumerate(bd["items"])),
          f"daemon {name}: no seen item in {len(everything)} answers")
    check(all(np.isfinite(np.asarray(bd["scores"])).all()
              and np.asarray(bd["scores"]).shape == (len(requests[i]), K)
              for i, (_, bd, _) in everything),
          f"daemon {name}: finite [users, {K}] scores in every answer")
    got = [status for status, _, _ in out[5]["results"]]
    check(got == [w for _, _, w in probes], f"daemon {name}: error paths answer {got}")

    # a server without a reload source answers 501
    bare = RecommendServer(refs[0].retriever, bundle.num_users, port=0)
    bare.start_background()
    try:
        status = _http(bare.port, "/reload", {})[0]
    finally:
        bare.shutdown()
    check(status == 501, f"daemon {name}: /reload without a reload source answers {status}")

    stats, final = out[4]["results"][0][1], out[6]["results"][0][1]
    n_ok = 1 + DAEMON_REQUESTS + DAEMON_STRADDLE
    check(stats["requests"] == n_ok and final["requests"] == n_ok
          and stats["dispatches"] <= stats["requests"] and stats["reloads"] == 1
          and stats["warm_failures"] == 0 and stats["abandoned"] == 0
          and stats["coalesced_requests"] == stats["requests"]
          and stats["users_served"] == len(requests[0]) + sum(len(u) for u in requests),
          f"daemon {name}: /stats consistent ({json.dumps(stats)})")
    if int8:
        # one build at the start and one at the reload; one nearest launch for the
        # request make_server answers itself, one per warm and per served dispatch
        dispatches = 1 + stats["warm_dispatches"] + stats["dispatches"]
        check(launches["stochastic"] == 2,
              f"daemon int8: the stochastic mode launched {launches['stochastic']}x = "
              f"1 per catalog build (start + reload)")
        check(launches["nearest"] == dispatches,
              f"daemon int8: the nearest mode launched {launches['nearest']}x = 1 per dispatch "
              f"({stats['dispatches']} served + {stats['warm_dispatches']} warm + 1 at start)")
    else:
        check(launches == {"stochastic": 0, "nearest": 0},
              f"daemon f32: no quantizer launch ({launches})")

    lat_ms = sorted(t * 1e3 for _, (_, _, t) in before + after)
    window_s = out[1]["seconds"] + out[3]["seconds"]
    return {
        "catalog": name,
        "clients": DAEMON_CLIENTS,
        "requests": DAEMON_REQUESTS,
        "requests_per_s": DAEMON_REQUESTS / window_s,
        "users_per_s": sum(len(requests[i]) for i in range(DAEMON_REQUESTS)) / window_s,
        "latency_mean_ms": statistics.fmean(lat_ms),
        "latency_p50_ms": lat_ms[len(lat_ms) // 2],
        "latency_p99_ms": lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))],
        "latency_max_ms": lat_ms[-1],
        "server_mean_latency_ms": stats["mean_latency_ms"],
        "coalesce_factor": stats["coalesced_requests"] / stats["dispatches"],
        "dispatches": stats["dispatches"],
        "make_server_s": start_s,
        "warm_ladder_s": warm_s,
        "reload_s": reload_body["seconds"],
        "reload_http_s": reload_http_s,
        "first_http_request_ms": first[2] * 1e3,
        "retriever_first_call_ms": first_call_ms,
        "retriever_warm_call_ms": warm_call_ms,
        "peak_mem_gib": peak_gib,
        "launches": launches,
    }


def phase_daemon(dev, bundle):
    """Drive the serving daemon through ``cli.make_server`` over HTTP, with
    the f32 and then the int8 catalog; returns the quantizer's launches on
    the int8 daemon's path."""
    cfg = Config(embedding_dim=64, n_layers=3)
    model = get_model("LightGCN")(
        bundle.num_users, bundle.num_items, bundle.num_brands, cfg, device=dev)
    # seeded weights times 32 (exact): top scores of order 0.1, so that the
    # bodies' 4 digits carry three of them
    versions = [{k: v * 32.0 for k, v in
                 model.init(torch.Generator().manual_seed(seed)).items()} for seed in (42, 43)]
    out = {}
    for int8 in (False, True):
        meas = _daemon_catalog(dev, bundle, model, versions[0], versions[1], int8)
        out[meas["catalog"]] = meas
    print("daemon: " + json.dumps(out), flush=True)
    return out["int8"]["launches"]


def _profile_requests(sharded, single, users, reps: int = 20):
    """Measurement only: ``reps`` requests through each retriever under
    ``torch.profiler``: wall and device ms a request, and the host ops of
    the sharded one that take the most self CPU time beside the single-
    device one's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, r in (("mesh", sharded), ("single", single)):
        for _ in range(3):
            r.recommend(users, k=K)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                r.recommend(users, k=K)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / reps
        device = sum(e.self_device_time_total for e in prof.events()
                     if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / reps)
                       for e in prof.key_averages()), key=lambda kv: -kv[1])[:8]
        out[name] = {"wall_ms": wall, "device_ms": device / 1e3 / reps,
                     "top_host_self_ms": dict(host)}
    return {"users": len(users), **out}


def _mesh_steps(trainer, users, pos, neg):
    """``TRAIN_STEPS`` steps: per-step losses, ms per step (the first step
    left out) and the peak memory of the run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = [trainer.train_step(users[0], pos[0], neg[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(1, TRAIN_STEPS):
        out.append(trainer.train_step(users[s], pos[s], neg[s], step=s))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
    return (torch.stack(out).cpu().numpy(), ms,
            torch.cuda.max_memory_allocated() / 2**30)


def _mesh_train(dev, bundle, mesh, ell_losses, meas):
    """The two sharded trainers against phase 6's per-layer ELL trainer
    (``PerLayerTrainer``, the propagation the sharded schedules split),
    rerun here; returns the reference's batches and seed-42 params (numpy)."""
    from gcn_recommendation_tpu_torch.parallel.halo import HaloTrainer
    from gcn_recommendation_tpu_torch.parallel.spmd import ShardedTrainer

    cfg = Config(embedding_dim=64, n_layers=3, batch_size=2048)
    params0 = None
    results = {}
    for name, cls in (("single", PerLayerTrainer), ("gspmd", ShardedTrainer),
                      ("halo", HaloTrainer)):
        model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                      device=dev)
        if params0 is None:
            params0 = {k: v.clone() for k, v in
                       model.init(torch.Generator().manual_seed(42)).items()}
        else:
            model.load_params(params0)
        t0 = time.perf_counter()
        tr = cls(cfg, model, bundle) if name == "single" else cls(cfg, model, bundle, mesh)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if name == "single":
            users, pos, neg = _twin_batches(dev, tr, bundle)
        losses, ms, peak = _mesh_steps(tr, users, pos, neg)
        final = {k: v.clone() for k, v in tr._export_tree(tr.model.params()).items()}
        results[name] = (losses, final)
        # measurement only, after the snapshot: it steps on
        print(f"profile_mesh_{name}: " + json.dumps(_profile_steps(tr, users, pos, neg)),
              flush=True)
        meas[f"ms_per_step_{name}"] = ms
        meas[f"peak_mem_gib_{name}"] = peak
        meas[f"trainer_build_s_{name}"] = build_s
        if name == "single":
            fu, fi, *_ = tr._forward_eval()
            check(np.allclose(losses, ell_losses, rtol=1e-6, atol=0),
                  "mesh reference: the per-layer ELL trainer's 20 losses repeat phase 6's")
        del tr, model
    ref_losses, ref_params = results["single"]
    for name in ("gspmd", "halo"):
        losses, final = results[name]
        check(np.isfinite(losses).all() and np.allclose(
            losses, ref_losses, rtol=MESH_RTOL, atol=MESH_ATOL),
            f"mesh (1,1) {name}: 20 step losses equal the single-device ELL trainer's "
            f"(max abs diff {np.abs(losses - ref_losses).max():.3g})")
        diff = max((final[k] - ref_params[k]).abs().max().item() for k in ref_params)
        check(all(torch.allclose(final[k], ref_params[k], rtol=MESH_RTOL, atol=MESH_ATOL)
                  for k in ref_params),
              f"mesh (1,1) {name}: final params equal the single-device ELL trainer's "
              f"(max abs diff {diff:.3g})")
        meas[f"params_max_abs_diff_{name}"] = diff
    batches = [tuple(a[s].cpu().numpy() for a in (users, pos, neg)) for s in range(TRAIN_STEPS)]
    return fu, fi, batches, {k: v.cpu().numpy() for k, v in params0.items()}


def _mesh_retrieval(dev, bundle, mesh, requests, meas):
    """The sharded retrievers against the single-device ones; returns the
    quantizer's launches on the sharded path (counted from 0)."""
    cfg = Config(embedding_dim=64, n_layers=3)
    model = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                  device=dev)
    params = model.init(torch.Generator().manual_seed(42))
    single = {q: Retriever.from_params(model, params, bundle, quantize=q) for q in (False, True)}

    # --- the main path: counts from 0, read right after ---
    quant.quantize_rows_int8.launches = 0
    quant.quantize_users_int8.launches = 0
    sharded = {q: Retriever.from_params(model, params, bundle, quantize=q, mesh=mesh)
               for q in (False, True)}
    answers = {q: [sharded[q].recommend(u, k=K) for u in requests] for q in (False, True)}
    launches = {"quantize_rows_int8": quant.quantize_rows_int8.launches,
                "quantize_users_int8": quant.quantize_users_int8.launches}
    # --- end of the main path ---

    check(launches["quantize_rows_int8"] == 1,
          f"mesh (1,1): the int8 load launched the stochastic quantizer once on its one "
          f"shard ({launches['quantize_rows_int8']}x)")
    check(launches["quantize_users_int8"] == len(requests),
          f"mesh (1,1): the nearest quantizer launched once per int8 request "
          f"({launches['quantize_users_int8']}x for {len(requests)})")
    n = bundle.num_items
    check(torch.equal(sharded[True].item_q[:n], single[True].item_q[:n])
          and torch.equal(sharded[True].item_scale[:n], single[True].item_scale[:n]),
          "mesh (1,1): the sharded int8 catalog is bit-equal to the single-device one")
    for q, name in ((False, "f32"), (True, "int8")):
        want = [single[q].recommend(u, k=K) for u in requests]
        for u, (v, i), (wv, wi) in zip(requests, answers[q], want):
            check(np.array_equal(i, wi) and np.allclose(v, wv, rtol=1e-6, atol=0),
                  f"mesh (1,1) {name}: a {len(u)}-user request equals the single-device "
                  f"retriever's")
        for u in requests:
            meas[f"{name}_b{len(u)}_ms_mesh"] = host_ms(lambda: sharded[q].recommend(u, k=K))
            meas[f"{name}_b{len(u)}_ms_single"] = host_ms(lambda: single[q].recommend(u, k=K))
    for q, name in ((False, "f32"), (True, "int8")):
        print(f"profile_mesh_request_{name}: " + json.dumps(
            _profile_requests(sharded[q], single[q], requests[1])), flush=True)
    return launches, model, params, single[True]


def _mesh_cli(dev, bundle, model, params, single_int8, requests):
    """``recommend --mesh 1,1 --int8`` through the CLI's parser and mode
    function (the data already in memory: no parquet on this machine)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ckpt.save_params(tmp, params)
    users = requests[1][:8]
    args = cli.build_parser().parse_args(
        ["recommend", "--mesh", "1,1", "--model_path", tmp, "--int8", "--k", str(K),
         "--users", ",".join(str(u) for u in users)])
    mesh = cli._build_mesh(args)
    config = cli._make_config(args)
    _, scores, items = cli.recommend_loaded(config, args, bundle, model, dev, mesh)
    want = single_int8.recommend(users, k=K)
    check(np.array_equal(items, want[1]) and np.allclose(scores, want[0], rtol=1e-6, atol=0),
          "recommend --mesh 1,1 --int8 through the CLI answers as the single-device retriever")

    # serve --mesh 1,1: the leader broadcasts each dispatch, the reload and
    # the shutdown over NCCL from the dispatcher thread (no follower here)
    args = cli.build_parser().parse_args(
        ["serve", "--mesh", "1,1", "--model_path", tmp, "--int8", "--port", "0",
         "--warm_batch", "8"])
    server = cli.make_server(cli._make_config(args), args, bundle, model, dev,
                             cli._build_mesh(args))
    server.start_background()
    try:
        for phase in ("before", "after"):
            for u in requests[:2]:
                u = u[:DAEMON_MAX_USERS]
                status, body, _ = _http(server.port, "/recommend", {"users": u.tolist(), "k": K})
                want = single_int8.recommend(u, k=K)
                check(status == 200 and body["items"] == want[1].tolist()
                      and np.allclose(body["scores"], want[0], rtol=0, atol=DAEMON_SCORE_ATOL),
                      f"serve --mesh 1,1 --int8: a {len(u)}-user request over HTTP answers "
                      f"as the single-device retriever ({phase} a /reload)")
            if phase == "before":
                check(_http(server.port, "/reload", {})[0] == 200,
                      "serve --mesh 1,1: /reload rebuilds the sharded retriever")
    finally:
        server.shutdown()


def _mesh_multi(bundle, batches, params0, requests, meas):
    """Two cards: the training and retrieval checks on a 2-rank NCCL world,
    meshes (1, 2) and (2, 1)."""
    from gcn_recommendation_tpu_torch.core.mesh import run_local_world
    from gcn_recommendation_tpu_torch.parallel import drivers

    cfg = dict(embedding_dim=64, n_layers=3, batch_size=2048)
    train = [("train_case", dict(bundle=bundle, cfg_kwargs=cfg, batches=batches, params=params0,
                                 mesh_shape=shape, schedule=sched, device="cuda",
                                 record_trajectory=False))
             for shape in ((1, 2), (2, 1)) for sched in ("gspmd", "halo")]
    retr = [("retriever_case", dict(bundle=bundle, cfg_kwargs=cfg, params=params0,
                                    requests=requests, k=K, quantize=q, mesh_shape=(1, 2),
                                    device="cuda")) for q in (False, True)]
    t0 = time.perf_counter()
    out = run_local_world(2, drivers.run_cases, train + retr, device="cuda",
                          timeout_s=MESH_MULTI_TIMEOUT_S)
    meas["multi_world_s"] = time.perf_counter() - t0
    print(f"mesh_multi: 2-rank world over NCCL, {len(out)} cases in "
          f"{meas['multi_world_s']:.1f} s", flush=True)
    ref = drivers.train_case(bundle, cfg, batches, params=params0, device="cuda",
                             record_trajectory=False)
    for (_, case), res in zip(train, out[: len(train)]):
        what = f"mesh {case['mesh_shape']} {case['schedule']} over NCCL on 2 cards"
        check(np.allclose(res["step_losses"], ref["step_losses"], rtol=MESH_RTOL, atol=MESH_ATOL)
              and all(np.allclose(res["params"][k], ref["params"][k], rtol=MESH_RTOL,
                                  atol=MESH_ATOL) for k in ref["params"]),
              f"{what}: losses and params equal the single-device run's")
    for (_, case), res in zip(retr, out[len(train):]):
        want = drivers.retriever_case(bundle, cfg, params0, requests, K, case["quantize"],
                                      device="cuda")
        check(all(np.array_equal(a[1], b[1]) for a, b in zip(res["answers"], want["answers"]))
              and res["launches_load"] == (1 if case["quantize"] else 0),
              f"mesh (1,2) {'int8' if case['quantize'] else 'f32'} retriever over NCCL on 2 "
              "cards equals the single-device one")
        if case["quantize"]:
            check(np.array_equal(res["item_q"], want["item_q"]),
                  "mesh (1,2): the int8 catalog of two shards is bit-equal to the whole one")


def phase_mesh(dev, bundle, ell_losses):
    """The multi-device layer on the card: a world of one over NCCL with
    mesh (1, 1), and a 2-rank world when two cards are present.  Returns
    the quantizer's launches on the sharded retrieval path."""
    from gcn_recommendation_tpu_torch.core import distributed
    from gcn_recommendation_tpu_torch.core.mesh import MeshSpec, create_mesh
    from gcn_recommendation_tpu_torch.parallel.spmd import evaluate_sharded
    from gcn_recommendation_tpu_torch.train.evaluate import evaluate_embeddings

    t_phase = time.perf_counter()
    distributed.initialize("cuda", mesh_spec=MeshSpec(1, 1))
    try:
        mesh = create_mesh(MeshSpec(1, 1))
        check(torch.distributed.get_backend() == "nccl" and mesh.size == 1,
              "mesh (1,1): a world of one process over NCCL")
        meas = {}
        fu, fi, batches, params0 = _mesh_train(dev, bundle, mesh, ell_losses, meas)

        b = bundle
        t0 = time.perf_counter()
        r_s, n_s = evaluate_sharded(mesh, fu, fi, b.val, b.train, b.num_users, b.num_items, K)
        meas["evaluate_sharded_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        r_1, n_1 = evaluate_embeddings(fu, fi, b.val, b.train, b.num_users, b.num_items, K)
        meas["evaluate_single_s"] = time.perf_counter() - t0
        check(np.isclose(r_s, r_1, rtol=1e-6, atol=0) and np.isclose(n_s, n_1, rtol=1e-5, atol=0),
              f"mesh (1,1): evaluate_sharded Recall@{K} {r_s:.6f} / NDCG {n_s:.6f} equal "
              f"evaluate's {r_1:.6f} / {n_1:.6f}")
        meas.update(val_recall20=r_s, val_ndcg20=n_s)

        rng = np.random.default_rng(1)
        active = np.unique(bundle.train.user_idx)
        requests = [rng.choice(active, n, replace=False).astype(np.int32)
                    for n in MESH_REQUEST_SIZES]
        launches, model, params, single_int8 = _mesh_retrieval(dev, bundle, mesh, requests, meas)
        _mesh_cli(dev, bundle, model, params, single_int8, requests)

        if torch.cuda.device_count() >= 2:
            _mesh_multi(bundle, batches, params0, requests, meas)
        else:
            print(f"mesh_multi: skipped, {torch.cuda.device_count()} CUDA device", flush=True)
        meas["phase_s"] = time.perf_counter() - t_phase
        meas["launches"] = launches
        print("mesh: " + json.dumps(meas), flush=True)
        return launches
    finally:
        distributed.shutdown()


def _fused_args(dg):
    return (dg.bucket_nbr_idx, dg.bucket_nbr_w, dg.bucket_nbr_idx_perm, dg.gather_idx,
            dg.dense_mat, dg.dense_mat_perm)


def _sum_of_layers(x, plain, layers: int = 3):
    """``sum_{k=1..K} A^k x`` through K per-layer ``propagate_ell`` calls."""
    out, y = None, x
    for _ in range(layers):
        y = propagate_ell(y, plain.bucket_nbr_idx, plain.bucket_nbr_w, plain.gather_idx,
                          plain.dense_mat)
        out = y if out is None else out + y
    return out


def _value_and_grad(fn, emb):
    """``fn(x)`` and the gradient of ``sum(fn(x)**2)`` at ``x = emb``."""
    x = emb.clone().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out.float() ** 2).sum(), x)
    return out.detach(), g


def _layouts_fused(dev, g, emb, meas):
    """(a) ``propagate_sum_ell`` against three per-layer propagations."""
    plain = to_device_graph(g, device=dev, fuse_layers=False)
    fused = to_device_graph(g, device=dev)
    check(fused.fused and not plain.fused, "to_device_graph builds the merge-skip views by "
          "default and none with fuse_layers=False")
    y_p, g_p = _value_and_grad(lambda x: _sum_of_layers(x, plain), emb)
    y_f, g_f = _value_and_grad(lambda x: spmm.propagate_sum_ell(3, x, *_fused_args(fused)), emb)
    fwd, grad = (y_f - y_p).abs().max().item(), (g_f - g_p).abs().max().item()
    check(fwd <= LAYOUT_FWD_ATOL, f"propagate_sum_ell (3 layers) equals the sum of three "
          f"propagate_ell calls (max abs diff {fwd:.3g})")
    check(grad <= LAYOUT_GRAD_ATOL, f"propagate_sum_ell's gradient of sum(out**2) equals the "
          f"per-layer one (max abs diff {grad:.3g})")
    fused16 = to_device_graph(g, compute_dtype=torch.bfloat16, device=dev)
    y16 = spmm.propagate_sum_ell(3, emb.to(torch.bfloat16), *_fused_args(fused16))
    d16 = (y16 - y_f).abs().max().item()
    check(y16.dtype == torch.float32 and torch.allclose(
        y16, y_f, rtol=LAYOUT_BF16_TOL, atol=LAYOUT_BF16_TOL),
        f"propagate_sum_ell with bf16 storage returns f32 within {LAYOUT_BF16_TOL} of the f32 "
        f"result (max abs diff {d16:.3g})")
    x = emb.clone().requires_grad_(True)
    meas["fused_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        (spmm.propagate_sum_ell(3, x, *_fused_args(fused)) ** 2).sum(), x), reps=5)
    meas["per_layer_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        (_sum_of_layers(x, plain) ** 2).sum(), x), reps=5)
    x16 = emb.to(torch.bfloat16).requires_grad_(True)
    meas["fused_bf16_fwd_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(
        (spmm.propagate_sum_ell(3, x16, *_fused_args(fused16)) ** 2).sum(), x16), reps=5)
    perm = list(fused.bucket_nbr_idx_perm) + [fused.dense_mat_perm]
    meas["perm_views_gib"] = sum(t.numel() * t.element_size() for t in perm) / 2**30
    meas["graph_gib_fused"] = _graph_gib(fused)
    meas["graph_gib_per_layer"] = _graph_gib(plain)
    meas.update(fused_max_abs_diff=fwd, fused_grad_max_abs_diff=grad,
                fused_bf16_max_abs_diff=d16)
    return plain, y_p


def _layouts_chunked(dev, g, emb, plain, meas):
    """(b) the chunked layout at each of ``LAYOUT_CHUNKS`` against plain ELL."""
    n = g.num_nodes
    one = lambda x: propagate_ell(  # noqa: E731
        x, plain.bucket_nbr_idx, plain.bucket_nbr_w, plain.gather_idx, plain.dense_mat)
    y_p, g_p = _value_and_grad(one, emb)
    meas["plain_ms"] = cuda_ms(lambda: one(emb), reps=5)
    for c in LAYOUT_CHUNKS:
        t0 = time.perf_counter()
        build_chunked_ell(g, c)
        meas[f"c{c}_build_chunked_ell_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cg = spmm.to_device_chunked_graph(g, c, device=dev)
        torch.cuda.synchronize()
        meas[f"c{c}_to_device_s"] = time.perf_counter() - t0
        check(isinstance(cg, spmm.ChunkedDeviceGraph) and len(cg.chunk_gather_idx) == c,
              f"to_device_chunked_graph builds {c} source chunks")
        y_c, g_c = _value_and_grad(lambda x: spmm.propagate(x, cg, n), emb)
        fwd, grad = (y_c - y_p).abs().max().item(), (g_c - g_p).abs().max().item()
        check(fwd <= LAYOUT_FWD_ATOL and grad <= LAYOUT_GRAD_ATOL,
              f"chunked at C={c}: forward and gradient equal plain ELL's (max abs diff "
              f"{fwd:.3g} / {grad:.3g})")
        cg16 = exp_gather_knee.cast_layout(cg, torch.bfloat16)
        y16 = spmm.propagate(emb.to(torch.bfloat16), cg16, n)
        d16 = (y16.float() - y_p).abs().max().item()
        scale = y_p.abs().max().item()
        check(y16.dtype == torch.bfloat16 and d16 <= CHUNK_BF16_RTOL * scale,
              f"chunked at C={c} with bf16 storage (f32 accumulation) within "
              f"{CHUNK_BF16_RTOL} x {scale:.3g} of f32 (max abs diff {d16:.3g})")
        meas[f"c{c}_ms"] = cuda_ms(lambda: spmm.propagate(emb, cg, n), reps=5)
        emb16 = emb.to(torch.bfloat16)
        meas[f"c{c}_bf16_ms"] = cuda_ms(lambda: spmm.propagate(emb16, cg16, n), reps=5)
        meas.update({f"c{c}_max_abs_diff": fwd, f"c{c}_grad_max_abs_diff": grad,
                     f"c{c}_bf16_max_abs_diff": d16})
        del cg, cg16


def _knee_scan(dev, g):
    """(c) the gather-knee scan (``tools/exp_gather_knee.py``), time-boxed."""
    scan = exp_gather_knee.scan(dev, sizes=KNEE_SCAN_SIZES, chunks=(2, 4),
                                budget_s=KNEE_SCAN_BUDGET_S, graphs={KNEE_SCAN_SIZES[0]: g})
    for size, rec in scan["sizes"].items():
        if isinstance(rec, dict):
            for dtype in exp_gather_knee.DTYPES:
                for c in (2, 4):
                    check(rec[f"{dtype}_c{c}_matches"],
                          f"knee scan, {rec['nodes']} nodes, {dtype}: chunked at C={c} equals "
                          f"plain ELL (max abs diff {rec[f'{dtype}_c{c}_max_abs_diff']:.3g})")
    scan["GATHER_KNEE_ROWS"] = spmm.GATHER_KNEE_ROWS
    scan["num_chunks_for"] = {f"{n}_{name}": spmm.num_chunks_for(n, 64, dtype)
                              for n in KNEE_SCAN_SIZES
                              for name, dtype in exp_gather_knee.DTYPES.items()}
    print("knee_scan: " + json.dumps(scan), flush=True)


def _layouts_bf16_training(dev, bundle, ref):
    """(d) the default trainer at compute_dtype bfloat16, phase 6's params
    and batches, against phase 6's f32 (fused) run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    losses, ms, peak, tr = _steps_alone(dev, bundle, tmp, Trainer, ref["users"], ref["pos"],
                                        ref["neg"], compute_dtype="bfloat16")
    check(tr.graph.fused and tr.graph.bucket_nbr_w[0].dtype == torch.bfloat16
          and tr.graph.dense_mat_perm.dtype == torch.bfloat16,
          "a bf16 Trainer stores its fused graph in bf16")
    f32 = ref["fused_losses"]
    rel = np.abs(losses - f32) / np.abs(f32)
    check(np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean(),
          f"bf16 training: {TRAIN_STEPS} finite step losses, falling "
          f"({losses[:5].mean():.5f} -> {losses[-5:].mean():.5f})")
    check(rel.max() <= BF16_LOSS_RTOL, f"bf16 training: step losses within rtol "
          f"{BF16_LOSS_RTOL} of the f32 run (max rel diff {rel.max():.3g})")
    meas = {"steps": TRAIN_STEPS, "batch": 2048, "ms_per_step_bf16": ms,
            "ms_per_step_f32": ref["fused_ms"], "peak_mem_gib_bf16": peak,
            "peak_mem_gib_f32": ref["fused_peak_gib"], "graph_gib_bf16": _graph_gib(tr.graph),
            "loss_max_rel_diff_vs_f32": float(rel.max()),
            "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    print("bf16: " + json.dumps(meas), flush=True)
    print("profile_bf16: " + json.dumps(
        _profile_steps(tr, ref["users"], ref["pos"], ref["neg"])), flush=True)


def _layouts_test_mode_and_serving(dev, bundle, ref, meas):
    """(e) ``test`` mode through the CLI on the fused trainer's checkpoint
    against ``Trainer.validate`` on the test split; serving that checkpoint
    from an int8 catalog.  Returns K2's launches on the serving path."""
    from gcn_recommendation_tpu_torch.data.loader import Interactions
    from gcn_recommendation_tpu_torch.models import lightgcn

    b = bundle
    args = cli.build_parser().parse_args(["test", "--model_path", ref["fused_dir"]])
    config = cli._make_config(args)
    model = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, config, device=dev)
    calls = []
    real = lightgcn.propagate_sum_ell
    lightgcn.propagate_sum_ell = lambda *a: calls.append(1) or real(*a)
    try:
        recall, ndcg = cli.run_test_loaded(config, args, b, model, dev)
    finally:
        lightgcn.propagate_sum_ell = real
    check(len(calls) == 1, f"test mode propagates through propagate_sum_ell ({len(calls)} call)")
    # Trainer.validate over the test split, train + val filtered: the same
    # evaluation as test mode, on the default trainer's fused graph
    filt = Interactions(np.concatenate([b.train.user_idx, b.val.user_idx]),
                        np.concatenate([b.train.item_idx, b.val.item_idx]))
    cfg = Config(embedding_dim=64, n_layers=3)
    tmodel = get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, cfg, device=dev)
    tmodel.load_params(ckpt.load_params(ref["fused_dir"], device=dev))
    tr = Trainer(cfg, tmodel, dataclasses.replace(b, val=b.test, train=filt))
    check(tr.graph.fused, "the reference Trainer's graph is fused")
    r_want, n_want = tr.validate()
    check(np.isclose(recall, r_want, rtol=TEST_MODE_RTOL, atol=0)
          and np.isclose(ndcg, n_want, rtol=TEST_MODE_RTOL, atol=0),
          f"test mode Recall@{K} {recall:.6f} / NDCG {ndcg:.6f} equal Trainer.validate's "
          f"{r_want:.6f} / {n_want:.6f} on the test split")
    del tr, tmodel
    meas.update(test_recall20=recall, test_ndcg20=ndcg)

    users64 = np.unique(b.train.user_idx)[:64]
    # --- the main path: counts from 0, read right after ---
    quant.quantize_rows_int8.launches = 0
    quant.quantize_users_int8.launches = 0
    rq = Retriever.from_params(model, ckpt.load_params(ref["fused_dir"], device=dev), b,
                               quantize=True)
    v, i = rq.recommend(users64, k=K)
    launches = {"quantize_rows_int8": quant.quantize_rows_int8.launches,
                "quantize_users_int8": quant.quantize_users_int8.launches}
    # --- end of the main path ---
    check(launches == {"quantize_rows_int8": 1, "quantize_users_int8": 1},
          f"the fused trainer's checkpoint serves from an int8 catalog: K2 stochastic "
          f"{launches['quantize_rows_int8']}x, nearest {launches['quantize_users_int8']}x")
    seen = _seen_sets(b, users64)
    check(v.shape == (64, K) and np.isfinite(v).all()
          and all(not (set(i[j].tolist()) & seen[j]) for j in range(64)),
          "the fused trainer's checkpoint answers 64 users, finite, no seen item")
    return launches


def _layouts_native(bundle):
    """(e) the native ETL against numpy on the books bundle."""
    from unittest import mock

    from gcn_recommendation_tpu_torch.data import prepare

    b = bundle
    check(native_ext.available(), "the native ETL library builds and loads "
          f"({os.path.relpath(native_ext.library_path())})")
    args = (b.train.user_idx, b.train.item_idx, b.num_users, b.num_items, b.num_brands)
    kw = dict(item_brand_item_idx=b.item_brand.item_idx,
              item_brand_brand_idx=b.item_brand.brand_idx)
    t0 = time.perf_counter()
    g_native = build_normalized_adjacency(*args, **kw)
    t1 = time.perf_counter()
    with mock.patch.object(native_ext, "available", lambda: False):
        g_numpy = build_normalized_adjacency(*args, **kw)
        t2 = time.perf_counter()
        mask_numpy = prepare.kcore_filter(b.train.user_idx, b.train.item_idx, 20)
        t3 = time.perf_counter()
    mask_native = prepare.kcore_filter(b.train.user_idx, b.train.item_idx, 20)
    t4 = time.perf_counter()
    same_idx = all(np.array_equal(getattr(g_native, f), getattr(g_numpy, f))
                   for f in ("src", "dst", "row_ptr", "gather_idx", "dense_node_ids"))
    same_idx = same_idx and all(np.array_equal(x.nbr_idx, y.nbr_idx)
                                for x, y in zip(g_native.buckets, g_numpy.buckets))
    close_w = all(np.allclose(getattr(g_native, f), getattr(g_numpy, f), rtol=NATIVE_RTOL,
                              atol=0) for f in ("weight", "dense_mat"))
    close_w = close_w and all(np.allclose(x.nbr_w, y.nbr_w, rtol=NATIVE_RTOL, atol=0)
                              for x, y in zip(g_native.buckets, g_numpy.buckets))
    check(same_idx and close_w and np.array_equal(g_native.weight, b.graph.weight),
          f"the books graph on the native path equals numpy's (indices identical, weights "
          f"rtol {NATIVE_RTOL}) and the bundle's own")
    check(np.array_equal(mask_native, mask_numpy) and 0 < mask_native.sum() < len(mask_native),
          f"the native 20-core mask equals numpy's ({int(mask_native.sum())} of "
          f"{len(mask_native)} kept)")
    meas = {"available": True, "graph_native_s": t1 - t0, "graph_numpy_s": t2 - t1,
            "kcore20_native_s": t4 - t3, "kcore20_numpy_s": t3 - t2,
            "weights_differing": int((g_native.weight != g_numpy.weight).sum()),
            "nnz": int(g_native.nnz)}
    print("native: " + json.dumps(meas), flush=True)


def phase_layouts(dev, bundle, ref):
    """Phase 12: the merge-skip and chunked layouts on the books bundle
    (d = 64, 3 layers), the knee scan, bf16 training, ``test`` mode and
    serving from the fused trainer, the native ETL.  Returns K2's
    launches on the serving path of (e)."""
    t_phase = time.perf_counter()
    g = bundle.graph
    emb = torch.randn(g.num_nodes, 64, generator=torch.Generator().manual_seed(12)).to(dev)
    meas = {}
    plain, _ = _layouts_fused(dev, g, emb, meas)
    _layouts_chunked(dev, g, emb, plain, meas)
    del plain
    torch.cuda.empty_cache()
    launches = _layouts_test_mode_and_serving(dev, bundle, ref, meas)
    meas["phase_s_before_scan"] = time.perf_counter() - t_phase
    print("layouts: " + json.dumps(meas), flush=True)
    _layouts_bf16_training(dev, bundle, ref)
    _layouts_native(bundle)
    torch.cuda.empty_cache()
    _knee_scan(dev, g)
    print(f"layouts_phase_s: {time.perf_counter() - t_phase:.1f}", flush=True)
    return launches


# ------------------------------------------------------------ phase 13: scale


def _scale_tile_kernels(dev, bundle):
    """(a) K3 at every width of ``SCALE_WIDTHS``: both layouts, f32 and
    bf16 tiles, against the plain version on the books partition; the
    times at d = 256 beside the bounds and ``torch.sparse.mm``."""
    g = bundle.graph
    n = g.num_nodes
    part = partition_tiles(g, min_fill=64, tiles_per_step=8)
    tiles = {(lay, dt): block_spmm.to_device_tiles(part, tile_dtype=dt, device=dev, layout=lay)
             for lay in block_spmm.LAYOUTS for dt in (torch.float32, torch.bfloat16)}
    errs = {}
    for d in SCALE_WIDTHS:
        emb = torch.randn((n, d), generator=torch.Generator(device=dev).manual_seed(d),
                          device=dev)
        for key, t in tiles.items():
            errs[(key, d)] = _check_tiles(t, emb, f"the books partition (d={d})")
    d = SCALE_DIM
    emb = torch.randn((n, d), generator=torch.Generator(device=dev).manual_seed(d), device=dev)
    csr = _tile_csr(part, n, dev)
    lerr = (torch.sparse.mm(csr, emb) - block_spmm.tile_matvec(emb, tiles[("compressed",
                                                                          torch.float32)]))
    lerr = lerr.abs().max().item()
    check(lerr <= TILE_F32_ATOL, f"torch.sparse.mm of the tile edges equals the kernel at "
                                 f"d={d} (max abs diff {lerr:.3g})")
    rec = {"shape_d256": [part.num_tiles, TILE, TILE, d],
           "max_abs_err_d256": max(errs.values()),
           "max_abs_err_by_width": {str(w): max(v for (k, dd), v in errs.items() if dd == w)
                                    for w in SCALE_WIDTHS}}
    names = {("compressed", torch.float32): "", ("compressed", torch.bfloat16): "bf16_",
             ("dense", torch.float32): "dense_layout_",
             ("dense", torch.bfloat16): "dense_layout_bf16_"}
    for key, prefix in names.items():
        t = tiles[key]
        bound, by, _ = _tile_bound_ms(t, n, d)
        rec[f"{prefix}ms_d256"] = graph_ms(lambda t=t: block_spmm.tile_matvec(emb, t))
        rec[f"{prefix}call_ms_d256"] = cuda_ms(lambda t=t: block_spmm.tile_matvec(emb, t))
        rec[f"{prefix}bound_ms_d256"] = bound
        rec[f"{prefix}bound_by_d256"] = by
    rec["plain_ms_d256"] = cuda_ms(
        lambda: block_spmm._tile_matvec_reference(emb, tiles[("compressed", torch.float32)]),
        reps=5)
    rec["dense_layout_plain_ms_d256"] = cuda_ms(
        lambda: block_spmm._tile_matvec_reference(emb, tiles[("dense", torch.float32)]), reps=5)
    rec["library_ms_d256"] = graph_ms(lambda: torch.sparse.mm(csr, emb))
    print("scale_tiles: " + json.dumps(rec), flush=True)
    return rec


def _scale_books(dev, bundle):
    """(a) LightGCN at dim 256, 4 layers on the books bundle: the tile
    trainer (compressed K3 at d = 256) and its fused ELL twin take the same
    20 steps, then 64 users from an int8 catalog.  Returns the measurements
    and the launches of each main path."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_scale_")
    trainers, build_s = _twin_trainers(dev, bundle, tmp, "LightGCN", dim=SCALE_DIM,
                                       layers=SCALE_LAYERS)
    users, pos, neg = _twin_batches(dev, trainers[True], bundle)
    name = f"LightGCN d={SCALE_DIM} x {SCALE_LAYERS} layers"

    # --- the main path (training): counts from 0, read right after ---
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_spmm.tile_matvec.launches = 0
    losses, step_ms = _twin_steps(trainers, users, pos, neg)
    recall, ndcg = trainers[True].validate()
    k3 = block_spmm.tile_matvec.launches
    # --- end of the main path ---
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel_max = _check_twin_run(name, losses, k3, recall, ndcg, layers=SCALE_LAYERS)

    params = trainers[True].model.params()
    params_diff = max((params[k] - trainers[False].model.params()[k]).abs().max().item()
                      for k in ("user_embedding", "item_embedding"))
    check(params_diff <= SCALE_PARAMS_ATOL,
          f"{name}: tile and ELL tables after {TRAIN_STEPS} steps within {SCALE_PARAMS_ATOL} "
          f"(max abs diff {params_diff:.3g})")
    cfg = Config(embedding_dim=SCALE_DIM, n_layers=SCALE_LAYERS)
    served = get_model("LightGCN")(bundle.num_users, bundle.num_items, bundle.num_brands, cfg,
                                   device=dev)
    users64 = np.unique(bundle.train.user_idx)[:64]
    # --- the main path (int8 serving): counts from 0, read right after ---
    quant.quantize_rows_int8.launches = 0
    quant.quantize_users_int8.launches = 0
    rq = Retriever.from_params(served, params, bundle, quantize=True)
    v, i_q = rq.recommend(users64, k=K)
    k2 = {"quantize_rows_int8": quant.quantize_rows_int8.launches,
          "quantize_users_int8": quant.quantize_users_int8.launches}
    # --- end of the main path ---
    check(k2 == {"quantize_rows_int8": 1, "quantize_users_int8": 1},
          f"{name}: 64 users from an int8 catalog [{bundle.num_items}, {SCALE_DIM}]: K2 "
          f"stochastic {k2['quantize_rows_int8']}x, nearest {k2['quantize_users_int8']}x")
    _, i_f = Retriever.from_params(served, params, bundle).recommend(users64, k=K)
    overlap = float(np.mean([len(set(a) & set(b)) / K for a, b in zip(i_f, i_q)]))
    seen = _seen_sets(bundle, users64)
    check(v.shape == (64, K) and np.isfinite(v).all() and overlap >= MIN_INT8_OVERLAP
          and all(not (set(i_q[j].tolist()) & seen[j]) for j in range(64)),
          f"{name}: int8 answers finite, unseen, top-{K} overlap with f32 {overlap:.4f}")
    meas = {
        "steps": TRAIN_STEPS, "batch": 2048, "dim": SCALE_DIM, "layers": SCALE_LAYERS,
        "ms_per_step_tile": step_ms[True], "ms_per_step_ell": step_ms[False],
        "trainer_build_s_tile": build_s[True], "trainer_build_s_ell": build_s[False],
        "loss_first_tile": float(losses[True][0]), "loss_last_tile": float(losses[True][-1]),
        "loss_max_rel_diff": rel_max, "peak_mem_gib": peak,
        "val_recall20": recall, "val_ndcg20": ndcg,
        # after 20 Adam steps: how far apart the two paths' tables are
        "params_max_abs_diff": params_diff, "int8_overlap_top20": overlap,
    }
    print("scale_books: " + json.dumps(meas), flush=True)
    del trainers, rq
    return meas, k3, k2


def _eval_batch_pieces(tr):
    """Measurement only: ms of one evaluation batch of ``eval_user_batch``
    users on the trainer's final tables, whole (``topk_eval_batch``) and in
    its pieces: the scores, the full stable sort that selects in
    ``lax.top_k``'s tie order, and ``torch.topk`` for comparison."""
    from gcn_recommendation_tpu_torch.ops.topk import topk_eval_batch

    with torch.no_grad():
        fu, fi, *_ = tr._forward_eval()
        batch = tr._eval_batches[0]
        u = fu.index_select(0, batch[0])
        scores = u @ fi.T

        def ms(fn):
            return cuda_ms(fn, reps=3, windows=3, warmup=1)

        out = {"users": int(u.shape[0]), "items": int(fi.shape[0]),
               "batch": ms(lambda: topk_eval_batch(fu, fi, *batch, K)),
               "scores": ms(lambda: u @ fi.T),
               "stable_sort": ms(lambda: torch.sort(scores, dim=1, descending=True,
                                                    stable=True)),
               "topk": ms(lambda: torch.topk(scores, K, dim=1))}
    del fu, fi, scores
    return out


def _scale_north_star(dev):
    """(b) The north-star graph (``tools/exp_scale.py``'s constants) at dim
    256, 4 layers: the default ``Trainer`` (source-chunked by the knee
    rule) takes 3 steps, one validation, then an int8 catalog serves 1, 64
    and 1024 users."""
    from gcn_recommendation_tpu_torch.tools import exp_scale as xs

    nb, etl_s = xs.build_bundle()
    g = nb.graph
    check(g.num_nodes == 720_000 and 32_000_000 < g.nnz < 34_000_000,
          f"the north-star graph: {g.num_nodes:,} nodes, {g.nnz:,} nonzeros "
          f"(ETL {etl_s:.1f} s on the host)")
    name = f"north-star d={SCALE_DIM} x {SCALE_LAYERS} layers"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_north_star_")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**30
    cfg = Config(embedding_dim=SCALE_DIM, n_layers=SCALE_LAYERS, batch_size=2048,
                 checkpoint_dir=tmp, results_dir=tmp)
    model = get_model("LightGCN")(nb.num_users, nb.num_items, nb.num_brands, cfg, device=dev)
    model.init(torch.Generator().manual_seed(42))
    t0 = time.perf_counter()
    tr = Trainer(cfg, model, nb)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    chunks = len(tr.graph.chunk_gather_idx) if isinstance(tr.graph, spmm.ChunkedDeviceGraph) \
        else 0
    check(chunks == spmm.num_chunks_for(g.num_nodes, SCALE_DIM) == 2,
          f"{name}: the Trainer takes the source-chunked layout, {chunks} chunks by the knee "
          f"rule")
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = epoch_batches(gen, tr.n_train, 2048, dev)[:SCALE_NORTH_STAR_STEPS]
    users, pos = tr.train_users[idx], tr.train_items[idx]
    neg = sample_negatives(gen, users, tr.pos_keys, num_items=nb.num_items)
    out = [tr.train_step(users[0], pos[0], neg[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(1, SCALE_NORTH_STAR_STEPS):
        out.append(tr.train_step(users[s], pos[s], neg[s], step=s))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (SCALE_NORTH_STAR_STEPS - 1)
    losses = torch.stack(out).cpu().numpy()
    check(np.isfinite(losses).all(), f"{name}: {SCALE_NORTH_STAR_STEPS} finite step losses "
                                     f"({', '.join(f'{x:.5f}' for x in losses)})")
    train_peak = torch.cuda.max_memory_allocated() / 2**30 - base

    n_val = len(np.unique(nb.val.user_idx))
    t0 = time.perf_counter()
    recall, ndcg = tr.validate()
    val_s = time.perf_counter() - t0
    check(all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in (recall, ndcg)),
          f"{name}: validation over all {n_val:,} users x {nb.num_items:,} items, "
          f"Recall@{K} {recall:.4f}, NDCG@{K} {ndcg:.4f}")
    # measurement only: one evaluation batch in pieces, and a profile of two steps
    eval_ms = _eval_batch_pieces(tr)
    print("profile_north_star: " + json.dumps(_profile_steps(tr, users, pos, neg, steps=2)),
          flush=True)

    params = tr.params()
    del tr
    torch.cuda.empty_cache()
    # --- the main path (int8 serving): xs.serve counts K2 from 0 over the load
    # and one request of each size, and reads the counts right after ---
    served = xs.serve(model, params, nb, dev, True, np.random.default_rng(0))
    # --- end of the main path ---
    k2 = dict(zip(("quantize_rows_int8", "quantize_users_int8"), served["k2_launches"]))
    answers = served["answers"]
    check(k2 == {"quantize_rows_int8": 1, "quantize_users_int8": len(answers)},
          f"{name}: int8 catalog [{nb.num_items}, {SCALE_DIM}] built by K2 once (stochastic), "
          f"{k2['quantize_users_int8']} requests quantized by K2 (nearest)")
    users64, _, items64 = answers[1]
    seen = _seen_sets(nb, users64)
    check(all(v.shape == (len(u), K) and np.isfinite(v).all() for u, v, _ in answers)
          and all(not (set(items64[j].tolist()) & seen[j]) for j in range(len(users64))),
          f"{name}: int8 answers to {', '.join(str(len(u)) for u, _, _ in answers)} users "
          f"finite, no seen item")
    meas = {
        "nodes": g.num_nodes, "nnz": int(g.nnz), "train": len(nb.train),
        "etl_s": etl_s, "trainer_build_s": setup_s, "chunks": chunks,
        "ms_per_step": step_ms, "steps": SCALE_NORTH_STAR_STEPS,
        "losses": [float(x) for x in losses],
        "peak_mem_gib_train": train_peak,
        "val_users": n_val, "val_s": val_s, "val_users_per_s": n_val / val_s,
        "val_recall20": recall, "val_ndcg20": ndcg, "eval_batch_ms": eval_ms,
        "int8_load_s": served["load_s"],
        "int8_request_ms": {str(n): t for n, t in served["request_ms"].items()},
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30 - base,
    }
    print("scale_north_star: " + json.dumps(meas), flush=True)
    del served, model, params
    torch.cuda.empty_cache()
    return meas, k2


def phase_scale(dev, bundle):
    """Phase 13: the scaled configuration (dim 256, 4 layers).  Returns
    K3's record at d = 256 and the launches of each main path (K2's
    d = 256 shape is timed in phase 3)."""
    t_phase = time.perf_counter()
    tile_rec = _scale_tile_kernels(dev, bundle)
    _, k3, k2_books = _scale_books(dev, bundle)
    _, k2_north = _scale_north_star(dev)
    print(f"scale: phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    tile_rec["launches_scale_path"] = k3
    quant_launches = {
        "launches_scale_books_stochastic": k2_books["quantize_rows_int8"],
        "launches_scale_books_nearest": k2_books["quantize_users_int8"],
        "launches_scale_north_star_stochastic": k2_north["quantize_rows_int8"],
        "launches_scale_north_star_nearest": k2_north["quantize_users_int8"],
    }
    return tile_rec, quant_launches


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy (the CLI's lines are
    both shown and read)."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.out.write(text)
        return self.buf.write(text)

    def flush(self):
        self.out.flush()


def _cli(argv):
    """``cli.main(argv)`` in this process; returns what it printed."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(argv)
    check(rc == 0, f"cli {' '.join(argv[:1] + argv[1:3])} ... returned 0")
    return tee.buf.getvalue()


def _ex_per_s(text: str) -> float:
    """The last epoch line's examples a second."""
    return float(re.findall(r"\(([\d,]+) ex/s\)", text)[-1].replace(",", ""))


def _recording(module, name: str, keep):
    """Patch ``module.name`` to run as before and hand each call's
    arguments and result to ``keep(args, result)``."""
    orig = getattr(module, name)

    def recorded(*args, **kw):
        result = orig(*args, **kw)
        keep(args, result)
        return result

    return mock.patch.object(module, name, recorded)


def _k2_recorder(calls):
    """Record every quantizer launch (its mode, input, seed, row offset and
    output) into ``calls`` while the launch runs as before."""
    def keep(args, result):  # (wrapper, x, mode, seed, out[, row_offset])
        calls.append(dict(mode=args[0].__name__, x=args[1].clone(), seed=args[3],
                          row_offset=args[5] if len(args) > 5 else 0,
                          out=(result[0].clone(), result[1].clone())))
    return _recording(quant, "_launch_quantizer", keep)


def _check_cli_quantizer(calls):
    """Each quantizer launch of a CLI command, bit-equal to the plain
    version of its mode on the inputs the command gave it: the command's
    own output, and the wrapper called again on those inputs.  Returns the
    shapes, by mode."""
    shapes = {}
    for c in calls:
        x, mode = c["x"], c["mode"]
        if mode == "quantize_rows_int8":
            plain = quant._quantize_rows_int8_reference(x, c["seed"], c["row_offset"])
            again = quant.quantize_rows_int8(x, seed=c["seed"], row_offset=c["row_offset"])
        else:
            plain = quant._quantize_users_int8_reference(x)
            again = quant.quantize_users_int8(x)
        torch.cuda.synchronize()
        for what, (q, s) in (("the command's output", c["out"]), ("relaunched", again)):
            check(torch.equal(q, plain[0]) and torch.equal(s, plain[1]),
                  f"recommend --int8: {mode} ({what}) bit-equal to plain at "
                  f"{list(x.shape)}")
        shapes.setdefault(mode, []).append(list(x.shape))
    return shapes


def phase_cli_dataset():
    """Phase 14: the CLI on an on-disk dataset, in this process, so the
    launch counters see the kernels.  Returns K2's and K3's launches on
    their CLI paths, each counted from 0 around its command."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    spec = run_regime_grids.REGIMES["books"]

    written = {}

    def recording_write(path, columns):  # the generator's arrays, as handed to the writer
        written[os.path.basename(path)] = {k: np.array(v) for k, v in columns.items()}
        parquet.write_columns(path, columns)

    t0 = time.perf_counter()
    with mock.patch.object(synthetic, "write_columns", recording_write):
        _cli(["prepare", "--recipe", "synthetic", "--num_users", str(spec["num_users"]),
              "--num_items", str(spec["num_items"]), "--num_brands", str(spec["num_brands"]),
              "--mean_degree", str(spec["mean_degree"]), "--latent_dim", str(spec["latent_dim"]),
              "--temperature", str(spec["temperature"]), "--pop_scale", str(spec["pop_scale"]),
              "--core", "16", "--embedding_dim", "64", "--style", "latent",
              "--emb_noise", str(run_regime_grids.EMB_NOISE["books"]),
              "--brand_style", run_regime_grids.BRAND_STYLE, "--output_dir", data])
    prepare_s = time.perf_counter() - t0
    check(sorted(written) == ["item_brand.parquet", "test.parquet", "train.parquet"],
          "prepare --recipe synthetic wrote the three parquet files through data/parquet.py")
    for name, cols in written.items():
        back = parquet.read_columns(os.path.join(data, name))
        check(list(back) == list(cols) and all(
            back[c].dtype == cols[c].dtype and np.array_equal(back[c], cols[c]) for c in cols),
            f"read_columns gives back the generator's arrays of {name} exactly "
            f"({len(next(iter(cols.values()))):,} rows)")

    common = ["--processed_dir", data, "--output_root", out]
    t0 = time.perf_counter()
    text = _cli(["train", *common, "--epochs", "2", "--val_interval", "1"])
    train_s = time.perf_counter() - t0
    ms_step = 2048 / _ex_per_s(text) * 1e3
    val = [float(x) for x in re.findall(r"Val Recall@20: ([\d.]+)", text)]
    check(len(val) == 2 and all(0 < v <= 1 for v in val),
          f"train 2 epochs on the on-disk dataset: Val Recall@20 {val}")
    text = _cli(["test", *common])
    test_recall = float(re.search(r"Recall@20: ([\d.]+)", text).group(1))
    check(0 < test_recall <= 1, f"test on the on-disk dataset: Recall@20 {test_recall}")

    users = [3, 7, 11, 19]
    k2_calls = []
    quant.quantize_rows_int8.launches = quant.quantize_users_int8.launches = 0
    with _k2_recorder(k2_calls):
        text = _cli(["recommend", *common, "--int8", "--k", str(K),
                     "--users", ",".join(map(str, users))])
    k2 = {"stochastic": quant.quantize_rows_int8.launches,
          "nearest": quant.quantize_users_int8.launches}
    lines = re.findall(r"^user (\d+): (.*)$", text, re.M)
    check([int(u) for u, _ in lines] == users and all(len(p.split()) == K for _, p in lines),
          f"recommend --int8 answers {len(users)} users with {K} items each")
    check(k2 == {"stochastic": 1, "nearest": 1},
          f"recommend --int8: K2 launched once on load and once for the request ({k2})")
    k2_shapes = _check_cli_quantizer(k2_calls)

    # (id(tiles), pass) -> the first call on those tiles in that pass: the
    # training forward takes an input that requires grad, the backward a
    # cotangent that does not
    k3_calls = {}

    def keep_k3(args, result):  # (emb, tiles)
        key = (id(args[1]), "forward" if args[0].requires_grad else "backward")
        if key not in k3_calls:
            k3_calls[key] = (args[1], args[0].detach().clone(), result.detach().clone())

    block_spmm.tile_matvec.launches = 0
    with _recording(block_spmm, "_tile_matvec_cuda", keep_k3):
        text = _cli(["train", "--processed_dir", data, "--output_root",
                     os.path.join(tmp, "tile"), "--epochs", "1", "--val_interval", "1",
                     "--tile_spmm"])
    k3 = block_spmm.tile_matvec.launches
    k3_checks = []
    for (_, pass_), (tiles, emb, out_path) in k3_calls.items():
        what = (f"the books regime's partition of train --tile_spmm, {pass_} "
                f"({tiles.num_tiles} tiles, emb {list(emb.shape)})")
        k3_checks.append({
            "pass": pass_, "layout": tiles.layout, "dtype": str(tiles.values.dtype).replace("torch.", ""),
            "tiles": tiles.num_tiles, "emb": list(emb.shape),
            "max_abs_diff_command": _check_tiles(tiles, emb, what + ", the command's output",
                                                 k=out_path),
            "max_abs_diff_relaunched": _check_tiles(tiles, emb, what + ", relaunched")})
    check({c["pass"] for c in k3_checks} == {"forward", "backward"},
          "train --tile_spmm: K3's inputs of both passes recorded and held against plain")
    del k3_calls
    # one validation row per user leaves the train split
    train_users = written["train.parquet"]["user_idx"]
    steps = -(-(len(train_users) - len(np.unique(train_users))) // 2048)
    check("CUDA tile partition" in text and k3 == 6 * steps + 3,
          f"train --tile_spmm 1 epoch: K3 launched {k3}x = 6 a step x {steps} steps + 3 "
          "for the validation forward")

    # the grid runner, one code, 20 epochs, held against the JAX grid's run
    t0 = time.perf_counter()
    exp = os.path.join(tmp, "exp_torch_synth")
    with contextlib.redirect_stdout(_Tee(sys.stdout)):
        results = run_experiments.main(["--processed_dir", data, "--exp_name", exp,
                                        "--epochs", str(CLI_GRID_EPOCHS), "--grids", "base",
                                        "--only", "brd"])
    grid_s = time.perf_counter() - t0
    code = f"base_{CLI_GRID_EPOCHS}e16c_brd"
    check([c for c, _ in results] == [code], f"run_experiments ran {code}")
    port_run = regime_comparison.read_runs(exp)[0]
    with open(glob.glob(os.path.join(REPO, "exp_synth", "results", "base_150e16c_brd",
                                     "*_epoch_history.csv"))[0]) as f:
        jax_rows = [r for r in csv.DictReader(f) if int(r["epoch"]) <= CLI_GRID_EPOCHS]
    jax_best = max(float(r["recall"]) for r in jax_rows)
    band = regime_comparison.band_of(
        regime_comparison.read_runs(os.path.join(REPO, "exp_torch_synth")),
        regime_comparison.read_runs(os.path.join(REPO, "exp_synth")))
    check(abs(port_run["best_recall"] - jax_best) <= band,
          f"{code}: best R@20 {port_run['best_recall']:.4f} (epoch {port_run['best_epoch']}) "
          f"within {band:.4f} of the JAX grid's best over epochs <= {CLI_GRID_EPOCHS} "
          f"({jax_best:.4f})")
    shutil.rmtree(tmp, ignore_errors=True)
    print("cli_dataset: " + json.dumps({
        "seconds": round(time.perf_counter() - t_phase, 1), "prepare_s": round(prepare_s, 2),
        "train_2_epochs_s": round(train_s, 2), "ms_per_step": ms_step,
        "val_recall": val, "test_recall": test_recall, "grid_code": code,
        "grid_s": round(grid_s, 1), "grid_best_recall": port_run["best_recall"],
        "grid_best_epoch": port_run["best_epoch"], "jax_best_recall": jax_best, "band": band,
        "k2": k2, "k2_shapes_checked": k2_shapes, "k3": k3, "k3_checked": k3_checks}),
        flush=True)
    return {"quantize_rows_int8": k2["stochastic"], "quantize_users_int8": k2["nearest"],
            "tile_matvec": k3}


# ----------------------------------------------------------- phase 15: tools
TOOLS_SERVE_ARGV = ["--users", "5000", "--items", "2000", "--brands", "200", "--batch", "256",
                    "--reqs", "3", "--depths", "1", "4"]
TOOLS_TILE_ARGV = ["--num_users", "10000", "--num_items", "5000", "--num_brands", "500",
                   "--min_fills", "64", "--chain", "2"]


def _tool(module, argv):
    """``module.main(argv)`` in this process, its lines shown; returns
    (its result, what it printed, seconds)."""
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = module.main(argv)
    return result, tee.buf.getvalue(), time.perf_counter() - t0


def _check_tool_quantizer(calls, tool: str):
    """Every quantizer launch of a tool bit-equal to the plain version of
    its mode on the inputs the tool gave it; returns the launches and the
    shapes checked, by mode."""
    seen = {}
    for c in calls:
        x, mode = c["x"], c["mode"]
        if mode == "quantize_rows_int8":
            plain = quant._quantize_rows_int8_reference(x, c["seed"], c["row_offset"])
        else:
            plain = quant._quantize_users_int8_reference(x)
        q, s = c["out"]
        if not (torch.equal(q, plain[0]) and torch.equal(s, plain[1])):
            check(False, f"{tool}: {mode} bit-equal to plain at {list(x.shape)}")
        entry = seen.setdefault(mode, {"launches": 0, "shapes": []})
        entry["launches"] += 1
        if list(x.shape) not in entry["shapes"]:
            entry["shapes"].append(list(x.shape))
    for mode, entry in seen.items():
        check(True, f"{tool}: each of its {entry['launches']} {mode} launches bit-equal to "
                    f"plain on its own inputs ({entry['shapes']})")
    return seen


def _raw_review_dump(directory: str, seed: int = 0, n_users: int = 300, n_items: int = 120):
    """Review and metadata JSONL of the ``amazon_books_emb`` recipe's layout,
    drawn from ``seed``, with a few malformed lines; returns their paths."""
    rng = np.random.default_rng(seed)
    reviews = os.path.join(directory, "reviews.jsonl")
    meta = os.path.join(directory, "meta.jsonl")
    with open(reviews, "w") as f:
        for u in range(n_users):
            for i in rng.choice(n_items, 12 + int(rng.integers(0, 6)), replace=False):
                f.write(json.dumps({
                    "user_id": f"u{u}", "item_id": f"i{int(i)}",
                    "rating": float(rng.integers(1, 6)), "timestamp": float(rng.integers(0, 99)),
                    "sentiment": "positive" if rng.random() < 0.9 else "negative"}) + "\n")
        f.write('{"user_id": "u0", "item_id": "i0", "rat\n[1, 2]\nnull\n')
    with open(meta, "w") as f:
        for i in range(n_items):
            f.write(json.dumps({
                "item_id": f"i{i}",
                "categories": ["Root"] + [f"C{int(c)}" for c in rng.integers(0, 8, 2)],
                "embd": rng.standard_normal(64).round(4).tolist()}) + "\n")
        f.write('{"item_id": "i2", "categor\n')
    return reviews, meta


def phase_tools(dev):
    """Phase 15: the port's measurement and drill tools, each through its
    ``main(argv)`` in this process at a reduced size.  Returns K2's and
    K3's launches on the tools' paths, each counted from 0 around its tool."""
    from gcn_recommendation_tpu_torch.tools import (
        calibrate_regimes,
        card_checks,
        exp_hub_threshold,
        exp_min_width,
        exp_serve,
        exp_step_profile,
        exp_tile_spmm,
        exp_topk_mask,
        multiproc_dryrun,
        real_data_dryrun,
    )

    t_phase = time.perf_counter()
    rec, launches = {}, {}

    # card_checks at its full size: K2 stochastic 3 (seeds 1, 1, 2), nearest
    # 1 for the overlap + 3 warm-up + 3 x 40 timed
    calls = []
    quant.quantize_rows_int8.launches = quant.quantize_users_int8.launches = 0
    with _k2_recorder(calls):
        res, text, sec = _tool(card_checks, [])
    k2 = {"stochastic": quant.quantize_rows_int8.launches,
          "nearest": quant.quantize_users_int8.launches}
    check("ALL CARD CHECKS PASSED" in text and res["overlap"] > MIN_INT8_OVERLAP,
          f"card_checks passed (overlap {res['overlap']:.4f}, step error {res['step_err']:.4f}, "
          f"bias {res['mean_bias']:.2e})")
    check(k2 == {"stochastic": 3, "nearest": 124},
          f"card_checks: K2 launched 3 stochastic + 124 nearest ({k2})")
    _check_tool_quantizer(calls, "card_checks")
    launches["card_checks"] = k2
    rec["card_checks"] = dict(res, seconds=round(sec, 1))
    del calls

    # exp_serve: K2 stochastic once at the int8 catalog's load, nearest once a
    # request (1 warm-up + 3 repetitions x 3 requests)
    calls = []
    quant.quantize_rows_int8.launches = quant.quantize_users_int8.launches = 0
    with _k2_recorder(calls):
        res, _, sec = _tool(exp_serve, TOOLS_SERVE_ARGV)
    k2 = {"stochastic": quant.quantize_rows_int8.launches,
          "nearest": quant.quantize_users_int8.launches}
    check(k2 == {"stochastic": 1, "nearest": 10},
          f"exp_serve: K2 launched once on the int8 load and once a request ({k2})")
    _check_tool_quantizer(calls, "exp_serve")
    check(all(np.isfinite(v["ms"]) for v in res["per_request"].values()),
          "exp_serve: per-request rows timed")
    launches["exp_serve"] = k2
    rec["exp_serve"] = {k: v for k, v in res.items() if k != "answers"}
    rec["exp_serve"]["seconds"] = round(sec, 1)
    del calls

    # exp_tile_spmm at one min_fill: K3 forward and backward through the tool's
    # own chains, the first call on each tile set in each pass held against
    # plain.  A call without grad after one with grad is a backward (the
    # cotangent); one before any is the tool's forward check.
    k3_calls, saw_grad = {}, set()

    def keep_k3(args, result):  # (emb, tiles)
        tid = id(args[1])
        if args[0].requires_grad:
            saw_grad.add(tid)
            pass_ = "forward"
        else:
            pass_ = "backward" if tid in saw_grad else "forward (no grad)"
        if (tid, pass_) not in k3_calls:
            k3_calls[(tid, pass_)] = (args[1], args[0].detach().clone(), result.detach().clone())

    block_spmm.tile_matvec.launches = 0
    with _recording(block_spmm, "_tile_matvec_cuda", keep_k3):
        res, _, sec = _tool(exp_tile_spmm, TOOLS_TILE_ARGV)
    k3 = block_spmm.tile_matvec.launches
    # per tile dtype: 1 check + (1 warm-up + 3 windows) x chain x (1 fwd + 2 fwd+bwd)
    want = 2 * (1 + 4 * 2 * 3)
    check(k3 == want, f"exp_tile_spmm: K3 launched {k3}x = {want} (2 dtypes x (1 + 4 x 2 x 3))")
    checked = []
    for (_, pass_), (tiles, emb, out_k) in k3_calls.items():
        what = (f"exp_tile_spmm's partition, {pass_} ({tiles.num_tiles} tiles, "
                f"emb {list(emb.shape)})")
        checked.append({"pass": pass_, "dtype": str(tiles.values.dtype).replace("torch.", ""),
                        "max_abs_diff_tool": _check_tiles(tiles, emb, what + ", the tool's output",
                                                          k=out_k),
                        "max_abs_diff_relaunched": _check_tiles(tiles, emb, what + ", relaunched")})
    check({(c["pass"], c["dtype"]) for c in checked}
          == {(p, d) for p in ("forward (no grad)", "forward", "backward")
              for d in ("float32", "bfloat16")},
          "exp_tile_spmm: K3's inputs of each pass and tile dtype held against plain")
    for case in res["cases"]:
        if case["dtype"] == "float32":
            check(case["max_err"] <= PROPAGATION_ATOL,
                  f"exp_tile_spmm: f32 tiles vs ELL max err {case['max_err']:.2e}")
    del k3_calls
    launches["exp_tile_spmm"] = k3
    rec["exp_tile_spmm"] = {"seconds": round(sec, 1), "k3": k3, "checked": checked,
                            "cases": [{k: v for k, v in c.items() if k != "times"}
                                      for c in res["cases"]]}

    res, _, sec = _tool(exp_topk_mask, ["--filters", "8"])
    check(len(res["rows"]) == 6 and all(np.isfinite(v) for v in res["rows"].values()),
          "exp_topk_mask at F = 8: fixup and compare exact against scatter; 6 rows timed")
    rec["exp_topk_mask"] = {"seconds": round(sec, 1),
                            "ms": {f"{f}:{n}": v for (f, n), v in res["rows"].items()}}

    res, _, sec = _tool(exp_hub_threshold, ["--thresholds", "256", "128", "--chain", "3"])
    hubs = [r["hubs"] for r in res["rows"]]
    check(len(hubs) == 2 and hubs[0] <= hubs[1]
          and all(np.isfinite(r["fwdbwd_ms"]) for r in res["rows"]),
          f"exp_hub_threshold at 256 and 128: hubs {hubs}, both timed")
    rec["exp_hub_threshold"] = dict(res, seconds=round(sec, 1))

    res, _, sec = _tool(exp_min_width, ["--nb", "400000", "--wide_nb", "200000",
                                        "--wide_widths"])
    check(len(res["rows"]) == 4 and all(np.isfinite(r["ms"]) for r in res["rows"]),
          "exp_min_width at width 8, NB 400,000: four forms timed")
    rec["exp_min_width"] = dict(res, seconds=round(sec, 1))

    res, _, sec = _tool(exp_step_profile, ["--chain", "3"])
    rows = res["rows"]
    ladder = ("full_step (per-layer)", "full_step (fused merge-skip)", "step fixed-neg",
              "step fixed-neg+sgd", "step dot-loss (no batch rows)", "fwd+bwd 3-layer",
              "fwd 3-layer")
    check(len(rows) == 16 and all(np.isfinite(r["wall"]) and np.isfinite(r["events"])
                                  for r in rows.values())
          and all(rows[n]["busy"] is not None and rows[n]["busy"] > 0 for n in ladder),
          "exp_step_profile: 16 rows with wall and event ms a step, the ladder's with busy ms "
          f"(profiler windows without device events: "
          f"{[n for n, r in rows.items() if r['busy'] is None]})")
    rec["exp_step_profile"] = {"seconds": round(sec, 1), "graph": res["graph_line"],
                               "rows": rows, "attribution": res["attribution"]}

    res, text, sec = _tool(calibrate_regimes, ["--regime", "books", "--epochs", "2",
                                               "--val_interval", "1", "--oracle"])
    check("SUMMARY best R@20=" in text and 0 < res["best_recall"] <= res["oracle"],
          f"calibrate_regimes books 2 epochs: best R@20 {res['best_recall']:.4f} under the "
          f"oracle {res['oracle']:.4f}")
    rec["calibrate_regimes"] = dict(res, seconds=round(sec, 1))

    rc, text, sec = _tool(multiproc_dryrun, ["1", "--device", "cuda", "--timeout", "300"])
    check(rc == 0 and "multiproc_dryrun PASSED" in text,
          "multiproc_dryrun as a world of one over NCCL: collectives, sharded forward, "
          "checkpoint kill and resume, halo equality")
    rec["multiproc_dryrun"] = {"seconds": round(sec, 1)}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    reviews, meta = _raw_review_dump(tmp)
    rc, text, sec = _tool(real_data_dryrun, ["--recipe", "amazon_books_emb", "--review_path",
                                             reviews, "--meta_path", meta, "--core", "5",
                                             "--full_dir", os.path.join(tmp, "out")])
    check(rc == 0 and "dryrun OK" in text and "debug-train best recall" in text,
          "real_data_dryrun on a generated amazon_books_emb dump: ETL, loader, debug training")
    rc_missing, _, _ = _tool(real_data_dryrun, ["--recipe", "amazon_books_emb", "--review_path",
                                                os.path.join(tmp, "nope.jsonl"),
                                                "--meta_path", meta])
    check(rc_missing == 2, "real_data_dryrun exits 2 on a missing input")
    shutil.rmtree(tmp, ignore_errors=True)
    rec["real_data_dryrun"] = {"seconds": round(sec, 1)}

    rec["seconds"] = round(time.perf_counter() - t_phase, 1)
    print("tools: " + json.dumps(rec, default=float), flush=True)
    return launches


# ------------------------------------------------------ phase 16: studies
STUDIES_SMALL = ["--num_users", "10000", "--num_items", "5000", "--num_brands", "500"]


def _check_gather_on_card(dev):
    """One gather of the gather studies on the card against the CPU's."""
    from gcn_recommendation_tpu_torch.tools import exp_dim_split

    emb, idx, buf = exp_dim_split.gather_case(np.random.default_rng(5), 50_000, 192,
                                              1_000_000, dev)
    torch.index_select(emb, 0, idx, out=buf)
    check(torch.equal(buf.cpu(), emb.cpu()[idx.cpu()]),
          "exp_dim_split / exp_knee_d192: index_select into the buffer equals emb[idx] "
          "(50,000 x 192, 1M rows)")


def _check_block_matmul_on_card(dev):
    """The block study's f32 and bf16 variants on the card against the CPU's
    f32 formula on one small case."""
    from gcn_recommendation_tpu_torch.tools import exp_block_matmul as bm

    n_blocks, m, r_blocks = 40, 8, 12
    case = bm.make_case(np.random.default_rng(3), n_blocks, 64, m * r_blocks, dev)
    with torch.no_grad():
        want = bm.full(*(x.cpu() for x in case), n_blocks, m, r_blocks)
        f32 = bm.full(*case, n_blocks, m, r_blocks).cpu()
        bf16 = bm.full_bf16(*case, n_blocks, m, r_blocks).cpu()
    scale = float(want.abs().max())
    err32, err16 = float((f32 - want).abs().max()), float((bf16 - want).abs().max())
    check(err32 <= 1e-4 * scale and err16 <= 2e-2 * scale,
          f"exp_block_matmul on the card vs the CPU's f32 formula: f32 {err32:.2e}, "
          f"bf16 tiles {err16:.2e} (largest {scale:.2f})")


def phase_studies(dev):
    """Phase 16: the seven studies, each through its ``main(argv)`` in
    this process at a reduced size; K2 and K3 counted from 0 around them."""
    from gcn_recommendation_tpu_torch.tools import (
        exp_bf16_accuracy,
        exp_block_density,
        exp_block_matmul,
        exp_compile_cost,
        exp_dim_split,
        exp_knee_d192,
        exp_spmm_variants,
    )

    t_phase = time.perf_counter()
    quant.quantize_rows_int8.launches = quant.quantize_users_int8.launches = 0
    block_spmm.tile_matvec.launches = 0
    rec = {}

    res, text, sec = _tool(exp_bf16_accuracy, ["--num_users", "5000", "--num_items", "2000",
                                               "--num_brands", "200", "--epochs", "5"])
    best = [res[d]["best_recall"] for d in ("float32", "bfloat16")]
    check("SUMMARY recall@20:" in text and all(0 < r <= 1 for r in best),
          f"exp_bf16_accuracy 5 epochs: best R@20 f32 {best[0]:.4f} bf16 {best[1]:.4f}")
    rec["exp_bf16_accuracy"] = {"seconds": round(sec, 1), "best_recall": best,
                                "ms_per_step": [res[d]["ms_per_step"]
                                                for d in ("float32", "bfloat16")]}

    res, _, sec = _tool(exp_spmm_variants, ["--num_users", "10000", "--num_items", "5000",
                                            "--chain", "5"])
    rows = res["rows"]
    check(res["max_abs_diff"] < 1e-4 and len(rows) == 4
          and all(np.isfinite(r["ms"]) and np.isfinite(r["graph_ms"]) and r["kernels"] != 0
                  for r in rows),
          f"exp_spmm_variants at the books regime's size: bucketed vs flat "
          f"{res['max_abs_diff']:.1e}, four forms timed with and without the host, kernels "
          f"{[r['kernels'] for r in rows]}")
    rec["exp_spmm_variants"] = {"seconds": round(sec, 1), "rows": rows}

    _check_gather_on_card(dev)
    res, _, sec = _tool(exp_dim_split, ["--rows", "90000", "360000", "--rows_per_iter",
                                        "1000000", "--chain", "5"])
    check(len(res["rows"]) == 4 and len(res["summary"]) == 4
          and all(np.isfinite(r["ns_per_row"]) for r in res["rows"]),
          "exp_dim_split at 90k and 360k rows x d 128 and 256: four rates, four summary lines")
    rec["exp_dim_split"] = {"seconds": round(sec, 1), "summary": res["summary"]}

    res, _, sec = _tool(exp_knee_d192, ["--rows", "120000", "240000", "--rows_per_iter",
                                        "1000000", "--chain", "5"])
    check(res["knee_rows"] == 166_666 and res["above_over_below"] is not None,
          f"exp_knee_d192 across the 166,666-row knee: x{res['above_over_below']:.3f}")
    rec["exp_knee_d192"] = {"seconds": round(sec, 1), "ratio": res["above_over_below"]}

    res, _, sec = _tool(exp_block_density, STUDIES_SMALL + ["--styles", "heavy"])
    heavy = res["styles"]["heavy"]
    check(all(0 <= a <= b <= 1 for a, b in (heavy["original"], heavy["degree-sorted"],
                                            heavy["non-hub"])),
          "exp_block_density on the heavy graph: coverage in [0, 1], the card's break-even "
          "covering at least the TPU's")
    rec["exp_block_density"] = {"seconds": round(sec, 1), "degree_sorted": heavy["degree-sorted"]}

    _check_block_matmul_on_card(dev)
    res, _, sec = _tool(exp_block_matmul, ["--configs", "16x384", "--chain", "5"])
    rows = res["configs"][0]["rows"]
    check(len(rows) == 5 and all(np.isfinite(r["ms"]) and np.isfinite(r["graph_ms"])
                                 for r in rows),
          "exp_block_matmul at 16 x 384 tiles: four variants and the row gather timed")
    rec["exp_block_matmul"] = {"seconds": round(sec, 1),
                               "ms": {r["name"]: r["ms"] for r in rows}}

    res, _, sec = _tool(exp_compile_cost, STUDIES_SMALL + ["--variant", "fused",
                                                           "--keep_build", "--steps", "20"])
    fused = res["fused"]
    check(np.isfinite(fused["first_losses"]).all() and fused["steady_s"] > 0,
          f"exp_compile_cost fused in a fresh process: CUDA init {fused['cuda_init_s']:.2f} s, "
          f"first epoch {fused['first_s']:.2f} s, steady {fused['steady_s']:.2f} s")
    rec["exp_compile_cost"] = {"seconds": round(sec, 1),
                               **{k: fused.get(k) for k in ("startup_s", "cuda_init_s", "nvcc_s",
                                                        "host_build_s", "first_s", "steady_s",
                                                        "process_s")}}

    counts = (quant.quantize_rows_int8.launches, quant.quantize_users_int8.launches,
              block_spmm.tile_matvec.launches)
    check(counts == (0, 0, 0), f"the seven studies launch neither K2 nor K3: {counts}")
    rec["seconds"] = round(time.perf_counter() - t_phase, 1)
    print("tools11: " + json.dumps(rec, default=float), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card only",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = card_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)

    build_s = _build.build()
    print(f"build_seconds: {build_s:.2f}", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc[{name}]: {line}")

    quant_record = phase_kernel_check(dev)
    bundle, bundle_s = books_bundle()
    serve_launches = phase_path(dev, bundle, bundle_s)
    tile_record = phase_tile_kernel_check(dev, bundle)
    train_launches, step_ms, train_ref = phase_train(dev, bundle)
    x1_record, x2_record = phase_exp_tiles(dev)
    fusion_launches = phase_fusion(dev, bundle, step_ms)
    phase_padding(dev, bundle)
    daemon_launches = phase_daemon(dev, bundle)
    mesh_launches = phase_mesh(dev, bundle, train_ref["per_layer_losses"])
    layout_launches = phase_layouts(dev, bundle, train_ref)
    scale_tile_record, scale_quant_launches = phase_scale(dev, bundle)
    cli_launches = phase_cli_dataset()
    tools_launches = phase_tools(dev)
    phase_studies(dev)

    # launches of each main path, read right after it was driven: both modes of
    # the quantizer on the int8 daemon's path, then the earlier paths' counts
    quant_record["launches"] = daemon_launches["stochastic"] + daemon_launches["nearest"]
    quant_record["launches_daemon_stochastic"] = daemon_launches["stochastic"]
    quant_record["launches_daemon_nearest"] = daemon_launches["nearest"]
    quant_record["launches_recommend_path"] = serve_launches["quantize_rows_int8"]
    quant_record["launches_recommend_path_nearest"] = serve_launches["quantize_users_int8"]
    quant_record["launches_fusion_path"] = fusion_launches["quantize_rows_int8"]
    quant_record["launches_mesh_stochastic"] = mesh_launches["quantize_rows_int8"]
    quant_record["launches_mesh_nearest"] = mesh_launches["quantize_users_int8"]
    quant_record["launches_layouts_stochastic"] = layout_launches["quantize_rows_int8"]
    quant_record["launches_layouts_nearest"] = layout_launches["quantize_users_int8"]
    quant_record.update(scale_quant_launches)
    tile_record["launches"] = train_launches["tile_matvec"]
    tile_record["launches_fusion_path"] = fusion_launches["tile_matvec"]
    tile_record.update(scale_tile_record)
    quant_record["launches_cli_path"] = (cli_launches["quantize_rows_int8"]
                                         + cli_launches["quantize_users_int8"])
    quant_record["launches_cli_path_nearest"] = cli_launches["quantize_users_int8"]
    tile_record["launches_cli_path"] = cli_launches["tile_matvec"]
    for tool in ("card_checks", "exp_serve"):
        quant_record[f"launches_{tool}_stochastic"] = tools_launches[tool]["stochastic"]
        quant_record[f"launches_{tool}_nearest"] = tools_launches[tool]["nearest"]
    tile_record["launches_exp_tile_spmm"] = tools_launches["exp_tile_spmm"]
    print(f"total_seconds: {time.perf_counter() - t_start:.1f}", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": [quant_record, tile_record, x1_record, x2_record]}),
          flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
