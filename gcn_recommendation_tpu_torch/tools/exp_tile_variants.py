"""Experiment: variants of the dense tile kernel, timed on the card.

Where does ``csrc/tile_spmm.cu`` spend its time on the layout of
``tools/exp_block_tiles.py`` (6,144 dense tiles, d = 64), and do its
constants sit where the card wants them?  Each variant is the kernel's
source with a few lines replaced, built beside the real library and swapped
in for ``tile_matvec``'s calls:

* ``no_compute`` / ``no_loads``: the ring without its products, and the
  products without the ring's loads (wrong results, used for their time
  only): how long each side takes alone and how well the two overlap;
* ``no_hint``: tile values loaded without the evict-first hint for the L2;
* ``f32_kc32_s4`` / ``f32_s3_one_block``: float32 stages of 32 tile columns
  in a ring of four, and three stages of 64 (one block per SM);
* ``bf16_kc64_s4`` / ``bf16_s4_one_block``: bfloat16 stages of half a tile
  in a ring of four, and four whole-tile stages (one block per SM).

    python -m gcn_recommendation_tpu_torch.tools.exp_tile_variants

Needs a CUDA card and ``nvcc``.  Prints one JSON line per variant: ms of
one ``tile_matvec`` on the card (CUDA graph replay of 20 launches, median
of 5) with float32 and with bfloat16 tiles, and the max abs diff against
the experiment's reference formula.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import tempfile

import torch

from gcn_recommendation_tpu_torch.kernels import _build
from gcn_recommendation_tpu_torch.ops import block_spmm
from gcn_recommendation_tpu_torch.tools import exp_block_tiles
from gcn_recommendation_tpu_torch.utils.timing import graph_ms

_PLAIN_CP = 'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n"'
_HINT_CP = 'asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\\n"'
_F32_LOOP = "for (int k = 0; k < kKC; k += 4) {"
_BF16_LOOP = "for (int kk = 0; kk < kKC / 16; ++kk) {"
_FETCH_NEXT = "if (q + kStages - 1 < br.n_chunks) fetch(q + kStages - 1);"
_FETCH_FIRST = "if (s < br.n_chunks) fetch(s);"

# name -> [(text in csrc/tile_spmm.cu, its replacement)]
VARIANTS = {
    "base": [],
    "no_compute": [(_F32_LOOP, "for (int k = 0; k < 0; k += 4) {"),
                   (_BF16_LOOP, "for (int kk = 0; kk < 0; ++kk) {")],
    "no_loads": [(_FETCH_NEXT, ""), (_FETCH_FIRST, "")],
    "no_hint": [(_HINT_CP, _PLAIN_CP)],
    "f32_kc32_s4": [("constexpr int kKCF32 = 64;", "constexpr int kKCF32 = 32;"),
                    ("constexpr int kStagesF32 = 2;", "constexpr int kStagesF32 = 4;")],
    "f32_s3_one_block": [("constexpr int kStagesF32 = 2;", "constexpr int kStagesF32 = 3;")],
    "bf16_kc64_s4": [("constexpr int kKCBf16 = 128;", "constexpr int kKCBf16 = 64;"),
                     ("launch_bf16<kKCBf16, 4, 2, 2>", "launch_bf16<kKCBf16, 4, 4, 2>")],
    "bf16_s4_one_block": [("launch_bf16<kKCBf16, 4, 2, 2>", "launch_bf16<kKCBf16, 4, 4, 1>")],
}


def variant_source(source: str, edits, name: str = "csrc/tile_spmm.cu") -> str:
    """``source`` (the text of ``name``) with every (old, new) of ``edits``
    applied; raises when an ``old`` is not in the source any more."""
    for old, new in edits:
        if old not in source:
            raise ValueError(f"{name} no longer holds {old!r}: update VARIANTS")
        source = source.replace(old, new)
    return source


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the variants run on the card only")
    dev = torch.device("cuda")
    with open(_build.source_path("tile_spmm")) as f:
        source = f.read()
    real = _build.load_library("tile_spmm")
    argtypes, restype = _build._SIGNATURES["tile_spmm"]["tile_spmm_launch"]
    layout = exp_block_tiles.make_layout(seed=0)
    e = torch.from_numpy(layout.e).to(dev)
    tiles = {name: exp_block_tiles.device_tiles(layout, 1, dtype, dev)
             for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    refs = {name: exp_block_tiles.reference(e, t, layout.m) for name, t in tiles.items()}
    with tempfile.TemporaryDirectory(prefix="tile_variants_") as tmp:
        builds = {}
        for name, edits in VARIANTS.items():  # one nvcc per variant, all started together
            cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
            with open(cu, "w") as f:
                f.write(variant_source(source, edits))
            builds[name] = (so, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        try:
            for name, (so, proc) in builds.items():
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
                lib = ctypes.CDLL(so)
                lib.tile_spmm_launch.argtypes, lib.tile_spmm_launch.restype = argtypes, restype
                _build._loaded["tile_spmm"] = lib
                row = {"variant": name}
                for key, t in tiles.items():
                    out = block_spmm.tile_matvec(e, t)
                    row[f"{key}_max_abs_diff"] = float((out - refs[key]).abs().max())
                    row[f"{key}_ms"] = graph_ms(lambda t=t: block_spmm.tile_matvec(e, t))
                print(json.dumps(row), flush=True)
        finally:
            _build._loaded["tile_spmm"] = real
            for _, proc in builds.values():
                if proc.poll() is None:
                    proc.kill()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
