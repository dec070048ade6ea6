"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on a CUDA card unless the CPU is asked for."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "gcn_recommendation_tpu_torch"


def _port_modules():
    mods = []
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        for f in sorted(files):
            if f.endswith(".py") and f != "__main__.py":
                rel = os.path.relpath(os.path.join(root, f), REPO)[: -len(".py")]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return sorted(mods)


# the measurement and drill tools of slice 10, and the timers beneath them
TOOL_MODULES = ("utils.timing", "tools.calibrate_regimes", "tools.exp_serve",
                "tools.exp_step_profile", "tools.exp_topk_mask", "tools.exp_hub_threshold",
                "tools.exp_min_width", "tools.exp_tile_spmm", "tools.card_checks",
                "tools.multiproc_dryrun", "tools.real_data_dryrun")
# the studies (bf16 accuracy, SpMM forms, gather rates, tile density, block parts,
# cold-process cost)
STUDY_MODULES = ("tools.exp_bf16_accuracy", "tools.exp_spmm_variants", "tools.exp_dim_split",
                 "tools.exp_knee_d192", "tools.exp_block_density", "tools.exp_block_matmul",
                 "tools.exp_compile_cost")


def test_port_lists_its_modules():
    mods = _port_modules()
    for m in ("ops.quant", "ops.spmm", "ops.topk", "serve", "cli", "kernels._build",
              "models.lightgcn", "models.convert", "utils.checkpoint", "core.device",
              "ops.block_spmm", "graph.tiles", "data.sampler", "train.loss",
              "train.evaluate", "train.trainer", "utils.logging",
              "models.lightgcn_fusion", "tools", "tools.exp_block_tiles", "tools.exp_tile_variants",
              "data.synthetic", "graph.build", "server", "data.prepare", "utils.profiling",
              "tools.exp_quant_call", "tools.exp_daemon_backlog", "data.native_ext",
              "tools.exp_gather_knee", "tools.exp_scale", "ops", "graph", "data",
              "data.parquet", "tools.run_experiments", "tools.run_regime_grids",
              "tools.regime_comparison", "tools.exp_parquet_read", *TOOL_MODULES,
              *STUDY_MODULES):
        assert f"{PKG}.{m}" in mods


MESH_MODULES = ("core.mesh", "core.distributed", "parallel", "parallel.spmd", "parallel.halo",
                "parallel.collectives", "parallel.drivers")


def test_port_lists_its_mesh_modules():
    mods = _port_modules()
    for m in MESH_MODULES:
        assert f"{PKG}.{m}" in mods


def test_spawned_ranks_import_no_jax():
    """A rank of a spawned world (the CPU tests' and the chip smoke test's
    two-card worlds) loads the port and nothing of JAX, though this test
    process has JAX loaded."""
    import jax  # noqa: F401  - the parent has it; the ranks must not

    from gcn_recommendation_tpu_torch.core.distributed import runtime_report
    from gcn_recommendation_tpu_torch.core.mesh import run_local_world

    report = run_local_world(2, runtime_report, device="cpu")
    assert report["rank"] == 0 and report["world_size"] == 2
    assert report["backend"] == "gloo" and report["device"] == "cpu"
    assert PKG in report["packages"] and "torch" in report["packages"]
    assert "jax" not in report["packages"]
    assert "gcn_recommendation_tpu" not in report["packages"]


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'gcn_recommendation_tpu'\n"
        "             or k.startswith('gcn_recommendation_tpu.'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")


def test_default_device_raises_without_cuda():
    _no_card()
    from gcn_recommendation_tpu_torch.core.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(tmp_path):
    _no_card()
    from gcn_recommendation_tpu_torch.config import Config
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.graph.tiles import partition_tiles
    from gcn_recommendation_tpu_torch.models import get_model
    from gcn_recommendation_tpu_torch.models.convert import params_from_jax
    from gcn_recommendation_tpu_torch.ops.block_spmm import tiles_from_arrays, to_device_tiles
    from gcn_recommendation_tpu_torch.ops.spmm import (
        to_device_chunked_graph,
        to_device_graph,
        to_device_graph_auto,
    )
    from gcn_recommendation_tpu_torch.data.synthetic import generate_synthetic_dataset
    from gcn_recommendation_tpu_torch.tools import exp_block_tiles, exp_scale, run_experiments
    from gcn_recommendation_tpu_torch.train.evaluate import build_eval_batches
    from gcn_recommendation_tpu_torch.utils.checkpoint import load_params

    b = synthetic_bundle(40, 30, 4, seed=0)
    data = generate_synthetic_dataset(str(tmp_path / "data"), num_users=40, num_items=30,
                                      num_brands=4, seed=0)
    calls = [
        lambda: get_model("LightGCN")(b.num_users, b.num_items, b.num_brands, Config()),
        lambda: to_device_graph_auto(b.graph),
        lambda: to_device_graph(b.graph, fuse_layers=False),
        lambda: to_device_chunked_graph(b.graph, 2),
        lambda: params_from_jax(
            {k: np.zeros((2, 2)) for k in
             ("user_embedding", "item_embedding", "brand_embedding")},
            get_model("LightGCN")(2, 2, 2, Config(embedding_dim=2), device="cpu")),
        lambda: load_params(str(tmp_path)),
        lambda: to_device_tiles(partition_tiles(b.graph, min_fill=1)),
        lambda: build_eval_batches(b.val, b.train, b.num_users, b.num_items),
        lambda: get_model("LightGCN_Fusion")(
            b.num_users, b.num_items, b.num_brands, Config(),
            pretrained_item_emb=np.zeros((b.num_items, 8), np.float32)),
        lambda: tiles_from_arrays(np.zeros((1, 128, 128), np.float32), np.zeros(1, np.int32),
                                  np.zeros(1, np.int32), 1, 1),
        lambda: exp_block_tiles.device_tiles(exp_block_tiles.make_layout(0, 2, 4, 1, 1)),
        lambda: exp_block_tiles.run_case(exp_block_tiles.make_layout(0, 2, 4, 1, 1), 1,
                                         torch.float32),
        lambda: exp_scale.main(["--num_users", "40", "--num_items", "30", "--num_brands", "4"]),
        lambda: run_experiments.main(["--processed_dir", data, "--epochs", "1", "--only", "brd",
                                      "--exp_name", str(tmp_path / "exp")]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_tools_default_to_the_card_and_raise_without_cuda(tmp_path):
    """Every tool of slice 10 runs on ``cuda`` unless ``--device cpu`` is
    given; without a card it raises before it measures anything."""
    _no_card()
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

    small = ["--num_users", "40", "--num_items", "30", "--num_brands", "4"]
    dump = tmp_path / "dump.jsonl"
    dump.write_text("")
    calls = [
        (calibrate_regimes, small + ["--epochs", "0"]),
        (card_checks, []),
        (exp_hub_threshold, small),
        (exp_min_width, ["--src_rows", "10", "--nb", "10", "--wide_nb", "10"]),
        (exp_serve, ["--users", "40", "--items", "30", "--brands", "4"]),
        (exp_step_profile, small),
        (exp_tile_spmm, small),
        (exp_topk_mask, ["--batch", "4", "--items", "30"]),
        (multiproc_dryrun, ["1"]),
        (real_data_dryrun, ["--recipe", "amazon_books", "--review_path", str(dump),
                            "--meta_path", str(dump)]),
    ]
    for tool, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(argv)


def test_studies_default_to_the_card_and_raise_without_cuda():
    """Every study that takes a device time runs on ``cuda``
    unless ``--device cpu`` is given; without a card it raises before it
    measures anything (``exp_block_density`` is host-only)."""
    _no_card()
    from gcn_recommendation_tpu_torch.tools import (
        exp_bf16_accuracy,
        exp_block_matmul,
        exp_compile_cost,
        exp_dim_split,
        exp_knee_d192,
        exp_spmm_variants,
    )

    small = ["--num_users", "40", "--num_items", "30", "--num_brands", "4"]
    calls = [
        (exp_bf16_accuracy, small),
        (exp_spmm_variants, small),
        (exp_dim_split, ["--rows", "10", "--rows_per_iter", "10"]),
        (exp_knee_d192, ["--rows", "10", "--rows_per_iter", "10"]),
        (exp_block_matmul, ["--n_blocks", "2", "--configs", "1x2"]),
        (exp_compile_cost, small + ["--variant", "fused"]),
    ]
    for tool, argv in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(argv)


def test_cli_without_device_raises_without_cuda(tmp_path):
    _no_card()
    from gcn_recommendation_tpu_torch import cli

    for mode in ("recommend", "train", "test", "serve"):
        for extra in ([], ["--model_name", "LightGCN_Fusion"], ["--mesh", "1,1"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                cli.main([mode, "--processed_dir", str(tmp_path), *extra])


def test_daemon_modules_hold_no_jax_import_in_their_source():
    """The new modules' text names neither package as an import (the
    subprocess test above proves it of what they load)."""
    import re

    for rel in ("server.py", "data/prepare.py", "utils/profiling.py", "cli.py",
                "tools/exp_quant_call.py", "core/mesh.py", "core/distributed.py",
                "parallel/__init__.py", "parallel/spmd.py", "parallel/halo.py",
                "parallel/collectives.py", "parallel/drivers.py", "data/native_ext.py",
                "tools/exp_gather_knee.py", "ops/spmm.py", "graph/build.py",
                "tools/exp_scale.py", "ops/block_spmm.py", "data/parquet.py",
                "data/loader.py", "data/synthetic.py", "tools/run_experiments.py",
                "tools/run_regime_grids.py", "tools/regime_comparison.py",
                "tools/exp_parquet_read.py",
                *(m.replace(".", "/") + ".py" for m in TOOL_MODULES + STUDY_MODULES)):
        with open(os.path.join(REPO, PKG, rel)) as f:
            text = f.read()
        assert not re.search(r"^\s*(import|from)\s+(jax|gcn_recommendation_tpu)(\.|\s)", text,
                             re.M), rel


def test_port_and_chip_smoke_import_no_pandas_or_root_tools():
    """Neither the port nor ``chip_smoke.py`` loads pandas, pyarrow or the
    repository's root ``tools/`` (the JAX package's tools) when imported."""
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('pandas', 'pyarrow', 'tools'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_prepare_needs_no_device():
    """``prepare`` is host-only: it runs without a card and without
    ``--device`` (it has no such flag)."""
    from gcn_recommendation_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["prepare", "--recipe", "synthetic", "--device", "cpu"])


def test_chip_smoke_fails_without_cuda():
    _no_card()
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
