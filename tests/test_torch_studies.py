"""The port's seven studies against the JAX package's root tools.

Each tool runs small on the CPU through ``main(argv)`` and is held against
the JAX side: the JAX tool's constants, sweeps and labels (read from its
source, loaded by path, never imported by the port), its functions on the
JAX bundle's rows, or its formulas in ``jnp`` on the same numpy inputs.
"""

import ast
import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from gcn_recommendation_tpu.data import synthetic as jsyn
from gcn_recommendation_tpu.ops.spmm import to_device_graph as jax_to_device_graph
from gcn_recommendation_tpu_torch.ops.spmm import knee_rows_for
from gcn_recommendation_tpu_torch.tools import (
    exp_bf16_accuracy,
    exp_block_density,
    exp_block_matmul,
    exp_compile_cost,
    exp_dim_split,
    exp_knee_d192,
    exp_spmm_variants,
)
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--num_users", "300", "--num_items", "200", "--num_brands", "12"]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_loop_tuples(name):
    """The constant tuples a JAX tool's ``for x in (...)`` loops run over."""
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    found = []
    for n in ast.walk(tree):
        if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple):
            try:
                found.append(ast.literal_eval(n.iter))
            except ValueError:  # a tuple of names, not of constants
                pass
    return found


def _run(tool, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = tool.main(argv)
    return res, out.getvalue()


def test_constants_equal_the_jax_tools():
    for port, name in ((exp_bf16_accuracy, "exp_bf16_accuracy"),
                       (exp_spmm_variants, "exp_spmm_variants"),
                       (exp_dim_split, "exp_dim_split"), (exp_knee_d192, "exp_knee_d192"),
                       (exp_block_density, "exp_block_density"),
                       (exp_block_matmul, "exp_block_matmul"),
                       (exp_compile_cost, "exp_compile_cost")):
        jax_tool = _jax_tool(name)
        consts = [k for k in vars(jax_tool) if k.isupper() and k != "REPO"]
        assert consts, name
        for k in consts:
            assert getattr(port, k) == getattr(jax_tool, k), (name, k)
    # the sweeps, written inline in the JAX tools' main()
    assert _jax_loop_tuples("exp_dim_split") == [exp_dim_split.SRC_ROWS, exp_dim_split.DIMS]
    assert _jax_loop_tuples("exp_knee_d192") == [exp_knee_d192.SRC_ROWS]
    assert _jax_loop_tuples("exp_block_matmul") == [exp_block_matmul.CONFIGS]
    assert _jax_loop_tuples("exp_block_density") == [exp_block_density.STYLES]
    assert exp_knee_d192.DIM == 192


def test_spmm_variants_bucketed_equals_flat_and_the_jax_formula():
    res, text = _run(exp_spmm_variants, SMALL + ["--device", "cpu", "--chain", "1"])
    assert res["max_abs_diff"] < 1e-4
    np.testing.assert_allclose(res["flat"].numpy(), res["bucketed"].numpy(), atol=1e-4)
    # the JAX tool's matvec_bucketed on its own device graph of the same bundle
    b = jsyn.synthetic_bundle(num_users=300, num_items=200, num_brands=12, mean_degree=28.0,
                              core=8, seed=42)
    g = b.graph
    dg = jax_to_device_graph(g)
    emb0 = np.random.default_rng(0).standard_normal((g.num_nodes, 64)).astype(np.float32) * 0.1
    emb = jnp.asarray(emb0)
    parts = [jnp.sum(jnp.take(emb, idx, axis=0) * w[..., None], axis=1)
             for idx, w in zip(dg.bucket_nbr_idx, dg.bucket_nbr_w)]
    if dg.dense_mat.shape[0]:
        parts.append(jnp.dot(dg.dense_mat, emb, preferred_element_type=jnp.float32))
    parts.append(jnp.zeros((1, 64), emb.dtype))
    want = np.asarray(jnp.concatenate(parts, axis=0)[dg.gather_idx])
    np.testing.assert_allclose(res["bucketed"].numpy(), want, rtol=1e-5, atol=1e-5)
    assert f"graph: nodes={g.num_nodes} nnz={g.nnz} buckets={len(g.buckets)}" in text
    assert [(r["form"], r["tag"]) for r in res["rows"]] == [
        ("bucketed", "fwd"), ("bucketed", "fwd+bwd"), ("flat", "fwd"), ("flat", "fwd+bwd")]
    assert "_SymmetricProduct" in text and "index_add_" in text


def test_spmm_variants_flat_backward_equals_the_symmetric_one():
    """The two forms' gradients of ``sum(A e)^2`` agree: autograd's
    ``index_add_`` through the flat gathers against the symmetric one."""
    from gcn_recommendation_tpu_torch.data.synthetic import synthetic_bundle
    from gcn_recommendation_tpu_torch.ops.spmm import propagate, to_device_graph

    b = synthetic_bundle(num_users=300, num_items=200, num_brands=12, mean_degree=28.0,
                         core=8, seed=42)
    dg = to_device_graph(b.graph, device="cpu")
    flat = exp_spmm_variants.flat_layout(dg)
    e0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (b.graph.num_nodes, 8)).astype(np.float32))
    grads = []
    for fn in (lambda e: propagate(e, dg),
               lambda e: exp_spmm_variants.matvec_flat(e, dg, flat)):
        e = e0.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(e) ** 2).sum(), e)[0])
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=1e-5, atol=1e-5)


def test_gather_studies_gather_the_rows_and_print_the_knee():
    rng = np.random.default_rng(0)
    emb, idx, buf = exp_dim_split.gather_case(rng, 500, 24, 3000, torch.device("cpu"))
    torch.index_select(emb, 0, idx, out=buf)
    want_rng = np.random.default_rng(0)
    e = want_rng.standard_normal((500, 24)).astype(np.float32)
    i = want_rng.integers(0, 500, 3000, dtype=np.int64)
    assert np.array_equal(buf.numpy(), e[i])
    assert int(idx.max()) < 500

    res, text = _run(exp_dim_split, ["--device", "cpu", "--rows", "400", "1600",
                                     "--rows_per_iter", "2000", "--chain", "1"])
    assert [(r["rows"], r["d"]) for r in res["rows"]] == [(400, 128), (400, 256),
                                                          (1600, 128), (1600, 256)]
    assert res["knee_rows_256"] == knee_rows_for(256) == 125_000
    assert "  plain   2k x 256          : " in text
    assert "  split+chunk 2 x (0k x 128): " in text
    assert len(res["summary"]) == 4

    res, text = _run(exp_knee_d192, ["--device", "cpu", "--rows", "160", "320",
                                     "--rows_per_iter", "1000", "--chain", "1"])
    assert res["knee_rows"] == knee_rows_for(192) == 166_666
    assert f"knee_rows_for(192) = {knee_rows_for(192):,} rows" in text
    assert "rows=     0k d=192:" in text and "tiles ceil=   0.0k frac=   0.0k" in text
    assert "does not cross" in text


def test_dim_split_default_summary_labels_are_the_jax_tools():
    with open(os.path.join(REPO, "tools", "exp_dim_split.py")) as f:
        jax_text = f.read()
    for label in ("  plain   720k x 256          : ", "  split   2 x (720k x 128)    : ",
                  "  split+chunk 2 x (180k x 128): ", "  chunk-only   180k x 256     : "):
        assert label in jax_text
    # the port's labels at the default sweep
    big = max(exp_dim_split.SRC_ROWS)
    k = exp_dim_split._k
    assert f"  plain   {k(big)} x 256          : " == "  plain   720k x 256          : "
    assert f"  split+chunk 2 x ({k(big // 4)} x 128): " == "  split+chunk 2 x (180k x 128): "


def _block_density_lines(tool, u, i, nu, ni):
    """What the JAX tool's functions print for the original, degree-sorted,
    hub-split and pair-packing cases."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tool.tile_stats(u, i, nu, ni, "original")
        du, di = np.bincount(u, minlength=nu), np.bincount(i, minlength=ni)
        pu = np.empty(nu, np.int64)
        pu[np.argsort(-du)] = np.arange(nu)
        pi = np.empty(ni, np.int64)
        pi[np.argsort(-di)] = np.arange(ni)
        tool.tile_stats(pu[u], pi[i], nu, ni, "degree-sorted")
        tool.hub_split_stats(u, i, nu, ni)
        tool.pair_coverage(u, i, nu, ni)
    return out.getvalue().splitlines()


def test_block_density_prints_the_jax_tools_lines():
    jtool = _jax_tool("exp_block_density")
    argv = ["--num_users", "1500", "--num_items", "800", "--num_brands", "40"]
    res, text = _run(exp_block_density, argv + ["--styles", "latent", "heavy"])
    port_lines = text.splitlines()
    for style in ("latent", "heavy"):
        b = jsyn.synthetic_bundle(num_users=1500, num_items=800, num_brands=40,
                                  mean_degree=28.0, core=8, seed=42,
                                  **exp_block_density.style_kwargs(style))
        want = _block_density_lines(jtool, b.train.user_idx.astype(np.int64),
                                    b.train.item_idx.astype(np.int64), b.num_users,
                                    b.num_items)
        start = port_lines.index(f"--- {style} graph (bench scale) ---")
        block = port_lines[start + 1:]
        # each JAX line, in order, among the port's (which add the card's
        # break-even lines and the co-clustered ones)
        pos = 0
        for line in want:
            pos = block.index(line, pos) + 1
        card = [ln for ln in block[:pos] if f"tiles>={res['card_break_even']}:" in ln]
        assert len(card) == 4  # original, degree-sorted, co-clustered, non-hub
    assert res["card_break_even"] == exp_block_density.CARD_BREAK_EVEN_EDGES == 22
    # more edges qualify at the card's lower break-even
    for fr36, fr22 in (res["styles"]["heavy"]["original"], res["styles"]["heavy"]["non-hub"]):
        assert fr22 >= fr36


def test_block_density_coclustering_is_a_seeded_permutation():
    b = jsyn.synthetic_bundle(num_users=600, num_items=300, num_brands=20, mean_degree=28.0,
                              core=8, seed=42, style="latent")
    u, i = b.train.user_idx.astype(np.int64), b.train.item_idx.astype(np.int64)
    a = exp_block_density.cocluster_order(u, i, b.num_users, b.num_items, svd_seed=3)
    again = exp_block_density.cocluster_order(u, i, b.num_users, b.num_items, svd_seed=3)
    for p, q, n in zip(a, again, (b.num_users, b.num_items)):
        assert np.array_equal(p, q)
        assert np.array_equal(np.sort(p), np.arange(n))


def _jax_block_formulas(e, tile_a, tile_col, n_blocks, m, r_blocks, d):
    """The JAX tool's four formulas in ``jnp`` (its forcing terms dropped)."""
    t = tile_col.shape[0]
    g = jnp.take(jnp.asarray(e).reshape(n_blocks, 128 * d), jnp.asarray(tile_col),
                 axis=0).reshape(t, 128, d)
    a = jnp.asarray(tile_a)
    prod = jnp.einsum("tij,tjd->tid", a, g, preferred_element_type=jnp.float32)
    prod16 = jnp.einsum("tij,tjd->tid", a.astype(jnp.bfloat16), g.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32)
    red = prod.reshape(r_blocks, m, 128, d).sum(1).reshape(r_blocks * 128, d)
    red16 = prod16.reshape(r_blocks, m, 128, d).sum(1).reshape(r_blocks * 128, d)
    return [np.asarray(x) for x in (g.sum(0), prod.sum(0), red, red16)]


def test_block_matmul_variants_equal_the_jax_formulas():
    n_blocks, d, m, r_blocks = 12, 16, 4, 6
    rng = np.random.default_rng(0)
    case = exp_block_matmul.make_case(rng, n_blocks, d, m * r_blocks, torch.device("cpu"))
    want = _jax_block_formulas(*(x.numpy() for x in case), n_blocks, m, r_blocks, d)
    with torch.no_grad():
        got = [fn(*case, n_blocks, m, r_blocks).numpy() for _, fn in exp_block_matmul.VARIANTS]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    f32 = want[2]
    # JAX's bf16 bound: 2e-2 x max|f32|
    assert np.abs(got[3] - f32).max() <= 2e-2 * np.abs(f32).max()
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5 * np.abs(f32).max())
    res, text = _run(exp_block_matmul, ["--device", "cpu", "--n_blocks", str(n_blocks),
                                        "--d", str(d), "--configs", "4x6", "--chain", "1"])
    assert "--- T=24 tiles (4 per row-block x 6 row-blocks)" in text
    assert [r["name"] for r in res["configs"][0]["rows"]] == [
        "block gather only", "gather + batched matmul", "full (gather+mm+reduce)",
        "full, bf16 tiles", "row gather (covered edges)"]
    assert "A-tile HBM read floor f32 at 3.35 TB/s" in text


def test_bf16_accuracy_trains_both_dtypes_on_the_jax_bundle():
    res, text = _run(exp_bf16_accuracy, SMALL + ["--device", "cpu", "--epochs", "2",
                                                 "--val_interval", "1", "--batch_size", "512"])
    b = jsyn.synthetic_bundle(num_users=300, num_items=200, num_brands=12, mean_degree=28.0,
                              core=8, seed=42, style="latent")
    assert (f"graph: users={b.num_users} items={b.num_items} train={len(b.train)}"
            in text.splitlines())
    assert "SUMMARY recall@20: f32=" in text
    for dtype in ("float32", "bfloat16"):
        r = res[dtype]
        assert f"[{dtype}] best val recall@20 = {r['best_recall']:.4f}" in text
        assert len(r["curve"]) == 2 and r["best_recall"] == max(c[0] for c in r["curve"])
        assert 0 < r["best_recall"] <= 1


def test_compile_cost_variants_agree_in_fresh_processes(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the children's torch, as this module's
    res, text = _run(exp_compile_cost, SMALL + ["--device", "cpu", "--steps", "3",
                                                "--batch", "128"])
    assert set(res) == {"fused", "per-layer"}
    lf, lp = res["fused"]["first_losses"], res["per-layer"]["first_losses"]
    assert len(lf) == 3
    np.testing.assert_allclose(lp, lf, rtol=2e-5)
    for v in ("fused", "per-layer"):
        assert f"[{v:9s}] host build" in text and "compile+first" in text
        assert res[v]["startup_s"] > 0 and res[v]["process_s"] > 0


def test_build_dir_follows_the_environment(tmp_path):
    code = ("from gcn_recommendation_tpu_torch.kernels import _build\n"
            "print(_build.BUILD_DIR)\nprint(_build.library_path('quant_int8'))\n")
    env = {k: v for k, v in os.environ.items() if k != "GCN_TORCH_BUILD_DIR"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**env, "GCN_TORCH_BUILD_DIR": str(tmp_path)})
    build_dir, lib = out.stdout.split()
    assert build_dir == str(tmp_path) and os.path.dirname(lib) == str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.stdout.split()[0] == os.path.join(
        REPO, "gcn_recommendation_tpu_torch", "_build")
