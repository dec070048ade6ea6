"""The port's parquet reader and writer (``data/parquet.py``) against
pandas / pyarrow, and the dataset paths that now run without pandas.

* files pandas/pyarrow write are read back exactly, case by case (codec,
  data page version, type, row groups, dictionary fallback, empty);
* files ``write_columns`` writes read back equal through pandas;
* what the reader does not support raises ``ValueError`` naming it;
* the port's ``load_preprocessed_data`` equals the JAX package's on a
  dataset the JAX generator wrote (arrays and graph; the debug subsample
  too);
* a process where ``import pandas`` fails runs the port's ``prepare
  --recipe synthetic``, ``train``, ``test`` and ``recommend`` on the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from gcn_recommendation_tpu.data import synthetic as jsyn
from gcn_recommendation_tpu.data.loader import load_preprocessed_data as jax_load
from gcn_recommendation_tpu_torch.data import parquet
from gcn_recommendation_tpu_torch.data.loader import load_preprocessed_data
from gcn_recommendation_tpu_torch.data.parquet import read_columns, write_columns
from test_torch_synthetic import _assert_same_bundle
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame(n, seed=0):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        # sorted, many repeats: long RLE runs in the dictionary indices
        "user_idx": np.sort(rng.integers(0, max(1, n // 7), n)).astype(np.int32),
        # few distinct values: a dictionary that fits
        "item_idx": rng.integers(0, 300, n).astype(np.int32),
        # wide int64 values: a dictionary that outgrows a small page limit
        "stamp": rng.integers(-2**40, 2**40, n).astype(np.int64),
    })


WRITE_CASES = {
    "snappy_v1": (20_000, dict()),
    "uncompressed_v1": (20_000, dict(compression="none")),
    "snappy_v2": (20_000, dict(data_page_version="2.0")),
    "uncompressed_v2": (20_000, dict(data_page_version="2.0", compression="none")),
    "row_groups": (20_000, dict(row_group_size=3_000)),
    "dictionary_fallback": (20_000, dict(dictionary_pagesize_limit=2_048)),
    "dictionary_fallback_v2": (20_000, dict(dictionary_pagesize_limit=2_048,
                                            data_page_version="2.0")),
    "plain_no_dictionary": (20_000, dict(use_dictionary=False)),
    "small_pages": (20_000, dict(data_page_size=4_096)),
    "format_1_0_plain_dictionary": (5_000, dict(version="1.0")),
    "required_columns": (5_000, dict(schema_required=True)),
    "one_row": (1, dict()),
    "empty": (0, dict()),
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
def test_reads_what_pyarrow_writes(tmp_path, case):
    n, kw = WRITE_CASES[case]
    df = _frame(n)
    table = pa.Table.from_pandas(df, preserve_index=False)
    if kw.pop("schema_required", False):
        table = table.cast(pa.schema([pa.field(f.name, f.type, nullable=False)
                                      for f in table.schema]))
    path = str(tmp_path / "f.parquet")
    pq.write_table(table, path, **kw)
    got = read_columns(path)
    assert list(got) == list(df.columns)
    for c in df.columns:
        assert got[c].dtype == df[c].dtype, c
        np.testing.assert_array_equal(got[c], df[c].to_numpy())
        assert got[c].flags.writeable


def test_reads_what_pandas_to_parquet_writes(tmp_path):
    """The JAX package's writers call ``DataFrame.to_parquet(index=False)``."""
    df = _frame(50_000, seed=3)[["user_idx", "item_idx"]]
    path = str(tmp_path / "train.parquet")
    df.to_parquet(path, index=False)
    got = read_columns(path)
    pd.testing.assert_frame_equal(pd.DataFrame(got), pd.read_parquet(path), check_exact=True)


@pytest.mark.parametrize("n,page_values", [(0, None), (1, None), (5_000, None), (5_000, 1_000),
                                           (5_001, 1_000)])
def test_written_files_read_back_through_pandas(tmp_path, monkeypatch, n, page_values):
    if page_values:
        monkeypatch.setattr(parquet, "WRITE_PAGE_VALUES", page_values)
    df = _frame(n, seed=1)
    path = str(tmp_path / "w.parquet")
    write_columns(path, {c: df[c].to_numpy() for c in df.columns})
    pd.testing.assert_frame_equal(pd.read_parquet(path), df, check_exact=True)
    got = read_columns(path)
    for c in df.columns:
        np.testing.assert_array_equal(got[c], df[c].to_numpy())
    assert not os.path.exists(path + f".{os.getpid()}.tmp")


def test_writer_refuses_what_it_cannot_write(tmp_path):
    path = str(tmp_path / "w.parquet")
    with pytest.raises(ValueError, match="must be 1-D int32 or int64"):
        write_columns(path, {"x": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="different lengths"):
        write_columns(path, {"x": np.zeros(3, np.int32), "y": np.zeros(4, np.int32)})


def _unsupported(tmp_path, case):
    path = str(tmp_path / "u.parquet")
    ints = pa.array([1, 2, 3], pa.int32())
    if case == "null":
        pq.write_table(pa.table({"x": pa.array([1, None, 3], pa.int32())}), path)
    elif case == "null_v2":
        pq.write_table(pa.table({"x": pa.array([1, None, 3], pa.int32())}), path,
                       data_page_version="2.0")
    elif case == "double":
        pq.write_table(pa.table({"x": pa.array([1.0, 2.0])}), path)
    elif case == "string":
        pq.write_table(pa.table({"x": pa.array(["a", "b"])}), path)
    elif case == "zstd":
        pq.write_table(pa.table({"x": ints}), path, compression="zstd")
    elif case == "gzip":
        pq.write_table(pa.table({"x": ints}), path, compression="gzip")
    elif case == "int8":
        pq.write_table(pa.table({"x": pa.array([1, 2], pa.int8())}), path)
    elif case == "uint32":
        pq.write_table(pa.table({"x": pa.array([1, 2], pa.uint32())}), path)
    elif case == "delta":
        pq.write_table(pa.table({"x": ints}), path, use_dictionary=False,
                       column_encoding="DELTA_BINARY_PACKED")
    elif case == "nested":
        pq.write_table(pa.table({"x": pa.array([[1], [2, 3]], pa.list_(pa.int32()))}), path)
    elif case == "not_parquet":
        with open(path, "wb") as f:
            f.write(b"user_idx,item_idx\n1,2\n")
    elif case == "truncated":
        pq.write_table(pa.table({"x": ints}), path)
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:8] + data[-8:])
    return path


UNSUPPORTED = {
    "null": "null value", "null_v2": "null value", "double": "type DOUBLE",
    "string": "type BYTE_ARRAY", "zstd": "codec ZSTD", "gzip": "codec GZIP",
    "int8": "only plain signed integers", "uint32": "only plain signed integers",
    "delta": "encoding DELTA_BINARY_PACKED", "nested": "nested",
    "not_parquet": "not a parquet file", "truncated": "parquet:",
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_raises_on_what_it_does_not_read(tmp_path, case):
    path = _unsupported(tmp_path, case)
    with pytest.raises(ValueError, match=UNSUPPORTED[case]):
        read_columns(path)


def test_damaged_snappy_page_raises():
    good = bytes([5, 4 << 2]) + b"abcde"  # length 5, one literal of 5
    assert parquet.snappy_decompress(good) == b"abcde"
    for bad in (bytes([5, 4 << 2]) + b"abc",          # truncated literal
                bytes([5, 0b01 | (1 << 2), 3]),       # copy before the start
                bytes([9, 4 << 2]) + b"abcde",        # short of the declared length
                bytes([0x80, 0x80, 0x80, 0x80, 0x80, 0x80])):  # endless preamble
        with pytest.raises(ValueError, match="bad SNAPPY page"):
            parquet.snappy_decompress(bad)


def test_native_decoder_that_does_not_build_raises(tmp_path, monkeypatch):
    """No quiet Python fallback: a SNAPPY file raises when the library
    cannot be built; the writer's PLAIN, uncompressed files need none."""
    from gcn_recommendation_tpu_torch.data import native_ext

    def no_compiler(*a, **k):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(parquet, "_native", None)
    monkeypatch.setattr(native_ext, "build_library", no_compiler)
    df = _frame(100)
    snappy = str(tmp_path / "s.parquet")
    df.to_parquet(snappy, index=False)
    with pytest.raises(RuntimeError, match="native decoder did not build"):
        read_columns(snappy)
    plain = str(tmp_path / "p.parquet")
    write_columns(plain, {c: df[c].to_numpy() for c in df.columns})
    np.testing.assert_array_equal(read_columns(plain)["stamp"], df["stamp"].to_numpy())


@pytest.mark.parametrize("debug", [False, True], ids=["full", "debug_subsample"])
@pytest.mark.parametrize("use_brand", [True, False], ids=["brand", "no_brand"])
def test_loader_equals_jax_on_a_jax_written_dataset(tmp_path, debug, use_brand):
    d = jsyn.generate_synthetic_dataset(str(tmp_path / "d"), num_users=900, num_items=300,
                                        num_brands=12, mean_degree=12.0, core=4, seed=7,
                                        style="latent", embedding_dim=8)
    kw = dict(use_brand=use_brand, debug=debug, verbose=False)
    got = load_preprocessed_data(d, rng=np.random.default_rng(3), **kw)
    want = jax_load(d, rng=np.random.default_rng(3), **kw)
    if debug:
        assert len(np.unique(got.train.user_idx)) == 9  # 1% of 900 users
    _assert_same_bundle(got, want)


NO_PANDAS_SCRIPT = r"""
import sys
for name in ("pandas", "pyarrow", "jax", "gcn_recommendation_tpu", "tools"):
    sys.modules[name] = None  # any import of these now raises ImportError
from gcn_recommendation_tpu_torch import cli
data, out = sys.argv[1], sys.argv[2]
assert cli.main(["prepare", "--recipe", "synthetic", "--num_users", "120", "--num_items", "80",
                 "--num_brands", "8", "--mean_degree", "9", "--core", "3",
                 "--embedding_dim", "8", "--output_dir", data]) == 0
common = ["--processed_dir", data, "--device", "cpu", "--output_root", out, "--core", "3"]
assert cli.main(["train", *common, "--epochs", "1", "--val_interval", "1",
                 "--batch_size", "256"]) == 0
assert cli.main(["test", *common]) == 0
assert cli.main(["recommend", *common, "--users", "3,7", "--k", "5"]) == 0
bad = sorted(k for k in sys.modules if sys.modules[k] is not None and
             k.split(".")[0] in ("pandas", "pyarrow", "jax", "gcn_recommendation_tpu", "tools"))
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""


def test_cli_runs_with_pandas_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", NO_PANDAS_SCRIPT, str(tmp_path / "data"), str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "Recall@20" in res.stdout and "user 3:" in res.stdout
    assert "LOADED []" in res.stdout
