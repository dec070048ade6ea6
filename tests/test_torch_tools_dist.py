"""The port's multi-process and real-data drills, run on the CPU.

* ``multiproc_dryrun``: two gloo ranks as OS processes (each waited for
  under a timeout): collectives, the sharded forward, the checkpoint kill
  and resume, and the halo run of two processes equal to one process's;
* ``real_data_dryrun``: a raw dump of one recipe's layout
  (``test_torch_prepare._raw_dump``) goes through ETL, loader and the
  debug training smoke; a missing input or an unknown recipe exits 2.
"""

import contextlib
import io

import pytest

from gcn_recommendation_tpu_torch.tools import multiproc_dryrun, real_data_dryrun
from test_torch_prepare import _raw_dump, _write_jsonl
from test_torch_spmm import one_thread  # noqa: F401  (autouse: one thread)


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_multiproc_dryrun_passes_with_two_gloo_ranks():
    rc, text = _run(multiproc_dryrun.main, ["2", "--device", "cpu", "--timeout", "300"])
    assert rc == 0, text
    assert "halo process-boundary equality: loss" in text
    assert "(2 processes == 1 process)" in text
    assert text.rstrip().endswith("multiproc_dryrun PASSED")


@pytest.fixture
def dump(tmp_path):
    reviews, meta = _raw_dump("amazon_books_emb", seed=11, n_users=60, n_items=30, per_user=10)
    _write_jsonl(tmp_path / "reviews.jsonl", reviews, raw_lines=['{"user_id": "u0", "it', "[]"])
    _write_jsonl(tmp_path / "meta.jsonl", meta, raw_lines=['{"item_id": "i1", "emb'])
    return str(tmp_path / "reviews.jsonl"), str(tmp_path / "meta.jsonl")


def test_real_data_dryrun_passes_on_a_raw_dump(dump, tmp_path):
    reviews, meta = dump
    rc, text = _run(real_data_dryrun.main, [
        "--recipe", "amazon_books_emb", "--review_path", reviews, "--meta_path", meta,
        "--core", "3", "--full_dir", str(tmp_path / "out"), "--device", "cpu"])
    assert rc == 0, text
    for stage in ("stage 1/3: ETL", "stage 2/3: loader", "stage 3/3", "debug-train best recall",
                  "dryrun OK"):
        assert stage in text
    assert "skipped" in text  # the malformed lines were counted, not fatal


def test_real_data_dryrun_exits_2_on_bad_input(dump, tmp_path):
    reviews, meta = dump
    rc, text = _run(real_data_dryrun.main, ["--recipe", "amazon_books_emb", "--review_path",
                                            str(tmp_path / "nope.jsonl"), "--meta_path", meta])
    assert rc == 2 and "missing input file" in text
    rc, text = _run(real_data_dryrun.main, ["--recipe", "nope", "--review_path", reviews,
                                            "--meta_path", meta])
    assert rc == 2 and "unknown recipe" in text
