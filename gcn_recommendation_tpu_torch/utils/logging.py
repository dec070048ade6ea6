"""Training-history logger with the reference's artifacts.

Copy of ``gcn_recommendation_tpu/utils/logging.py`` (reference Logger,
main.py:89-169): per-step batch losses and per-epoch (avg_loss, recall,
ndcg) in memory; ``save`` writes ``<name>_epoch_history.csv``
(``epoch,avg_loss,recall,ndcg``), ``<name>_throughput.csv``
(``epoch,examples_per_sec``) and, where matplotlib is installed, the
two-panel PNG.  The CSVs are written with the stdlib ``csv`` module, in
the bytes pandas' ``to_csv`` gives the JAX package (the card's machine
has no pandas).
"""

from __future__ import annotations

import csv
import os
from typing import List


def _write_csv(path: str, header, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(header)
        w.writerows(rows)


class Logger:
    def __init__(self, results_dir: str, model_name: str, top_k: int = 20):
        self.results_dir = results_dir
        self.model_name = model_name
        self.top_k = top_k
        os.makedirs(self.results_dir, exist_ok=True)
        self.history = {
            "step": [],
            "batch_loss": [],
            "epoch": [],
            "epoch_avg_loss": [],
            "recall": [],
            "ndcg": [],
        }
        self.throughput: List[float] = []  # examples/sec per epoch
        self.current_step = 0

    def set_start_step(self, step: int) -> None:
        """Prime the global step counter when a run resumes."""
        self.current_step = int(step)

    def log_batch_loss(self, loss: float) -> None:
        self.history["step"].append(self.current_step)
        self.history["batch_loss"].append(float(loss))
        self.current_step += 1

    def log_epoch_metrics(self, epoch: int, avg_loss: float, recall: float, ndcg: float) -> None:
        self.history["epoch"].append(int(epoch))
        self.history["epoch_avg_loss"].append(float(avg_loss))
        self.history["recall"].append(float(recall))
        self.history["ndcg"].append(float(ndcg))
        print(f"Logger: Epoch {epoch} metrics logged.")

    def log_throughput(self, examples_per_sec: float) -> None:
        self.throughput.append(float(examples_per_sec))

    def save(self, total_epochs: int) -> None:
        if not self.history["epoch"]:
            print("Logger: No epoch data to save.")
            return
        h = self.history
        csv_path = os.path.join(self.results_dir, f"{self.model_name}_epoch_history.csv")
        _write_csv(
            csv_path,
            ("epoch", "avg_loss", "recall", "ndcg"),
            zip(h["epoch"], h["epoch_avg_loss"], h["recall"], h["ndcg"]),
        )
        print(f"Epoch-level history saved to '{csv_path}'")

        if self.throughput:
            _write_csv(
                os.path.join(self.results_dir, f"{self.model_name}_throughput.csv"),
                ("epoch", "examples_per_sec"),
                enumerate(self.throughput, start=1),
            )

        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # plotting is best-effort
            return

        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 12))
        fig.suptitle(f"Training History for {self.model_name}", fontsize=16)
        if h["step"]:
            ax1.plot(h["step"], h["batch_loss"], "b-", alpha=0.3,
                     label="Per-Batch Training Loss")
        if h["epoch_avg_loss"] and self.current_step:
            avg_steps_per_epoch = self.current_step / total_epochs
            epoch_steps = [e * avg_steps_per_epoch for e in h["epoch"]]
            ax1.plot(epoch_steps, h["epoch_avg_loss"], "r-o", markersize=8,
                     label="Per-Epoch Average Loss")
        ax1.set_title("Training Loss")
        ax1.set_xlabel("Training Step")
        ax1.set_ylabel("Loss")
        ax1.grid(True)
        ax1.legend()
        ax1.set_yscale("log")

        ax2.plot(h["epoch"], h["recall"], "r-s", label=f"Recall@{self.top_k}")
        ax2.plot(h["epoch"], h["ndcg"], "g-^", label=f"NDCG@{self.top_k}")
        ax2.set_title("Evaluation Metrics per Epoch")
        ax2.set_xlabel("Epoch")
        ax2.set_ylabel("Metric Value")
        ax2.grid(True)
        ax2.legend()

        plt.tight_layout(rect=[0, 0.03, 1, 0.95])
        img_path = os.path.join(self.results_dir, f"{self.model_name}_training_curves.png")
        plt.savefig(img_path)
        print(f"Training curves plot saved to '{img_path}'")
        plt.close(fig)
