"""Console and experiment-tracker logging.

Stdlib logging to the console plus MLflow on a local sqlite file when it is
installed (imported at first use); without it, or with `no_mlflow`, metrics
go to `{logs_dir}/{run_name}_metrics.csv` as (step, name, value) rows and
figures to `{logs_dir}/{run_name}/`.
Metric names (unet/loss, unet/grad, unet/lr, ...) match the JAX package's.
Under a process group only rank 0 writes metrics, parameters and figures;
every rank logs to its console.
"""

from __future__ import annotations

import csv
import logging
import os
from datetime import datetime

from . import is_main_process


def get_run_name(prefix: str = "") -> str:
    """Timestamped run name."""
    return datetime.now().strftime(f"{prefix}_%b-%d_%H-%M-%S")


class BasicLogger:
    def __init__(self, logs_dir: str, run_name: str, no_mlflow: bool, log_interval: int):
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(levelname)s : %(message)s",
            datefmt="[%H:%M:%S]",
        )
        self.log_interval = log_interval
        self.logs_dir = logs_dir
        self.run_name = run_name
        self._mlflow = None
        self.csv_path = None
        self.writes = is_main_process()
        if not self.writes:
            return
        os.makedirs(logs_dir, exist_ok=True)
        if not no_mlflow:
            try:
                import mlflow

                mlflow.set_tracking_uri(f"sqlite:///{logs_dir}/mlflow.db")
                mlflow.set_experiment(run_name)
                self._mlflow = mlflow
            except Exception:  # mlflow missing or broken: fall back to CSV
                self.log_console("MLflow unavailable; logging metrics to CSV instead.")
        if self._mlflow is None:
            self.csv_path = os.path.join(logs_dir, f"{run_name}_metrics.csv")

    def log_metric(self, name: str, val: float, step: int) -> None:
        if not self.writes:
            return
        if self._mlflow is not None:
            self._mlflow.log_metric(name, val, step=step)
            return
        new = not os.path.exists(self.csv_path)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["step", "name", "value"])
            w.writerow([step, name, float(val)])

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        for name, val in metrics.items():
            self.log_metric(name, val, step)

    def log_figure(self, name: str, figure) -> None:
        """Log a matplotlib figure as `name` (to MLflow, else to
        {logs_dir}/{run_name}/{name}) and close it."""
        import matplotlib.pyplot as plt

        try:
            if self.writes and self._mlflow is not None:
                self._mlflow.log_figure(figure, name)
            elif self.writes:
                path = os.path.join(self.logs_dir, self.run_name, name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                figure.savefig(path)
        finally:
            plt.close(figure)

    def log_params(self, **kwargs) -> None:
        if not self.writes:
            return
        if self._mlflow is not None:
            self._mlflow.log_params(dict(kwargs))
        else:
            self.log_console(f"params: {kwargs}")

    def log_console(self, message: str) -> None:
        logging.info(message)
