"""Scalar metric sinks: CSV always, wandb when available.

Port of ``diffmst_tpu/callbacks/metrics.py``. The reference logs through
Lightning's WandbLogger; ``wandb`` is optional (not a dependency), so
``WandbLogger`` imports it when built and, as JAX's does, logs nothing
where it is missing or its ``init`` fails.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional

__all__ = ["CSVLogger", "WandbLogger"]


class CSVLogger:
    """Append-mostly CSV sink that stays well-formed when new columns appear.

    Rows with keys not yet in the header (e.g. the first epoch row after many
    train rows) trigger a full rewrite of the file with the widened header —
    earlier rows get '' in the new columns, and every value stays under its
    own column name.
    """

    def __init__(self, path: str = "logs/metrics.csv") -> None:
        self.path = path
        self._fieldnames: Optional[list] = None
        if os.path.exists(path):
            with open(path, newline="") as f:
                reader = csv.reader(f)
                header = next(reader, None)
            if header:
                self._fieldnames = list(header)

    def on_log(self, tag: str, metrics: Dict[str, float]) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        row = {"tag": tag, **metrics}
        new_keys = [k for k in row if not self._fieldnames or k not in self._fieldnames]
        if new_keys:
            widened = (self._fieldnames or []) + sorted(new_keys)
            old_rows = []
            if self._fieldnames and os.path.exists(self.path):
                with open(self.path, newline="") as f:
                    # drop the restkey (None) — rows written by a pre-fix
                    # logger can carry more fields than the header
                    old_rows = [
                        {k: v for k, v in r.items() if k is not None}
                        for r in csv.DictReader(f)
                    ]
            self._fieldnames = widened
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(
                    f, fieldnames=self._fieldnames, extrasaction="ignore"
                )
                w.writeheader()
                w.writerows(old_rows)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._fieldnames, extrasaction="ignore")
            w.writerow(row)


class WandbLogger:
    def __init__(self, project: str = "DiffMST", **init_kwargs) -> None:
        try:
            import wandb

            self._run = wandb.init(project=project, **init_kwargs)
            self._wandb = wandb
        except Exception:  # noqa: BLE001 -- JAX's: a missing or failing wandb logs nothing
            self._run = None
            self._wandb = None

    def on_log(self, tag: str, metrics: Dict[str, float]) -> None:
        if self._run is not None:
            self._wandb.log({f"{tag}/{k}": v for k, v in metrics.items()})
