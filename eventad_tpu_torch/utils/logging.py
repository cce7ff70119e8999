"""Experiment run logging (counterpart of ``eventad_tpu/utils/logging.py``;
reference src/dagr/utils/logging.py wires wandb: run dirs, hparams, bbox
overlay images).  Writes the same content locally: a JSONL metric stream,
``hparams.json`` and overlay PNGs, passing through to ``wandb`` only where
it can be imported.  ``cv2`` is imported only by ``log_image``."""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional


class RunLogger:
    def __init__(self, log_dir, hparams=None, use_wandb: bool = False,
                 project: str = "eventad-tpu"):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._wandb = None
        if hparams is not None:
            if dataclasses.is_dataclass(hparams):
                hparams = dataclasses.asdict(hparams)
            with open(self.dir / "hparams.json", "w") as f:
                json.dump({k: str(v) for k, v in dict(hparams).items()}, f,
                          indent=1)
        if use_wandb:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb.init(project=project, dir=str(self.dir),
                                         config=hparams)

    def log(self, metrics: dict, step: Optional[int] = None):
        rec = {"time": time.time(), **metrics}
        if step is not None:
            rec["step"] = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_image(self, name: str, image, step: int = 0):
        import cv2
        import numpy as np
        path = self.dir / f"{name}_{step}.png"
        cv2.imwrite(str(path), np.asarray(image))
        return path

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()
