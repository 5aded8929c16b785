"""Training/eval logging: stdout + JSONL + optional TensorBoard.

The port's copy of ``fusionocc_tpu/utils/logging.py``: the same
``scalars.jsonl`` records.  Replaces the reference's mmengine
MMLogger/LoggerHook + LocalVisBackend (configs/fusion_occ.py:409,416-421):
scalar metrics go to a JSONL file
(machine-readable, the analog of mmengine's scalars.json consumed by
tools/analysis_tools/analyze_logs.py) and, when tensorboardX is available,
to TensorBoard event files.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, work_dir: str, use_tensorboard: bool = True):
        os.makedirs(work_dir, exist_ok=True)
        self.jsonl_path = os.path.join(work_dir, 'scalars.jsonl')
        self._jsonl = open(self.jsonl_path, 'a')
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(work_dir, 'tb'))
            except ImportError:
                pass
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float],
            prefix: str = 'train') -> None:
        rec = {'step': int(step), 'time': round(time.time() - self._t0, 2),
               **{f'{prefix}/{k}': float(v) for k, v in scalars.items()}}
        self._jsonl.write(json.dumps(rec) + '\n')
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f'{prefix}/{k}', float(v), int(step))

    def log_image(self, step: int, name: str, img) -> None:
        """Log an (H, W, 3) uint8 image — TensorBoard when available, plus a
        PNG under work_dir/images (the LocalVisBackend analog,
        configs/fusion_occ.py:416-421)."""
        import numpy as np
        img = np.asarray(img)
        if self._tb is not None:
            self._tb.add_image(name, img, int(step), dataformats='HWC')
        img_dir = os.path.join(os.path.dirname(self.jsonl_path), 'images')
        os.makedirs(img_dir, exist_ok=True)
        safe = name.replace('/', '_')
        try:
            from PIL import Image
            Image.fromarray(img).save(
                os.path.join(img_dir, f'{safe}_{int(step):07d}.png'))
        except ImportError:
            np.save(os.path.join(img_dir, f'{safe}_{int(step):07d}.npy'), img)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def load_scalars(work_dir: str):
    """Parse scalars.jsonl (the analyze_logs.py input equivalent)."""
    path = os.path.join(work_dir, 'scalars.jsonl')
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
