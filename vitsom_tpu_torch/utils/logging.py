"""TensorBoard metric logging under the reference's tag names.

The port's own copy of ``vitsom_tpu/utils/logging.py``: the tags
(``train/recon_loss``, ``train/som_loss``, ``val/accuracy``, ``hp/gamma``,
...) are the reference's Lightning ``TensorBoardLogger`` tags, written by
the package's own event writer (``utils/tb_writer``).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from vitsom_tpu_torch.utils.tb_writer import EventFileWriter


class MetricLogger:
    """Keeps every logged scalar in ``history`` and, with a ``log_dir``,
    writes it and every image to an event file there."""

    def __init__(self, log_dir: Optional[str] = None):
        self.history: Dict[str, List[Tuple[int, float]]] = defaultdict(list)
        self._writer = EventFileWriter(log_dir) if log_dir else None

    @property
    def path(self) -> Optional[str]:
        """The event file, or None without a ``log_dir``."""
        return self._writer.path if self._writer is not None else None

    def log_scalars(self, scalars: Dict[str, float], step: int):
        for k, v in scalars.items():
            self.history[k].append((step, float(v)))
            if self._writer is not None:
                self._writer.add_scalar(k, float(v), global_step=step)

    def log_image(self, tag: str, image, step: int):
        """image: HWC float [0, 1] numpy array."""
        if self._writer is not None:
            self._writer.add_image(tag, image, global_step=step, dataformats="HWC")

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()
