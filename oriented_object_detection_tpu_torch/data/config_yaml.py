"""YOLO data-config YAML support (`datasets/GeoMap/data*.yaml`).

The reference selects ultralytics data yamls with `path`, `train`/`val`
list-file entries, a `names` class map, and optional `channels: 4`
(`Train_OBB.py:761-787`). This reader lets those configs drive the port
unchanged; yaml is imported inside ``load_data_yaml``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class DataConfig:
    path: str = "."
    train: str = ""
    val: str = ""
    names: dict = field(default_factory=dict)
    channels: int = 3

    @property
    def nc(self) -> int:
        return len(self.names)

    def train_list(self) -> str:
        return self._resolve(self.train)

    def val_list(self) -> str:
        return self._resolve(self.val)

    def _resolve(self, p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(self.path, p)


def load_data_yaml(path: str) -> DataConfig:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    names = raw.get("names", {})
    if isinstance(names, list):
        names = {i: n for i, n in enumerate(names)}
    else:
        names = {int(k): v for k, v in names.items()}

    return DataConfig(
        path=str(raw.get("path", os.path.dirname(path) or ".")),
        train=str(raw.get("train", "")),
        val=str(raw.get("val", "")),
        names=names,
        channels=int(raw.get("channels", 3)),
    )
