"""Minimal yacs-compatible config node (attribute-access dict + YAML merge).

Copy of ``spef_tpu.config.node``: defaults-in-code, ``merge_from_file`` for
YAML overrides, ``clone``, ``dump``, and attribute access.  YAML goes through
:mod:`spef_tpu_torch.config.yamlite`, so the port needs no PyYAML.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from spef_tpu_torch.config import yamlite as yaml

__all__ = ["CfgNode"]


class CfgNode(dict):
    """dict with attribute access and recursive merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CfgNode":
        node = cls()
        for k, v in d.items():
            node[k] = cls.from_dict(v) if isinstance(v, dict) else v
        return node

    def clone(self) -> "CfgNode":
        return CfgNode.from_dict(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def merge_from_dict(self, other: Dict[str, Any]) -> None:
        for k, v in other.items():
            if k not in self:
                raise KeyError(f"Non-existent config key: {k}")
            if isinstance(self[k], CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot merge non-dict into section {k}")
                self[k].merge_from_dict(v)
            else:
                # Coerce lists to tuples when the default is a tuple (yacs-like).
                if isinstance(self[k], tuple) and isinstance(v, list):
                    v = tuple(v)
                self[k] = v

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_dict(data)

    def dump(self, stream=None) -> str:
        def _clean(d):
            return {k: _clean(v) if isinstance(v, dict) else (list(v) if isinstance(v, tuple) else v)
                    for k, v in d.items()}

        text = yaml.safe_dump(_clean(self.to_dict()), default_flow_style=False, sort_keys=False)
        if stream is not None:
            stream.write(text)
        return text
