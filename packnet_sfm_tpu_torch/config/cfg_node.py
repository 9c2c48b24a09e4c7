"""
Lightweight yacs-compatible configuration node.

Mirrors the subset of `yacs.config.CfgNode` behaviour the reference framework
relies on (reference: configs/default_config.py, packnet_sfm/utils/config.py):
attribute access, YAML merging with type coercion, cloning, and dumping.
Implemented standalone so the framework has no yacs dependency.
"""

import copy
import yaml


class CfgNode(dict):
    """Dict with attribute access, recursive merge, and YAML (de)serialization."""

    def __init__(self, init_dict=None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            self[k] = v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name)

    # -- merge / clone ------------------------------------------------------
    def clone(self):
        return copy.deepcopy(self)

    def merge_from_dict(self, other, allow_new=True):
        """Recursively merge a plain dict / CfgNode into this node."""
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v, allow_new=allow_new)
            else:
                if k not in self and not allow_new:
                    raise KeyError('Non-existent config key: {}'.format(k))
                existing = self.get(k)
                self[k] = _coerce(v, existing)
        return self

    def merge_from_file(self, path, allow_new=True):
        with open(path, 'r') as f:
            data = yaml.safe_load(f) or {}
        return self.merge_from_dict(data, allow_new=allow_new)

    def merge_from_list(self, opts):
        """Merge from a flat ['a.b.c', value, ...] list (CLI overrides)."""
        assert len(opts) % 2 == 0, 'Override list must have even length'
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                node = node[p]
            if isinstance(value, str):
                try:
                    value = yaml.safe_load(value)
                except Exception:
                    pass
            node[parts[-1]] = _coerce(value, node.get(parts[-1]))
        return self

    # -- serialization ------------------------------------------------------
    def to_dict(self):
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self):
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def save_yaml(self, path):
        with open(path, 'w') as f:
            f.write(self.dump())

    @classmethod
    def load_yaml(cls, path):
        with open(path, 'r') as f:
            return cls(yaml.safe_load(f) or {})


def _coerce(value, existing):
    """Coerce YAML value types toward the default's type (yacs semantics:
    including literal_eval of '(a, b)'-style tuple strings)."""
    if isinstance(value, str) and value[:1] in '([{':
        import ast
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if existing is None:
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            return CfgNode(value)
        return value
    if isinstance(existing, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(existing, list) and isinstance(value, tuple):
        return list(value)
    if isinstance(existing, float) and isinstance(value, int):
        return float(value)
    if isinstance(value, dict) and not isinstance(value, CfgNode):
        return CfgNode(value)
    return value
