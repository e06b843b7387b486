"""Attribute scoping: a copy of `mxnet_tpu/attribute.py` (the reference's
`python/mxnet/attribute.py`), kept in the port so it imports nothing of
the JAX package.

`AttrScope` carries graph attributes like `ctx_group` (model-parallel
placement), `lr_mult`/`wd_mult`, `force_mirroring` onto symbols created inside
a `with` block — the mechanism behind the reference's model-parallel LSTM
(`example/model-parallel-lstm/lstm.py:48-118`).
"""
from __future__ import annotations


class AttrScope:
    _current = None

    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("attributes must be strings")
        self._attr = kwargs
        self._old = None

    def get(self, attr):
        """Merge scope attrs with explicitly supplied ones (explicit wins)."""
        if self._attr:
            ret = dict(self._attr)
            if attr:
                ret.update(attr)
            return ret
        return dict(attr) if attr else {}

    def __enter__(self):
        self._old = AttrScope._current
        merged = dict(self._old._attr) if self._old else {}
        merged.update(self._attr)
        self._attr = merged
        AttrScope._current = self
        return self

    def __exit__(self, *args):
        AttrScope._current = self._old


AttrScope._current = AttrScope()


def current():
    return AttrScope._current
