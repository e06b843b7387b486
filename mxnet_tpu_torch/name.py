"""Automatic symbol naming: a copy of `mxnet_tpu/name.py` (the reference's
`python/mxnet/name.py`), kept in the port so it imports nothing of the
JAX package.  The counters are the port's own."""
from __future__ import annotations


class NameManager:
    _current = None

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old = NameManager._current
        NameManager._current = self
        return self

    def __exit__(self, *args):
        NameManager._current = self._old


class Prefix(NameManager):
    """Prepend a prefix to all auto-generated names."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


NameManager._current = NameManager()


def current():
    return NameManager._current
