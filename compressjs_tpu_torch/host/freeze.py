"""Frozen-namespace helper (a copy of ``compressjs_tpu.utils.freeze``;
the reference's freeze.js wraps Object.freeze so that exported
namespaces are immutable).

Python modules cannot be frozen in place: `freeze()` returns a read-only
attribute view of a mapping or of an object's public attributes.
"""

from __future__ import annotations

import types


class FrozenNamespace:
    __slots__ = ('_data',)

    def __init__(self, data):
        object.__setattr__(self, '_data', dict(data))

    def __getattr__(self, name):
        try:
            return self._data[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        raise AttributeError('namespace is frozen')

    def __delattr__(self, name):
        raise AttributeError('namespace is frozen')

    def __iter__(self):
        return iter(self._data)

    def __contains__(self, name):
        return name in self._data

    def keys(self):
        return self._data.keys()


def freeze(obj):
    """Return an immutable view of a dict or plain object."""
    if isinstance(obj, dict):
        return FrozenNamespace(obj)
    if isinstance(obj, types.MappingProxyType):
        return FrozenNamespace(dict(obj))
    return FrozenNamespace({k: v for k, v in vars(obj).items()
                            if not k.startswith('_')})
