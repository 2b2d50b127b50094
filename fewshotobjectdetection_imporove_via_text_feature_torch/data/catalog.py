"""Dataset and metadata catalogs: plain-dict equivalents of detectron2's
DatasetCatalog/MetadataCatalog, counterpart of the JAX package's
``data/catalog.py``."""

from __future__ import annotations

from typing import Callable, Dict


class _DatasetCatalog:
    def __init__(self):
        self._registry: Dict[str, Callable] = {}

    def register(self, name: str, fn: Callable):
        if name in self._registry:
            raise KeyError(f"Dataset {name!r} already registered")
        self._registry[name] = fn

    def get(self, name: str):
        if name not in self._registry:
            raise KeyError(
                f"Dataset {name!r} not registered; have "
                f"{len(self._registry)} datasets"
            )
        return self._registry[name]()

    def remove(self, name: str):
        del self._registry[name]

    def list(self):
        return sorted(self._registry)

    def __contains__(self, name):
        return name in self._registry


class _Metadata(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def set(self, **kwargs):
        self.update(kwargs)
        return self


class _MetadataCatalog:
    def __init__(self):
        self._store: Dict[str, _Metadata] = {}

    def get(self, name: str) -> _Metadata:
        if name not in self._store:
            self._store[name] = _Metadata(name=name)
        return self._store[name]


DatasetCatalog = _DatasetCatalog()
MetadataCatalog = _MetadataCatalog()
