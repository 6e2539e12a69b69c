"""Process-wide context singleton (reference
``python/fedml/core/alg_frame/context.py``): a key/value store algorithms use
to smuggle side-channel info between hooks without widening signatures."""

from __future__ import annotations

from typing import Any, Dict


class Context:
    KEY_TEST_DATA = "test_data"
    KEY_CLIENT_ID_LIST = "client_id_list"
    KEY_METRICS = "metrics"

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._store: Dict[str, Any] = {}
        return cls._instance

    def add(self, key: str, value: Any):
        self._store[key] = value

    def get(self, key: str, default=None):
        return self._store.get(key, default)

    def clear(self):
        self._store.clear()
