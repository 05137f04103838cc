"""Multi-value LLM response cache.

A copy of lvd_tpu/text/cache.py; parity target of both: the reference's
utils/cache.py. Semantics: each prompt key maps
to a *list* of raw LLM responses; repeated lookups of the same key during one
run return successive cached entries (so ``--repeats N`` reuses N distinct
cached generations); a miss returns None and a subsequent ``add`` appends and
rewrites the JSON file. The reference keeps this state in module globals — here
it is an explicit ``ResponseCache`` object (a module-level default instance is
provided for the CLIs).
"""

from __future__ import annotations

import json
import os
from typing import Optional


class ResponseCache:
    def __init__(self, path: str = "", force_first_item: bool = False):
        self.path = path
        self.force_first_item = force_first_item
        self._store: dict[str, list[str]] = {}
        self._access_index: dict[str, int] = {}
        self.queries: dict[str, list[str]] = {}

    # -- lifecycle -----------------------------------------------------------
    def load(self, allow_nonexist: bool = True) -> None:
        if not self.path:
            raise ValueError("Cache path is not set")
        if not os.path.exists(self.path):
            if not allow_nonexist:
                raise FileNotFoundError(self.path)
            return
        with open(self.path, "r") as f:
            self._store = json.load(f)

    def save(self) -> None:
        if not self.path:
            raise ValueError("Cache path is not set")
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(self._store, f, indent=4)

    # -- access --------------------------------------------------------------
    def get(self, key: str) -> Optional[str]:
        """Return the next unread cached response for ``key`` (or None)."""
        items = self._store.setdefault(key, [])
        index = self._access_index.setdefault(key, 0)
        if index >= len(items):
            return None
        if not self.force_first_item:
            self._access_index[key] = index + 1
        value = items[index]
        self.queries.setdefault(key, []).append(value)
        return value

    def add(self, key: str, value: str) -> str:
        """Append ``value`` under ``key``, mark it consumed, persist."""
        self._store.setdefault(key, []).append(value)
        self._access_index[key] = self._access_index.get(key, 0) + 1
        self.save()
        return value

    def reset_access(self) -> None:
        self._access_index = {}
        self.queries = {}

    def values_accessed(self) -> int:
        return sum(self._access_index.values())

    def __contains__(self, key: str) -> bool:
        return bool(self._store.get(key))

    def __len__(self) -> int:
        return len(self._store)


# Default instance used by the CLIs (mirrors the reference's module globals).
default_cache = ResponseCache()


def init_cache(path: str, allow_nonexist: bool = True) -> ResponseCache:
    default_cache.path = path
    default_cache.load(allow_nonexist=allow_nonexist)
    return default_cache
