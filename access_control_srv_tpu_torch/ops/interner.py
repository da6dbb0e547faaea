"""String interning for the policy compiler and request encoder.

Every URN / attribute value that participates in matching is mapped to a
dense int32 id.  Derived ids are computed once per distinct string:

- ``suffix_id``  -- the value after the last ``#`` (regex-mode property
  comparison, reference: src/core/accessController.ts:567-574);
- ``tail_id``    -- the value after the last ``:`` (entity name used for
  property-relevance, reference: :515-516);
- ``prefix_id``  -- the value before the last ``:`` (namespace prefix
  comparison in regex entity matching, reference: :545-548).

Interning is cached, so encoding cost is paid once per *distinct* string,
not once per request.
"""

from __future__ import annotations

ABSENT = -1  # padding / absent sentinel in all tensor encodings


class StringInterner:
    def __init__(self):
        self._ids: dict[str, int] = {}
        self._strings: list[str] = []
        self.suffix_id: list[int] = []
        self.tail_id: list[int] = []
        self.prefix_id: list[int] = []

    def __len__(self) -> int:
        return len(self._strings)

    def intern(self, value: str) -> int:
        if value is None:
            return ABSENT
        existing = self._ids.get(value)
        if existing is not None:
            return existing
        idx = len(self._strings)
        self._ids[value] = idx
        self._strings.append(value)
        # reserve derived slots first (intern() below may recurse)
        self.suffix_id.append(ABSENT)
        self.tail_id.append(ABSENT)
        self.prefix_id.append(ABSENT)
        suffix = value.rsplit("#", 1)[-1]
        tail = value[value.rfind(":") + 1:] if ":" in value else value
        prefix = value[: value.rfind(":")] if ":" in value else ""
        self.suffix_id[idx] = idx if suffix == value else self.intern(suffix)
        self.tail_id[idx] = idx if tail == value else self.intern(tail)
        self.prefix_id[idx] = idx if prefix == value else self.intern(prefix)
        return idx

    def lookup(self, value: str) -> int:
        """Id of an already-interned string, or ABSENT."""
        if value is None:
            return ABSENT
        return self._ids.get(value, ABSENT)

    def string(self, idx: int) -> str:
        return self._strings[idx]
