"""Structured logging: pipeline events as JSON lines (timestamp, event name,
stable field names) to a file and/or stderr, beside the human-readable
prints.  Off until `configure` points it somewhere."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

__all__ = ["StructuredLogger", "LOGGER", "configure"]


class StructuredLogger:
    """JSON-lines event logger with bound context fields."""

    def __init__(self, stream=None, path: str | None = None, **context):
        self._stream = stream
        self._path = path
        self._ctx = context

    def bind(self, **context) -> "StructuredLogger":
        """Child logger with extra context attached to every event."""
        return StructuredLogger(self._stream, self._path,
                                **{**self._ctx, **context})

    @property
    def enabled(self) -> bool:
        """Whether events go anywhere."""
        return self._stream is not None or bool(self._path)

    def event(self, event: str, **fields) -> None:
        if not self.enabled:
            return
        rec = {"ts": round(time.time(), 3), "event": event,
               **self._ctx, **fields}
        line = json.dumps(rec, default=str)
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        if self._path:
            with open(self._path, "a") as f:
                f.write(line + "\n")

    def stage(self, name: str, seconds: float | None, items: int = 0, **fields):
        """A `stage` event; `seconds` may be None only while the logger is
        off (an untimed span's)."""
        if not self.enabled:
            return
        if items:
            fields["items"] = items
            fields["items_per_sec"] = round(items / max(seconds, 1e-9), 1)
        self.event("stage", stage=name, seconds=round(seconds, 3), **fields)


LOGGER = StructuredLogger()


def configure(path: str | None = None, stderr: bool = False) -> None:
    """Point the global logger at a file and/or stderr."""
    global LOGGER
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
    LOGGER = StructuredLogger(sys.stderr if stderr else None, path)
