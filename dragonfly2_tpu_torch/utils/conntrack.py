"""Connection-task tracking for asyncio socket servers.

Python 3.12's `Server.wait_closed()` waits for every in-flight connection
handler, so a server whose client holds a long-lived stream (an announce
connection, a CONNECT/SNI tunnel) hangs shutdown forever unless the
handlers are cancelled first. Every socket server in this codebase wraps
its handler with `ConnTracker.tracked` and calls `cancel_all()` before
`wait_closed()` — one implementation instead of a copy per server."""

from __future__ import annotations

import asyncio


class ConnTracker:
    def __init__(self):
        self._conns: set[asyncio.Task] = set()

    def tracked(self, handler):
        """Wrap an `async (reader, writer)` handler so its task is
        tracked for cancel_all()."""

        async def wrapper(reader, writer):
            task = asyncio.current_task()
            self._conns.add(task)
            try:
                await handler(reader, writer)
            except asyncio.CancelledError:
                writer.close()
            finally:
                self._conns.discard(task)

        return wrapper

    async def cancel_all(self) -> None:
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
