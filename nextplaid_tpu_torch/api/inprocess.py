"""The port's REST server inside the calling process.

`InProcessServer(index_dir, encoder, device)` serves `build_app` with
aiohttp on its own event loop in a thread, on 127.0.0.1 at a free port, and
returns once the server listens. For harnesses and smoke runs that drive the
service through the SDK without starting a second process.
"""

from __future__ import annotations

import asyncio
import threading

from nextplaid_tpu_torch.utils.device import DeviceLike

START_TIMEOUT_S = 600  # the state's first loads and a card's kernel builds run at start
STOP_TIMEOUT_S = 120


class InProcessServer:
    """`build_app(index_dir, encoder=, device=)` served on a thread of this
    process. `url` is its address, `state` its `AppState`; `stop()` closes
    the server and joins the thread."""

    def __init__(self, index_dir: str, encoder=None, device: DeviceLike = None):
        from aiohttp import web

        from nextplaid_tpu_torch.api.server import build_app

        self.app = build_app(index_dir, encoder=encoder, device=device)
        self.loop = asyncio.new_event_loop()
        self.port = None
        started, failed = threading.Event(), []

        def run():
            asyncio.set_event_loop(self.loop)
            runner = web.AppRunner(self.app)
            try:
                self.loop.run_until_complete(runner.setup())
                self.loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", 0).start())
                self.port = runner.addresses[0][1]
            except BaseException as e:  # reported by __init__
                failed.append(e)
                started.set()
                return
            started.set()
            self.loop.run_forever()
            self.loop.run_until_complete(runner.cleanup())
            self.loop.close()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        if not started.wait(START_TIMEOUT_S) or failed:
            raise RuntimeError("the in-process server did not start") from (
                failed[0] if failed else None)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def state(self):
        return self.app["state"]

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=STOP_TIMEOUT_S)
        if self.thread.is_alive():
            raise RuntimeError("the in-process server's thread did not stop")
