"""Frontend clients: asyncio-native, plus a sync wrapper for scripts/tests
(a copy of the JAX package's ``frontend/client.py``; either package's
client talks to either package's gateway).

``AsyncFrontendClient`` keeps many requests in flight on one connection: each
request carries a client-chosen ``seq``, a background reader task routes
responses (frames, shed notices, stats) back to per-seq futures, and a
``FrameDecoder`` mirrors the gateway's per-stream delta chain. The sync
``FrontendClient`` hosts the async client on a private event-loop thread and
exposes blocking calls — the shape scripts and pytest want.
"""
from __future__ import annotations

import asyncio
import itertools
import threading

import numpy as np

from repro_torch.core.projection import Camera
from repro_torch.frontend import protocol as proto
from repro_torch.frontend.encode import ENCODINGS, FrameDecoder


class ShedError(RuntimeError):
    """The gateway load-shed this request (session queue overflow)."""


class RemoteRenderError(RuntimeError):
    """The gateway answered with a non-shed error for this request."""


class AsyncFrontendClient:
    """One gateway connection; safe for many concurrent awaiting tasks."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self.hello: dict | None = None  # hello_ok header (streams listing etc.)
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._pending: dict[int, dict] = {}
        self._seq = itertools.count()
        self._decoder = FrameDecoder()
        self.frames_received = 0
        self.shed_received = 0

    @property
    def streams(self) -> dict:
        return (self.hello or {}).get("streams", {})

    # ------------------------------------------------------------- lifecycle
    async def connect(self) -> dict:
        self._reader, self._writer = await asyncio.open_connection(self.host, self.port)
        # offer the full application protocol + every encoding the decoder
        # speaks; the gateway answers with what it will actually use (a v1
        # gateway ignores the extra fields — same fallback, from its side)
        await proto.write_message(self._writer, {
            "type": proto.HELLO,
            "protocol": proto.PROTOCOL,
            "encodings": list(ENCODINGS),
        })
        msg = await proto.read_message(self._reader)
        if msg is None or msg[0].get("type") != proto.HELLO_OK:
            raise proto.ProtocolError(f"handshake failed: {msg and msg[0]}")
        self.hello = msg[0]
        self._reader_task = asyncio.ensure_future(self._read_loop())
        return self.hello

    @property
    def protocol(self) -> int:
        """Negotiated application protocol (1 until connected)."""
        return int((self.hello or {}).get("protocol", 1))

    async def close(self) -> None:
        if self._writer is not None:
            try:
                await proto.write_message(self._writer, {"type": proto.BYE})
            except ConnectionError:
                pass
            self._writer.close()
        if self._reader_task is not None:
            await asyncio.gather(self._reader_task, return_exceptions=True)
        self._fail_pending(ConnectionError("client closed"))

    # -------------------------------------------------------------- requests
    async def submit_render(
        self, stream: str, cam: Camera, *, timestep: int = 0,
        gaze: tuple | None = None, budget_ms: float | None = None,
    ) -> asyncio.Future:
        """Fire one render; returns the future (fire-many, await-later).

        ``gaze`` (normalized (x, y) in [0, 1]) and ``budget_ms`` are the
        optional foveated-serving hints: the engine sharpens the gazed tile
        rows and coarsens the periphery to fit the render-time budget. Both
        ride as optional header fields a v1 gateway simply ignores."""
        seq = next(self._seq)
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = {"kind": "render", "fut": fut}
        header = {
            "type": proto.RENDER, "seq": seq, "stream": stream,
            "timestep": int(timestep), "camera": proto.camera_to_wire(cam),
        }
        if gaze is not None:
            header["gaze"] = [float(gaze[0]), float(gaze[1])]
        if budget_ms is not None:
            header["budget_ms"] = float(budget_ms)
        await proto.write_message(self._writer, header)
        return fut

    async def render(
        self, stream: str, cam: Camera, *, timestep: int = 0,
        gaze: tuple | None = None, budget_ms: float | None = None,
    ) -> np.ndarray:
        """One frame (uint8 HxWx3). Raises ShedError if load-shed."""
        return await (await self.submit_render(
            stream, cam, timestep=timestep, gaze=gaze, budget_ms=budget_ms
        ))

    async def scrub(self, stream: str, cam: Camera, timesteps: list[int]) -> dict[int, np.ndarray]:
        """One camera across ``timesteps``; returns {timestep: frame}.
        Raises ShedError (naming the lost timesteps) if any were shed."""
        seq = next(self._seq)
        # dedupe (order-preserving): responses key by timestep, so duplicate
        # entries would leave the completion count unreachable forever
        ts = list(dict.fromkeys(int(t) for t in timesteps))
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = {
            "kind": "scrub", "fut": fut, "want": len(ts), "acc": {}, "shed": [],
        }
        await proto.write_message(self._writer, {
            "type": proto.SCRUB, "seq": seq, "stream": stream,
            "timesteps": ts,
            "camera": proto.camera_to_wire(cam),
        })
        return await fut

    async def stats(self) -> dict:
        seq = next(self._seq)
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = {"kind": "stats", "fut": fut}
        await proto.write_message(self._writer, {"type": proto.STATS, "seq": seq})
        return await fut

    async def metrics(self) -> dict:
        """The gateway's atomic typed-registry snapshot (protocol v2):
        ``{"metrics": {dotted name: value|histogram}, "trace": {...},
        "slo": {...}|None}`` — ``slo`` carries the gateway's live window
        state (p99, budget burn, ok/warn/breach) when SLO tracking is on."""
        seq = next(self._seq)
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = {"kind": "metrics", "fut": fut}
        await proto.write_message(self._writer, {"type": proto.METRICS, "seq": seq})
        return await fut

    # ---------------------------------------------------------------- reader
    async def _read_loop(self) -> None:
        try:
            while True:
                msg = await proto.read_message(self._reader)
                if msg is None:
                    break
                self._route(*msg)
        except Exception as e:  # analysis: allow(hygiene.broad_except, ANY reader death — protocol violation, undecodable frame, version skew — must fail the in-flight futures loudly; a bare return would leave every awaiting render()/scrub()/stats() hanging forever)
            self._fail_pending(e)
            return
        self._fail_pending(ConnectionError("gateway closed the connection"))

    def _route(self, header: dict, payload: bytes) -> None:
        mtype = header.get("type")
        seq = header.get("seq")
        entry = self._pending.get(seq)
        if mtype == proto.FRAME:
            frame = self._decoder.decode(header["stream"], header, payload)
            self.frames_received += 1
            if entry is None:
                return  # response to a request we gave up on
            if entry["kind"] == "render":
                del self._pending[seq]
                if not entry["fut"].done():
                    entry["fut"].set_result(frame)
            else:  # scrub accumulates until every timestep is accounted for
                entry["acc"][int(header["timestep"])] = frame
                self._maybe_finish_scrub(seq, entry)
        elif mtype == proto.ERROR:
            code = header.get("code")
            if code == "shed":
                self.shed_received += 1
            if entry is None:
                return
            if entry["kind"] == "scrub" and code == "shed":
                entry["shed"].append(int(header.get("timestep", -1)))
                self._maybe_finish_scrub(seq, entry)
                return
            del self._pending[seq]
            err = ShedError if code == "shed" else RemoteRenderError
            if not entry["fut"].done():
                entry["fut"].set_exception(err(header.get("detail", code)))
        elif mtype == proto.STATS_OK and entry is not None:
            del self._pending[seq]
            if not entry["fut"].done():
                entry["fut"].set_result(header.get("report", {}))
        elif mtype == proto.METRICS_OK and entry is not None:
            del self._pending[seq]
            if not entry["fut"].done():
                entry["fut"].set_result(
                    {"metrics": header.get("metrics", {}),
                     "trace": header.get("trace", {}),
                     "slo": header.get("slo")}
                )

    def _maybe_finish_scrub(self, seq: int, entry: dict) -> None:
        if len(entry["acc"]) + len(entry["shed"]) < entry["want"]:
            return
        del self._pending[seq]
        if entry["fut"].done():
            return
        if entry["shed"]:
            entry["fut"].set_exception(
                ShedError(f"scrub lost timesteps {sorted(entry['shed'])} to load-shedding")
            )
        else:
            entry["fut"].set_result(entry["acc"])

    def _fail_pending(self, err: BaseException) -> None:
        pending, self._pending = self._pending, {}
        for entry in pending.values():
            if not entry["fut"].done():
                entry["fut"].set_exception(err)


class FrontendClient:
    """Blocking facade: the async client on a private event-loop thread."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *, timeout: float = 120.0):
        self.timeout = timeout
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="gs-client", daemon=True
        )
        self._thread.start()
        self._cl = AsyncFrontendClient(host, port)
        self.hello = self._call(self._cl.connect())

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(self.timeout)

    @property
    def streams(self) -> dict:
        return self._cl.streams

    def render(
        self, stream: str, cam: Camera, *, timestep: int = 0,
        gaze: tuple | None = None, budget_ms: float | None = None,
    ) -> np.ndarray:
        return self._call(self._cl.render(
            stream, cam, timestep=timestep, gaze=gaze, budget_ms=budget_ms
        ))

    def scrub(self, stream: str, cam: Camera, timesteps: list[int]) -> dict[int, np.ndarray]:
        return self._call(self._cl.scrub(stream, cam, timesteps))

    def stats(self) -> dict:
        return self._call(self._cl.stats())

    def metrics(self) -> dict:
        return self._call(self._cl.metrics())

    def close(self) -> None:
        if self._loop.is_running():
            try:
                self._call(self._cl.close())
            finally:
                self._loop.call_soon_threadsafe(self._loop.stop)
                self._thread.join(self.timeout)

    def __enter__(self) -> "FrontendClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
