"""Asyncio TCP gateway: the network door onto the serving engine.

One event loop owns every connection; the blocking world (the render dispatch,
``FrameFuture.result()``, zlib) never runs on it:

  reader task (per conn)   parse messages, admission-control into the
                           session's bounded queue, answer shed/bad requests
  dispatcher task (one)    collect a *wave* — up to ``wave_per_session``
                           queued requests from every live session, round-
                           robin fair — and hand it to the render executor
  render executor (1 thr)  the only thread that touches the RenderServer:
                           submit the wave, drain the pipelined ring, return
                           frames. Single-threaded by design — the serving
                           engine is not thread-safe, and one thread is all
                           it needs (the device does the parallel work)
  encode executor (1 thr)  RGB8 quantization + zlib delta compression

A wave is the network-side analogue of the micro-batcher's wavefront: every
session contributes its oldest queued requests, so concurrent clients
coalesce into large micro-batches and identical poses dedup in flight, while
the per-session quota keeps one chatty client from monopolizing a wave.
Responses are written frame-by-frame as the wave retires; each full message
is composed before a single ``write`` call, so the reader task (shed errors)
and the dispatcher (frames) can safely share one writer.
"""
from __future__ import annotations

import asyncio
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

from repro_torch.analysis import tsan
from repro_torch.frontend import protocol as proto
from repro_torch.frontend.sessions import PendingRender, Session, SessionManager
from repro_torch.obs import SLOTracker, new_request_id
from repro_torch.obs.clock import now as _now

# error codes
SHED = "shed"                  # load-shedding dropped this queued request
BAD_REQUEST = "bad_request"    # unknown stream/timestep or malformed fields
RENDER_ERROR = "render_error"  # the serving engine failed this request


class Gateway:
    """One TCP endpoint multiplexing sessions onto a ``SessionManager``."""

    def __init__(
        self,
        manager: SessionManager,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        queue_limit: int = 8,
        wave_per_session: int = 4,
        delta_encoding: bool = True,
        coalesce_ms: float = 2.0,
        inline_encode_bytes: int = 1 << 20,
        gil_switch_interval_s: float | None = 5e-4,
        slo: dict | None = None,
    ):
        self.manager = manager
        self.host = host
        self.port = port  # 0 = ephemeral; the bound port replaces it on start
        self.queue_limit = queue_limit
        self.wave_per_session = wave_per_session
        self.delta_encoding = delta_encoding
        self.coalesce_ms = coalesce_ms
        self.inline_encode_bytes = inline_encode_bytes
        self.gil_switch_interval_s = gil_switch_interval_s
        self._prev_switch_interval: float | None = None

        self._server: asyncio.base_events.Server | None = None
        self._dispatch_task: asyncio.Task | None = None
        self._deliver_task: asyncio.Task | None = None  # tail of the chain
        self._conn_tasks: set[asyncio.Task] = set()
        self._sessions: dict[int, Session] = {}
        self._writers: dict[int, asyncio.StreamWriter] = {}
        self._render_exec = ThreadPoolExecutor(1, thread_name_prefix="gs-render")
        self._encode_exec = ThreadPoolExecutor(1, thread_name_prefix="gs-encode")
        self._work: asyncio.Event | None = None  # created on the serving loop
        self._gate: asyncio.Event | None = None
        self._closed = False

        # the stack's shared observability bundle: the manager owns it, the
        # engine + cache + sessions already meter onto it, and the gateway
        # registers its tier under gateway.* — so the stats/metrics wire
        # messages and frontend_load read ONE atomic snapshot instead of
        # mixing loop-thread counters with render-thread counters mid-update
        self.obs = manager.obs
        m = self.obs.metrics
        # wave-cycle phase accounting: where a served frame's wall-clock
        # goes — render executor vs encode vs socket
        self._c_render_wait_s = m.counter("gateway.render_wait_s")
        self._c_encode_wait_s = m.counter("gateway.encode_wait_s")
        self._c_write_s = m.counter("gateway.write_s")
        self._c_frames_sent = m.counter("gateway.frames_sent")
        self._c_shed_sent = m.counter("gateway.shed")
        self._c_protocol_errors = m.counter("gateway.protocol_errors")
        self._c_request_errors = m.counter("gateway.request_errors")
        self._c_dropped_writes = m.counter("gateway.dropped_writes")
        self._c_delivery_errors = m.counter("gateway.delivery_errors")
        self._c_engine_errors = m.counter("gateway.engine_errors")
        self._c_delta_resets = m.counter("gateway.delta_resets")
        self._c_partial_resets = m.counter("gateway.partial_resets")
        self._c_bytes_out = m.counter("gateway.bytes_out")
        self._c_waves = m.counter("gateway.waves")
        self._c_connections = m.counter("gateway.connections_total")
        # end-to-end served latency (admit -> socket write done, ms): the
        # histogram the SLO tracker windows and bench stage blocks report
        self._h_request_ms = m.histogram("gateway.request_ms")
        # live SLO monitoring (opt-in): ``slo`` is SLOTracker kwargs, e.g.
        # {"p99_ms": 250, "window_s": 30, "budget": 0.01} — the parsed form
        # of the CLI's --slo flag. Surfaced in stats + the metrics message.
        self.slo = SLOTracker(m, **slo) if slo else None

        # opt-in runtime race sanitizer (REPRO_TSAN=1; no-op otherwise).
        # The listed fields are written once by the serving loop thread
        # after construction — ordered by GatewayThread._ready, which
        # start() waits on before any caller can touch the gateway.
        tsan.attach(
            self, name="Gateway", dicts=("_sessions", "_writers"),
            ordered=("port", "_server", "_dispatch_task", "_deliver_task",
                     "_conn_tasks", "_work", "_gate", "_closed",
                     "_prev_switch_interval"),
        )

    # historical attribute reads, now backed by the shared registry
    @property
    def render_wait_s(self) -> float:
        return self._c_render_wait_s.value

    @property
    def encode_wait_s(self) -> float:
        return self._c_encode_wait_s.value

    @property
    def write_s(self) -> float:
        return self._c_write_s.value

    @property
    def frames_sent(self) -> int:
        return self._c_frames_sent.value

    @property
    def shed_sent(self) -> int:
        return self._c_shed_sent.value

    @property
    def protocol_errors(self) -> int:
        return self._c_protocol_errors.value

    @property
    def request_errors(self) -> int:
        return self._c_request_errors.value

    @property
    def dropped_writes(self) -> int:
        return self._c_dropped_writes.value

    @property
    def delivery_errors(self) -> int:
        return self._c_delivery_errors.value

    @property
    def engine_errors(self) -> int:
        return self._c_engine_errors.value

    @property
    def delta_resets(self) -> int:
        """Full-stream invalidations -> forced keyframes."""
        return self._c_delta_resets.value

    @property
    def partial_resets(self) -> int:
        """Row-granular invalidations -> forced tile rows (chain kept)."""
        return self._c_partial_resets.value

    @property
    def bytes_out(self) -> int:
        return self._c_bytes_out.value

    @property
    def waves(self) -> int:
        return self._c_waves.value

    @property
    def connections_total(self) -> int:
        return self._c_connections.value

    # -------------------------------------------------------------- lifecycle
    async def start(self) -> "Gateway":
        assert self.manager.server is not None, "register streams before start()"
        if self.gil_switch_interval_s is not None:
            # the serving hot path ping-pongs between the event loop, the
            # render thread, and the encode thread; CPython's default 5 ms
            # GIL switch interval turns every hand-off into milliseconds of
            # wakeup latency (measured 2-3x aggregate fps on a 2-core host).
            # Process-wide by nature; pass None to leave it alone; restored
            # on aclose() so embedders are not permanently rescheduled.
            self._prev_switch_interval = sys.getswitchinterval()
            sys.setswitchinterval(self.gil_switch_interval_s)
        self._work = asyncio.Event()
        self._gate = asyncio.Event()
        self._gate.set()
        self._server = await asyncio.start_server(self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._dispatch_task = asyncio.ensure_future(self._dispatch_loop())
        return self

    async def serve_forever(self) -> None:
        assert self._server is not None, "start() first"
        await self._server.serve_forever()

    def run_on_engine(self, fn, *args):
        """Run ``fn`` on the render-executor thread; returns its Future.

        The public hook for engine maintenance from outside the loop
        (cache invalidation between benchmark laps, model hot-swaps): the
        single render executor is the only thread allowed to touch the
        serving engine, and queueing through it serializes behind any
        in-flight wave instead of racing one."""
        return self._render_exec.submit(fn, *args)

    def pause(self) -> None:
        """Hold dispatch (admission + shedding continue). Loop thread only."""
        self._gate.clear()

    def resume(self) -> None:
        self._gate.set()

    async def aclose(self) -> None:
        """Stop accepting, drop connections, close the serving engine."""
        if self._closed:
            return
        self._closed = True
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._dispatch_task is not None:
            self._dispatch_task.cancel()
            await asyncio.gather(self._dispatch_task, return_exceptions=True)
        if self._deliver_task is not None:  # flush in-flight responses first
            await asyncio.gather(self._deliver_task, return_exceptions=True)
        for writer in list(self._writers.values()):
            writer.close()
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        # the render executor serializes this behind any in-flight wave, so
        # the engine closes from the same (only) thread that ever drove it
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._render_exec, self.manager.close)
        self._render_exec.shutdown(wait=True)
        self._encode_exec.shutdown(wait=True)
        if self._prev_switch_interval is not None:
            sys.setswitchinterval(self._prev_switch_interval)
            self._prev_switch_interval = None

    # ------------------------------------------------------------ connections
    async def _handle_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        cfg = self.manager.cfg
        session = Session(
            queue_limit=self.queue_limit,
            delta_encoding=self.delta_encoding,
            tile=(cfg.tile_h, cfg.tile_w),
            metrics=self.obs.metrics,
        )
        self._sessions[session.session_id] = session
        self._writers[session.session_id] = writer
        self._conn_tasks.add(asyncio.current_task())
        self._c_connections.inc()
        try:
            while True:
                try:
                    # requests carry everything in the header; a peer
                    # declaring a fat payload is hostile or confused
                    msg = await proto.read_message(reader, max_payload=1 << 16)
                except proto.ProtocolError as e:
                    # framing is gone — tell the peer once and hang up
                    self._c_protocol_errors.inc()
                    await self._send(session, {"type": proto.ERROR, "code": BAD_REQUEST,
                                               "detail": str(e)})
                    break
                if msg is None:
                    break
                header, _payload = msg
                if not await self._handle_message(session, header):
                    break
        except (asyncio.CancelledError, ConnectionError):
            pass
        finally:
            self._sessions.pop(session.session_id, None)
            self._writers.pop(session.session_id, None)
            self._conn_tasks.discard(asyncio.current_task())
            session.queue.clear()  # abandoned: the client is gone
            writer.close()

    async def _handle_message(self, session: Session, header: dict) -> bool:
        """Process one parsed message; False ends the connection."""
        mtype = header.get("type")
        seq = header.get("seq")
        if mtype == proto.HELLO:
            # application-protocol negotiation: a v1 hello (no protocol
            # field / no tiles8 offer) keeps the v1 zdelta8 wire format
            negotiated = session.negotiate(
                header.get("protocol", 1), header.get("encodings")
            )
            await self._send(session, {
                "type": proto.HELLO_OK,
                "protocol": negotiated,
                "encodings": session.encoder.offered(),
                "tile": list(session.tile),
                "streams": self.manager.describe(),
                "img_h": self.manager.cfg.img_h,
                "img_w": self.manager.cfg.img_w,
                "delta": self.delta_encoding,
                "session": session.session_id,
            })
        elif mtype == proto.RENDER:
            await self._admit_renders(session, header, [header.get("timestep", 0)])
        elif mtype == proto.SCRUB:
            ts = header.get("timesteps") or []
            if isinstance(ts, list):
                # defensive dedupe for third-party clients: one response per
                # timestep is the contract a per-seq fan-in counts against
                try:
                    ts = list(dict.fromkeys(ts))
                except TypeError:
                    pass  # unhashable entries become bad_request in _admit_renders
            if not isinstance(ts, list) or not ts:
                self._c_request_errors.inc()
                session.errors_sent += 1
                await self._send(session, {"type": proto.ERROR, "seq": seq,
                                           "code": BAD_REQUEST,
                                           "detail": "scrub needs a timesteps list"})
                return True
            await self._admit_renders(session, header, ts)
        elif mtype == proto.STATS:
            # session/gateway counters snapshot on the LOOP thread (they are
            # mutated here — reading them from another thread races dict
            # iteration); only the engine report crosses to the render
            # executor, whose single thread owns every server metric
            report = self._gateway_stats()
            loop = asyncio.get_running_loop()
            report.update(await loop.run_in_executor(
                self._render_exec, self.manager.report
            ))
            await self._send(session, {"type": proto.STATS_OK, "seq": seq,
                                       "report": report})
        elif mtype == proto.METRICS:
            # the typed-registry view: one ATOMIC flat snapshot (no executor
            # hop needed — the registry lock makes cross-thread reads safe)
            rec = self.obs.trace
            await self._send(session, {
                "type": proto.METRICS_OK, "seq": seq,
                "metrics": self.obs.metrics.snapshot(),
                "trace": {"enabled": bool(rec), "recorded": rec.recorded,
                          "dropped": rec.dropped},
                "slo": self.slo.report() if self.slo is not None else None,
            })
        elif mtype == proto.BYE:
            return False
        else:
            self._c_protocol_errors.inc()
            session.errors_sent += 1
            await self._send(session, {"type": proto.ERROR, "seq": seq,
                                       "code": BAD_REQUEST,
                                       "detail": f"unknown message type {mtype!r}"})
        return True

    async def _admit_renders(
        self, session: Session, header: dict, timesteps: list
    ) -> None:
        """Admission-control render/scrub items into the session queue."""
        seq = header.get("seq")
        stream_id = header.get("stream", "")
        try:
            cam = proto.camera_from_wire(header.get("camera") or {})
            resolved = [
                (int(t), self.manager.resolve(stream_id, t)) for t in timesteps
            ]
            # optional foveation hints (protocol v2 extras, both may be absent)
            budget_ms = header.get("budget_ms")
            if budget_ms is not None:
                budget_ms = float(budget_ms)
                if not budget_ms > 0:
                    raise ValueError("budget_ms must be > 0")
            gaze = header.get("gaze")
            if gaze is not None:
                gx, gy = (float(v) for v in gaze)
                gaze = (min(max(gx, 0.0), 1.0), min(max(gy, 0.0), 1.0))
        except (proto.ProtocolError, KeyError, TypeError, ValueError) as e:
            # malformed fields (non-int timesteps included) answer with a
            # bad_request frame instead of killing the connection handler
            self._c_request_errors.inc()
            session.errors_sent += 1
            await self._send(session, {"type": proto.ERROR, "seq": seq,
                                       "code": BAD_REQUEST, "detail": str(e)})
            return
        # a scrub is ONE admission unit: its fan-out may exceed the session
        # queue limit (it is bounded by the registered timeline length), and
        # the oldest-drop shed must never evict the scrub's own items — a
        # full-timeline scrub would otherwise deterministically shed itself
        limit = max(session.queue_limit, len(resolved))
        bulk = len(resolved) > 1
        rec = self.obs.trace
        for i, (t, global_ts) in enumerate(resolved):
            # the request id is minted HERE, at admission — the root of the
            # span tree; it rides the PendingRender into RenderServer.submit
            # so engine spans join the same tree
            pr = PendingRender(
                session=session, seq=seq, stream_id=stream_id, timestep=t,
                global_ts=global_ts, cam=cam, t_admit=_now(),
                scrub_last=i == len(resolved) - 1, bulk=bulk,
                request_id=new_request_id(),
                budget_ms=budget_ms, gaze=gaze,
            )
            if rec:
                rec.record(pr.request_id, "admit", pr.t_admit,
                           session=session.session_id, seq=seq,
                           stream=stream_id, timestep=t, bulk=bulk)
            victim = session.admit(pr, limit=limit)
            if victim is not None:
                self._c_shed_sent.inc()
                victim.session.errors_sent += 1
                if rec:
                    # a shed request's tree must END visibly, not vanish:
                    # the terminated span covers admit -> shed decision
                    rec.record(victim.request_id, "shed", victim.t_admit,
                               _now(), terminated=True, seq=victim.seq,
                               stream=victim.stream_id,
                               timestep=victim.timestep)
                await self._send(victim.session, {
                    "type": proto.ERROR, "seq": victim.seq, "code": SHED,
                    "stream": victim.stream_id, "timestep": victim.timestep,
                    "detail": "session queue full: oldest request shed",
                })
        self._work.set()

    # -------------------------------------------------------------- dispatch
    async def _coalesce(self) -> None:
        """Give a concurrent wavefront one beat to finish landing.

        N clients answering the previous wave submit near-simultaneously,
        but their reader tasks need event-loop turns to parse; cutting a
        wave on the FIRST arrival renders fragment micro-batches (measured:
        mean batch 1.7 vs 4 for the same trace in-process). Hold until
        enough requests are queued to fill a device micro-batch — or the
        window expires. Worst-case added latency is ``coalesce_ms``, an
        order below a render; batching efficiency dominates."""
        if self.coalesce_ms <= 0:
            return
        target = self.manager.server.batcher.max_batch
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.coalesce_ms / 1e3
        while loop.time() < deadline:
            if sum(len(s.queue) for s in self._sessions.values()) >= target:
                return
            await asyncio.sleep(self.coalesce_ms / 8e3)

    async def _dispatch_loop(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            await self._work.wait()
            self._work.clear()
            while True:
                await self._gate.wait()
                await self._coalesce()
                wave: list[PendingRender] = []
                for session in list(self._sessions.values()):
                    wave.extend(session.take(self.wave_per_session))
                if not wave:
                    break
                self._c_waves.inc()
                t0 = _now()
                rec = self.obs.trace
                if rec:
                    # queue residency: admit -> picked up by this wave
                    wid = self._c_waves.value
                    for pr in wave:
                        rec.record(pr.request_id, "coalesce", pr.t_admit, t0,
                                   wave=wid, wave_size=len(wave))
                try:
                    results = await loop.run_in_executor(
                        self._render_exec, self._render_wave, wave
                    )
                except Exception:  # analysis: allow(hygiene.broad_except, last-ditch dispatcher survival — the loop must outlive engine surprises; counted on gateway.engine_errors)
                    self._c_engine_errors.inc()
                    continue
                finally:
                    self._c_render_wait_s.add(_now() - t0)
                # deliver (encode + write) in a CHAINED background task and
                # immediately collect the next wave: clients that request
                # ahead (any streaming viewer) keep the render thread busy
                # while the previous wave compresses and hits the sockets —
                # the gateway-level analogue of the server's in-flight ring.
                # Chaining (each deliver awaits its predecessor) preserves
                # per-session response order and the delta-encode lockstep.
                self._deliver_task = asyncio.ensure_future(
                    self._deliver(results, self._deliver_task)
                )

    async def _deliver(self, results: list, prev: asyncio.Task | None) -> None:
        if prev is not None:
            await asyncio.gather(prev, return_exceptions=True)
        try:
            await self._deliver_inner(results)
        except Exception:  # analysis: allow(hygiene.broad_except, counted on gateway.delivery_errors — a failed wave must not vanish)
            # without this, the successor's gather(return_exceptions=True)
            # would silently eat the exception and every counter would read
            # "all fine" while a whole wave of clients hangs
            self._c_delivery_errors.inc()

    async def _deliver_inner(self, results: list) -> None:
        loop = asyncio.get_running_loop()
        # a cache invalidation (model hot-swap, dirty-row drop) marks its
        # stream dirty: patch every session's delta chain for it BEFORE this
        # wave encodes. Row-granular invalidations (world-space dirty tiles)
        # only force the affected tile rows onto the wire — the chain stays
        # intact elsewhere; a full invalidation (rows=None) still cuts the
        # chain so the first post-update frame ships as a keyframe rather
        # than extending one rooted in superseded content
        for sid, rows in self.manager.take_dirty().items():
            if rows is None:
                self._c_delta_resets.inc()
            else:
                self._c_partial_resets.inc()
            for s in list(self._sessions.values()):
                s.encoder.reset(sid, rows=rows)
        t1 = _now()
        # One executor hop encodes the WHOLE wave (per-frame hops cost a
        # thread wakeup + loop wakeup each — measurable at localhost rates).
        # Small waves skip the hop entirely: an executor round-trip costs
        # milliseconds of wakeup latency under load, while quantize+zlib on
        # a few hundred KB costs tens of microseconds — "off-loop" is for
        # production-resolution frames, not for work cheaper than the hop.
        wave_bytes = sum(
            frame.nbytes for _, frame, err in results if err is None
        )
        if wave_bytes <= self.inline_encode_bytes:
            encoded = self._encode_wave(results)
        else:
            encoded = await loop.run_in_executor(
                self._encode_exec, self._encode_wave, results
            )
        t2 = _now()
        self._c_encode_wait_s.add(t2 - t1)
        rec = self.obs.trace
        for pr, err, header, payload in encoded:
            if err is not None:
                self._c_request_errors.inc()
                pr.session.errors_sent += 1
                await self._send(pr.session, {
                    "type": proto.ERROR, "seq": pr.seq, "code": RENDER_ERROR,
                    "stream": pr.stream_id, "timestep": pr.timestep,
                    "detail": str(err),
                })
                continue
            if rec:
                w0 = _now()
            ok = await self._send(pr.session, header, payload)
            if rec:
                rec.record(pr.request_id, "write", w0, _now(),
                           bytes=len(payload), ok=ok)
            if ok:
                self._c_frames_sent.inc()
                pr.session.frames_sent += 1
                # end-to-end served latency: admit -> response on the wire
                self._h_request_ms.observe((_now() - pr.t_admit) * 1e3)
        self._c_write_s.add(_now() - t2)
        if self.slo is not None:
            self.slo.tick()  # fold this wave into the SLO window promptly

    def _encode_wave(self, results: list) -> list:
        """Encode executor only: quantize+compress one wave's frames."""
        out = []
        rec = self.obs.trace
        for pr, frame, err in results:
            if err is not None:
                out.append((pr, err, None, None))
                continue
            if rec:
                e0 = _now()
            meta, payload = pr.session.encoder.encode(pr.stream_id, frame)
            if rec:
                rec.record(pr.request_id, "encode", e0, _now(),
                           encoding=meta.get("encoding"), bytes=len(payload))
            out.append((pr, None, {
                "type": proto.FRAME, "seq": pr.seq, "stream": pr.stream_id,
                "timestep": pr.timestep, "last": pr.scrub_last, **meta,
            }, payload))
        return out

    def _render_wave(self, wave: list[PendingRender]) -> list:
        """Render executor only: the sole code path touching the engine.

        Never lets an exception escape — an engine failure mid-batch becomes
        per-request error results, so the dispatcher task survives and every
        waiting client gets an answer instead of a silent permanent hang."""
        server = self.manager.server
        out, futs = [], []
        for pr in wave:
            try:
                futs.append((pr, server.submit(
                    pr.cam, timestep=pr.global_ts, client_id=pr.session.session_id,
                    t_submit=pr.t_admit,
                    request_id=pr.request_id if pr.request_id >= 0 else None,
                    gaze=pr.gaze, budget_ms=pr.budget_ms,
                )))
            except Exception as e:  # analysis: allow(hygiene.broad_except, bad submit state (e.g. closing) becomes this request's error response; counted on gateway.request_errors at delivery)
                out.append((pr, None, e))
        try:
            server.run()  # drain the queue + the pipelined in-flight ring
            run_err = None
        except Exception as e:  # analysis: allow(hygiene.broad_except, a run() failure fails every pending future below — surfaced per request, counted on gateway.request_errors)
            run_err = e
        for pr, fut in futs:
            try:
                if run_err is not None and not fut.done():
                    out.append((pr, None, run_err))
                else:
                    out.append((pr, fut.result(), None))
            except Exception as e:  # analysis: allow(hygiene.broad_except, per-request render failure becomes that request's error response; counted on gateway.request_errors at delivery)
                out.append((pr, None, e))
        return out

    async def _send(self, session: Session, header: dict, payload: bytes = b"") -> bool:
        writer = self._writers.get(session.session_id)
        if writer is None:
            self._c_dropped_writes.inc()
            return False
        try:
            self._c_bytes_out.inc(await proto.write_message(writer, header, payload))
            return True
        except (OSError, RuntimeError):  # peer vanished / transport broke
            self._c_dropped_writes.inc()
            return False

    # --------------------------------------------------------------- metrics
    def report(self) -> dict:
        """Gateway + session + serving-engine metrics. Call from the loop
        thread (or while the gateway is quiescent); the stats message
        handler composes the same parts thread-correctly."""
        return {**self._gateway_stats(), **self.manager.report()}

    def _gateway_stats(self) -> dict:
        """Gateway-tier stats from ONE atomic registry snapshot.

        Historically this mixed loop-thread counters with engine metrics the
        render executor was mutating mid-read (torn values under load); every
        gateway counter now lives on the shared registry, so a single locked
        ``snapshot()`` yields a consistent point in time regardless of which
        thread asks. Per-session dicts stay loop-thread-only (they iterate
        ``_sessions``, which only the loop mutates)."""
        snap = self.obs.metrics.snapshot()

        def g(name, default=0):
            return snap.get("gateway." + name, default)

        return {
            "gateway": {
                "host": self.host,
                "port": self.port,
                "connections_total": g("connections_total"),
                "sessions_now": len(self._sessions),
                "frames_sent": g("frames_sent"),
                "shed": g("shed"),
                "protocol_errors": g("protocol_errors"),
                "request_errors": g("request_errors"),
                "dropped_writes": g("dropped_writes"),
                "delivery_errors": g("delivery_errors"),
                "engine_errors": g("engine_errors"),
                "delta_resets": g("delta_resets"),
                "partial_resets": g("partial_resets"),
                "bytes_out": g("bytes_out"),
                "waves": g("waves"),
                "queue_limit": self.queue_limit,
                "wave_per_session": self.wave_per_session,
                "render_wait_s": round(g("render_wait_s", 0.0), 4),
                "encode_wait_s": round(g("encode_wait_s", 0.0), 4),
                "write_s": round(g("write_s", 0.0), 4),
                "slo": self.slo.report() if self.slo is not None else None,
            },
            "sessions": {s.session_id: s.stats() for s in self._sessions.values()},
        }


# --------------------------------------------------------------------------
# thread-hosted gateway (tests, benchmarks, in-process embedding)
# --------------------------------------------------------------------------
class GatewayThread:
    """Run a gateway's event loop on a daemon thread; sync start/stop."""

    def __init__(self, gateway: Gateway):
        self.gateway = gateway
        self.loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._startup_error: BaseException | None = None
        self._thread = threading.Thread(target=self._run, name="gs-gateway", daemon=True)
        # _startup_error is Event-ordered (_run sets it before _ready.set();
        # start() waits on _ready before reading) — same waiver as the
        # static pass's pragma at the write site
        tsan.attach(self, name="GatewayThread", ordered=("_startup_error",))

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        try:
            self.loop.run_until_complete(self.gateway.start())
        except BaseException as e:  # analysis: allow(hygiene.broad_except, startup failure (incl. SystemExit/KeyboardInterrupt on the loop thread) is captured and re-raised in start())
            self._startup_error = e  # analysis: allow(locks.thread_shared_write, ordered by the _ready Event: start() waits on it before reading)
            self._ready.set()
            return
        self._ready.set()
        self.loop.run_forever()
        self.loop.run_until_complete(self.loop.shutdown_asyncgens())
        self.loop.close()

    def start(self, timeout: float = 30.0) -> "GatewayThread":
        self._thread.start()
        if not self._ready.wait(timeout):
            raise TimeoutError("gateway event loop failed to come up")
        if self._startup_error is not None:
            raise self._startup_error
        return self

    @property
    def port(self) -> int:
        return self.gateway.port

    def call(self, coro, timeout: float = 60.0):
        """Run a coroutine on the gateway loop from any thread."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def call_soon(self, fn, *args) -> None:
        self.loop.call_soon_threadsafe(fn, *args)

    def stop(self, timeout: float = 60.0) -> None:
        if self._startup_error is None and self.loop.is_running():
            asyncio.run_coroutine_threadsafe(self.gateway.aclose(), self.loop).result(timeout)
            self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout)

    def __enter__(self) -> "GatewayThread":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
