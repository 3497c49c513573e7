"""PyTorch port, the network frontend against the JAX package's: the wire
protocol's bytes, the frame encoders' headers and payloads (raw8, zdelta8,
tiles8 with ragged tiles, tile-store references, raw fallback and partial
resets) and each package decoding the other's stream; the sessions' shed
victims; the port's gateway on the CPU (``device="cpu"``) through the
reference test file's scenarios, its frames bitwise the port's in-process
frames after ``quantize_rgb8`` and within one uint8 step of the JAX
gateway's; each package's client against the other package's gateway; the
race sanitizer on the port's threaded classes; ``timeline_stream`` on the
new ``SessionManager``; and the frontend CLI.

Scenes are made with numpy from a seed (``conftest.make_scene``) and cross
to the port through ``to_port``; every socket, thread and loop wait carries
a timeout.
"""
import asyncio
import socket
import zlib

import numpy as np
import pytest
import torch

from repro.core.config import GSConfig as JGSConfig
from repro.frontend import FrameDecoder as JFrameDecoder
from repro.frontend import FrameEncoder as JFrameEncoder
from repro.frontend import FrontendClient as JFrontendClient
from repro.frontend import Gateway as JGateway
from repro.frontend import GatewayThread as JGatewayThread
from repro.frontend import SessionManager as JSessionManager
from repro.frontend import protocol as jproto
from repro.frontend.sessions import PendingRender as JPendingRender
from repro.frontend.sessions import Session as JSession
from repro.launch.frontend import synthetic_timeline as jax_synthetic_timeline
from repro_torch.analysis import tsan
from repro_torch.core.config import GSConfig
from repro_torch.frontend import (
    AsyncFrontendClient,
    CodecError,
    FrameDecoder,
    FrameEncoder,
    FrontendClient,
    Gateway,
    GatewayThread,
    PendingRender,
    ProtocolError,
    RemoteRenderError,
    Session,
    SessionManager,
    ShedError,
    iter_messages,
    pack_message,
    quantize_rgb8,
)
from repro_torch.frontend import protocol as proto
from repro_torch.insitu import TemporalCheckpointStore, timeline_stream
from repro_torch.launch import frontend as frontend_cli
from repro_torch.launch.frontend import synthetic_timeline
from repro_torch.serve_gs import RenderServer

from conftest import make_cam, make_scene
from torch_port_helpers import np_, to_port

H = W = 32
T_OUT = 30.0  # seconds: every client call, socket read and loop wait


@pytest.fixture(autouse=True)
def _port_tsan_guard():
    """Under REPRO_TSAN=1, fail a test whose threads raced on an
    instrumented port object (the port's sanitizer keeps its own list)."""
    tsan.reset()
    yield
    if tsan.enabled():
        races = tsan.take_races()
        assert not races, "tsan: " + "; ".join(str(r) for r in races)


def _scene():
    return make_scene(n=256, scale=0.06)


def _cfg():
    return GSConfig(img_h=H, img_w=W, k_per_tile=64)


def _manager(g=None, *, pipeline_depth=2, timeline_steps=2, **kw):
    """The reference test's manager on the port: one shared CPU server, a
    static stream and a synthetic drift timeline."""
    gp = to_port(g if g is not None else _scene())
    kw.setdefault("n_levels", 1)
    kw.setdefault("max_batch", 4)
    kw.setdefault("store_frames", False)
    mgr = SessionManager(_cfg(), device="cpu", pipeline_depth=pipeline_depth, **kw)
    mgr.register_static("static", gp)
    if timeline_steps:
        mgr.register_timeline("timeline", synthetic_timeline(gp, timeline_steps))
    return mgr


def _jax_manager(g=None, *, timeline_steps=2):
    g = g if g is not None else _scene()
    mgr = JSessionManager(JGSConfig(img_h=H, img_w=W, k_per_tile=64), pipeline_depth=2, n_levels=1,
                          max_batch=4, store_frames=False)
    mgr.register_static("static", g)
    if timeline_steps:
        mgr.register_timeline("timeline", jax_synthetic_timeline(g, timeline_steps))
    return mgr


def _inprocess(cams, g=None, timestep_params=None):
    """quantize_rgb8 of the port's in-process frames for ``cams``."""
    gp = timestep_params if timestep_params is not None else to_port(g if g is not None else _scene())
    with RenderServer(gp, _cfg(), device="cpu", n_levels=1, max_batch=4, store_frames=False) as srv:
        futs = [srv.submit(c) for c in cams]
        srv.run()
        return [quantize_rgb8(f.result()) for f in futs]


def _read_msg(sock):
    buf = b""
    while len(buf) < proto.PREFIX_SIZE:
        chunk = sock.recv(proto.PREFIX_SIZE - len(buf))
        assert chunk, "gateway closed the connection"
        buf += chunk
    hlen, plen = proto.unpack_prefix(buf)
    body = b""
    while len(body) < hlen + plen:
        chunk = sock.recv(hlen + plen - len(body))
        assert chunk, "gateway closed the connection"
        body += chunk
    return next(iter_messages(buf + body))


def _connect(port):
    return socket.create_connection(("127.0.0.1", port), timeout=T_OUT)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, T_OUT))


@pytest.fixture(scope="module")
def gateway_thread():
    mgr = _manager()
    mgr.warmup()
    with GatewayThread(Gateway(mgr, port=0, queue_limit=8)) as gt:
        yield gt


@pytest.fixture(scope="module")
def jax_gateway_thread():
    mgr = _jax_manager()
    mgr.warmup()
    with JGatewayThread(JGateway(mgr, port=0, queue_limit=8)) as gt:
        yield gt


# ================================================================= protocol
@pytest.mark.parametrize("size", [0, 1, 2, 7, 64, 1023, 4096, 65537])
def test_pack_message_bytes_equal_jax(size):
    """Byte for byte the JAX package's framing, and each side parses the
    other's bytes."""
    rng = np.random.default_rng(size)
    header = {"type": "frame", "seq": size, "meta": "x" * (size % 97), "uni": "画像☃",
              "tiles": [int(t) for t in rng.integers(0, 64, size % 5)], "f": 0.1 * size}
    payload = rng.bytes(size)
    ours = pack_message(header, payload)
    assert ours == jproto.pack_message(header, payload)
    assert list(iter_messages(ours * 2)) == list(jproto.iter_messages(ours * 2)) == [(header, payload)] * 2


def test_protocol_rejects_bad_magic_version_and_truncation():
    good = pack_message({"type": "hello"}, b"abc")
    with pytest.raises(ProtocolError, match="magic"):
        list(iter_messages(b"XX" + good[2:]))
    with pytest.raises(ProtocolError, match="protocol v9"):
        list(iter_messages(good[:2] + bytes([9]) + good[3:]))
    with pytest.raises(ProtocolError, match="truncated"):
        list(iter_messages(good[:-1]))
    with pytest.raises(ProtocolError, match="short prefix"):
        list(iter_messages(good[:5]))


def test_protocol_async_reader_reassembles_split_frames():
    async def run():
        msgs = [({"type": "a", "seq": 0}, b""), ({"type": "b", "seq": 1}, b"\x00" * 100)]
        data = b"".join(pack_message(h, p) for h, p in msgs)
        reader = asyncio.StreamReader()
        for i in range(0, len(data), 7):
            reader.feed_data(data[i : i + 7])
        reader.feed_eof()
        out = [await proto.read_message(reader) for _ in range(2)]
        assert [h["type"] for h, _ in out] == ["a", "b"] and out[1][1] == b"\x00" * 100
        assert await proto.read_message(reader) is None  # clean EOF
        reader2 = asyncio.StreamReader()
        reader2.feed_data(data[: len(data) - 3])
        reader2.feed_eof()
        await proto.read_message(reader2)
        with pytest.raises(ProtocolError, match="mid-message"):
            await proto.read_message(reader2)

    _run(run())


def test_camera_to_wire_equals_jax_and_comes_back_as_the_port_camera():
    cam = make_cam(H, W, dist=2.5)
    _, cam_t = to_port(_scene(), cam)
    d = proto.camera_to_wire(cam_t)
    assert d == jproto.camera_to_wire(cam) == proto.camera_to_wire(cam)
    assert pack_message({"type": "render", "camera": d}) == jproto.pack_message(
        {"type": "render", "camera": jproto.camera_to_wire(cam)})
    back = proto.camera_from_wire(d)
    assert type(back).__module__ == "repro_torch.core.projection"
    assert isinstance(back.viewmat, np.ndarray) and back.viewmat.dtype == np.float32
    np.testing.assert_array_equal(back.viewmat, np.asarray(cam.viewmat))
    with pytest.raises(ProtocolError, match="camera"):
        proto.camera_from_wire({"viewmat": [1, 2, 3]})


# =================================================================== encode
def _frame_sequence(h, w, seed):
    """uint8 frames exercising every encoder path: a keyframe, a small
    change, an identical frame, a revisit of the first frame (tile-store
    references), uncorrelated noise (raw fallback) and a return to a
    near copy."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    b = a.copy()
    b[h // 2 : h // 2 + 3, 1:5] += 7
    c = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    d = a.copy()
    d[0, 0] ^= 1
    return [a, b, b, a, c, d, a]


ENCODER_MODES = {
    "rgb8": dict(kw=dict(delta=False), shape=(24, 24)),
    "zdelta8": dict(kw=dict(delta=True), shape=(24, 24)),
    "tiles8": dict(kw=dict(tiles=True, tile=(8, 8)), shape=(24, 24)),
    "tiles8-ragged": dict(kw=dict(tiles=True, tile=(16, 16)), shape=(20, 28)),
}


@pytest.mark.parametrize("mode", list(ENCODER_MODES))
def test_encoder_headers_and_payloads_equal_jax_and_decode_across(mode):
    spec = ENCODER_MODES[mode]
    ours, theirs = FrameEncoder(**spec["kw"]), JFrameEncoder(**spec["kw"])
    dec_of_jax, jdec_of_ours = FrameDecoder(), JFrameDecoder()
    frames = _frame_sequence(*spec["shape"], seed=len(mode))
    metas = []
    for i, f in enumerate(frames):
        if i == 2:  # a partial reset (tile rows 0 and 1) before an identical frame; a full reset
            for enc in (ours, theirs):
                enc.reset("s", rows=[0, 1])
                enc.reset("other")
        for stream in ("s", "other"):
            m1, p1 = ours.encode(stream, f)
            m2, p2 = theirs.encode(stream, f)
            assert m1 == m2 and p1 == p2, (mode, i, stream, m1, m2)
            metas.append(m1["encoding"])
            np.testing.assert_array_equal(dec_of_jax.decode(stream, m2, p2), quantize_rgb8(f))
            np.testing.assert_array_equal(jdec_of_ours.decode(stream, m1, p1), quantize_rgb8(f))
    assert ours.stats() == theirs.stats()
    want = {"rgb8": {"rgb8"}, "zdelta8": {"rgb8", "zdelta8"}}.get(mode, {"rgb8", "tiles8"})
    assert set(metas) == want
    s = ours.stats()
    if mode != "rgb8":
        assert s["raw_fallbacks"] >= 1  # the noise frame shipped raw
    if mode.startswith("tiles8"):
        assert s["tiles_reffed"] > 0 and s["tiles_forced"] > 0  # store references; the partial reset


def test_decoder_validates_payload_length_against_header_shape():
    enc, dec = FrameEncoder(), FrameDecoder()
    f = np.full((4, 4, 3), 0.5, np.float32)
    meta, payload = enc.encode("cam0", f)
    with pytest.raises(CodecError, match="cam0.*47"):
        dec.decode("cam0", meta, payload[:-1])
    dec.decode("cam0", meta, payload)
    meta2, payload2 = enc.encode("cam0", f)
    assert meta2["encoding"] == "zdelta8"
    with pytest.raises(CodecError, match="cam0"):
        dec.decode("cam0", meta2, zlib.compress(b"\x00" * 10))
    tmeta = dict(meta2, encoding="tiles8", tile=[4, 4], tiles=[0])
    with pytest.raises(CodecError, match="out of range"):
        dec.decode("cam0", dict(tmeta, tiles=[99]), zlib.compress(b""))
    np.testing.assert_array_equal(dec.decode("cam0", meta2, payload2), quantize_rgb8(f))


# ================================================================ sessions
def _admission_script(seed):
    """A scripted admission sequence: renders, scrubs (bulk units of 2-5
    items) and takes, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    script, seq = [], 0
    for _ in range(40):
        u = rng.random()
        if u < 0.55:
            script.append(("render", seq, 1))
        elif u < 0.8:
            script.append(("scrub", seq, int(rng.integers(2, 6))))
        else:
            script.append(("take", int(rng.integers(1, 4)), 0))
        seq += 1
    return script


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_session_admit_sheds_the_same_victims_as_jax(seed):
    out = {}
    for name, S, PR in (("port", Session, PendingRender), ("jax", JSession, JPendingRender)):
        s = S(queue_limit=3)
        victims, taken = [], []
        for op, a, n in _admission_script(seed):
            if op == "take":
                taken.append([(p.seq, p.timestep) for p in s.take(a)])
                continue
            limit = max(s.queue_limit, n)
            for t in range(n):
                pr = PR(session=s, seq=a, stream_id="timeline", timestep=t, global_ts=t, cam=None,
                        t_admit=0.0, scrub_last=t == n - 1, bulk=n > 1)
                v = s.admit(pr, limit=limit)
                if v is not None:
                    victims.append((v.seq, v.timestep, v.bulk))
        out[name] = (victims, taken, [(p.seq, p.timestep) for p in s.queue], s.shed, s.admitted)
    assert out["port"] == out["jax"]
    assert out["port"][3] > 0  # the script sheds


@pytest.mark.parametrize("protocol,encodings", [
    (None, None), (1, None), (2, ["rgb8", "zdelta8", "tiles8"]), (2, ["rgb8"]), (2, ["rgb8", "zdelta8"]),
    (9, ["tiles8"]), ("x", None)])
def test_session_negotiation_equals_jax(protocol, encodings):
    ours, theirs = Session(queue_limit=2), JSession(queue_limit=2)
    assert ours.negotiate(protocol, encodings) == theirs.negotiate(protocol, encodings)
    assert ours.encoder.offered() == theirs.encoder.offered()


# ================================================================== gateway
def test_gateway_smoke_multi_client_two_streams(gateway_thread):
    """Sync clients over localhost across both streams: every request
    answered, nothing shed, and the frames bitwise the port's in-process
    frames after quantize_rgb8 (both streams)."""
    gt = gateway_thread
    cams = [make_cam(H, W, dist=2.0 + 0.25 * i) for i in range(4)]
    clients = [FrontendClient("127.0.0.1", gt.port, timeout=T_OUT) for _ in range(4)]
    try:
        assert all(set(cl.streams) == {"static", "timeline"} for cl in clients)
        frames = {}
        for r in range(2):  # two rounds so delta encoding gets exercised
            for i, cl in enumerate(clients):
                frames[(r, i, "static")] = cl.render("static", cams[i])
                frames[(r, i, "timeline")] = cl.render("timeline", cams[i], timestep=1)
        stats = clients[0].stats()
    finally:
        for cl in clients:
            cl.close()
    gw = stats["gateway"]
    assert gw["frames_sent"] == 16 and gw["shed"] == 0
    assert gw["protocol_errors"] == gw["request_errors"] == gw["dropped_writes"] == gw["engine_errors"] == 0
    g = _scene()
    want_static = _inprocess(cams, g)
    want_t1 = _inprocess(cams, timestep_params=synthetic_timeline(to_port(g), 2)[1])
    for r in range(2):
        for i in range(4):
            np.testing.assert_array_equal(frames[(r, i, "static")], want_static[i])
            np.testing.assert_array_equal(frames[(r, i, "timeline")], want_t1[i])


def test_gateway_scrub_and_bad_requests(gateway_thread):
    with FrontendClient("127.0.0.1", gateway_thread.port, timeout=T_OUT) as cl:
        cam = make_cam(H, W)
        frames = cl.scrub("timeline", cam, [0, 1])
        assert sorted(frames) == [0, 1]
        assert np.abs(frames[0].astype(int) - frames[1].astype(int)).max() > 0
        with pytest.raises(RemoteRenderError, match="no timestep"):
            cl.render("timeline", cam, timestep=99)
        with pytest.raises(RemoteRenderError, match="unknown stream"):
            cl.render("nope", cam)
        stats = cl.stats()
    assert stats["gateway"]["request_errors"] >= 2
    assert stats["gateway"]["protocol_errors"] == 0


def test_gateway_rejects_garbage_bytes(gateway_thread):
    gt = gateway_thread
    before = gt.gateway.protocol_errors
    with _connect(gt.port) as s:
        s.sendall(b"GET / HTTP/1.1\r\n\r\n")
        chunks = b""
        while True:
            b = s.recv(4096)
            if not b:
                break
            chunks += b
    (header, _), = iter_messages(chunks)
    assert header["type"] == "error" and "magic" in header["detail"]
    assert gt.gateway.protocol_errors == before + 1


def test_malformed_timestep_answers_bad_request_not_disconnect(gateway_thread):
    cam_wire = proto.camera_to_wire(make_cam(H, W))
    with _connect(gateway_thread.port) as s:
        s.sendall(pack_message({"type": "hello"}))
        assert _read_msg(s)[0]["type"] == "hello_ok"
        s.sendall(pack_message({"type": "render", "seq": 5, "stream": "static", "timestep": "abc",
                                "camera": cam_wire}))
        h, _ = _read_msg(s)
        assert h["type"] == "error" and h["code"] == "bad_request" and h["seq"] == 5
        s.sendall(pack_message({"type": "render", "seq": 6, "stream": "static", "timestep": 0,
                                "camera": cam_wire}))
        h, payload = _read_msg(s)
        assert h["type"] == "frame" and h["seq"] == 6 and len(payload) > 0


def test_render_hints_ride_the_wire_and_validate(gateway_thread):
    cam = make_cam(H, W)
    with FrontendClient("127.0.0.1", gateway_thread.port, timeout=T_OUT) as cl:
        a = cl.render("static", cam)
        b = cl.render("static", cam, gaze=(0.5, 0.5), budget_ms=50.0)
        np.testing.assert_array_equal(a, b)
    cam_wire = proto.camera_to_wire(cam)
    with _connect(gateway_thread.port) as s:
        s.sendall(pack_message({"type": "hello", "protocol": 2}))
        _read_msg(s)
        for bad in ({"budget_ms": -5}, {"gaze": "abc"}, {"gaze": [0.5]}):
            s.sendall(pack_message({"type": "render", "seq": 9, "stream": "static", "timestep": 0,
                                    "camera": cam_wire, **bad}))
            h, _ = _read_msg(s)
            assert h["type"] == "error" and h["code"] == "bad_request", (bad, h)
        s.sendall(pack_message({"type": "render", "seq": 10, "stream": "static", "timestep": 0,
                                "camera": cam_wire, "gaze": [0.2, 0.8], "budget_ms": 100.0}))
        h, payload = _read_msg(s)
        assert h["type"] == "frame" and len(payload) > 0
        s.sendall(pack_message({"type": "bye"}))


def test_tiles8_negotiated_and_exact_over_real_tcp(gateway_thread):
    """A v2 hello gets tiles8 frames (a repeated pose ships zero tiles) and
    the decoded frames are bitwise the in-process frame; a v1 hello gets
    zdelta8; a raw-only decoder gets raw frames only."""
    cam_wire = proto.camera_to_wire(make_cam(H, W))
    dec = FrameDecoder()
    port = gateway_thread.port

    def renders(s, n):
        out = []
        for seq in range(n):
            s.sendall(pack_message({"type": "render", "seq": seq, "stream": "static", "timestep": 0,
                                    "camera": cam_wire}))
            out.append(_read_msg(s))
        s.sendall(pack_message({"type": "bye"}))
        return out

    with _connect(port) as s:
        s.sendall(pack_message({"type": "hello", "protocol": proto.PROTOCOL,
                                "encodings": ["rgb8", "zdelta8", "tiles8"]}))
        h, _ = _read_msg(s)
        assert h["type"] == "hello_ok" and h["protocol"] == 2
        assert "tiles8" in h["encodings"] and h["tile"] == [16, 16]
        frames = [(fh, dec.decode("static", fh, p)) for fh, p in renders(s, 3)]
    assert frames[0][0]["encoding"] == "rgb8"
    assert all(fh["encoding"] == "tiles8" and fh["tiles"] == [] for fh, _ in frames[1:])
    (want,) = _inprocess([make_cam(H, W)])
    for _, frame in frames:
        np.testing.assert_array_equal(frame, want)
    with _connect(port) as s:
        s.sendall(pack_message({"type": "hello"}))
        h, _ = _read_msg(s)
        assert h["protocol"] == 1 and h["encodings"] == ["rgb8", "zdelta8"]
        assert [fh["encoding"] for fh, _ in renders(s, 2)] == ["rgb8", "zdelta8"]
    with _connect(port) as s:
        s.sendall(pack_message({"type": "hello", "protocol": 2, "encodings": ["rgb8"]}))
        h, _ = _read_msg(s)
        assert h["encodings"] == ["rgb8"]
        assert [fh["encoding"] for fh, _ in renders(s, 2)] == ["rgb8", "rgb8"]


def test_scrub_longer_than_queue_limit_never_sheds_itself():
    mgr = _manager(timeline_steps=6)
    mgr.warmup()
    with GatewayThread(Gateway(mgr, port=0, queue_limit=4)) as gt:
        with FrontendClient("127.0.0.1", gt.port, timeout=T_OUT) as cl:
            frames = cl.scrub("timeline", make_cam(H, W), list(range(6)))
            stats = cl.stats()
    assert sorted(frames) == list(range(6))
    assert stats["gateway"]["shed"] == 0 and stats["gateway"]["request_errors"] == 0


def test_interleaved_render_does_not_shed_in_progress_scrub():
    mgr = _manager(timeline_steps=6)
    mgr.warmup()
    gw = Gateway(mgr, port=0, queue_limit=2)
    with GatewayThread(gw) as gt:

        async def run():
            cl = AsyncFrontendClient("127.0.0.1", gt.port)
            await cl.connect()
            gt.call_soon(gw.pause)
            await asyncio.sleep(0.05)
            scrub_task = asyncio.ensure_future(cl.scrub("timeline", make_cam(H, W), list(range(6))))
            await asyncio.sleep(0.1)
            rfut = await cl.submit_render("static", make_cam(H, W))
            gt.call_soon(gw.resume)
            frames = await scrub_task
            frame = await rfut
            stats = await cl.stats()
            await cl.close()
            return frames, frame, stats

        frames, frame, stats = _run(run())
    assert sorted(frames) == list(range(6))
    assert frame.shape == (H, W, 3)
    assert stats["gateway"]["shed"] == 0


def test_backpressure_sheds_oldest_with_accounting():
    mgr = _manager(timeline_steps=0)
    mgr.warmup()
    gw = Gateway(mgr, port=0, queue_limit=2)
    with GatewayThread(gw) as gt:

        async def run():
            cl = AsyncFrontendClient("127.0.0.1", gt.port)
            await cl.connect()
            gt.call_soon(gw.pause)
            await asyncio.sleep(0.05)
            futs = [await cl.submit_render("static", make_cam(H, W, dist=2.0 + 0.3 * i)) for i in range(6)]
            for fut in futs[:4]:
                with pytest.raises(ShedError):
                    await fut
            gt.call_soon(gw.resume)
            survivors = [await fut for fut in futs[4:]]
            stats = await cl.stats()
            await cl.close()
            return survivors, stats

        survivors, stats = _run(run())
    assert len(survivors) == 2 and all(f.shape == (H, W, 3) for f in survivors)
    gws = stats["gateway"]
    assert gws["shed"] == 4 and gws["frames_sent"] == 2
    (sess,) = stats["sessions"].values()
    assert sess["shed"] == 4 and sess["admitted"] == 6 and sess["queued_now"] == 0
    assert sess["shed"] + sess["frames_sent"] == sess["admitted"]


def test_depth1_and_depth2_identical_through_network():
    g = _scene()
    cams = [make_cam(H, W, dist=2.0 + 0.2 * i) for i in range(3)]
    results = {}
    for depth in (1, 2):
        mgr = _manager(g, pipeline_depth=depth)
        mgr.warmup()
        with GatewayThread(Gateway(mgr, port=0)) as gt:
            with FrontendClient("127.0.0.1", gt.port, timeout=T_OUT) as cl:
                frames = []
                for cam in cams:
                    frames.append(cl.render("static", cam))
                    frames.append(cl.render("timeline", cam, timestep=1))
                scrub = cl.scrub("timeline", cams[0], [0, 1])
                frames += [scrub[0], scrub[1]]
                stats = cl.stats()
        assert stats["gateway"]["shed"] == 0 and stats["gateway"]["protocol_errors"] == 0
        results[depth] = frames
    for a, b in zip(results[1], results[2]):
        np.testing.assert_array_equal(a, b)


def _tiles_session(port):
    s = _connect(port)
    s.sendall(pack_message({"type": "hello", "protocol": 2, "encodings": ["rgb8", "zdelta8", "tiles8"]}))
    _read_msg(s)
    return s


def test_invalidation_resets_wire_delta_chain():
    mgr = _manager(timeline_steps=0)
    mgr.warmup()
    gw = Gateway(mgr, port=0)
    with GatewayThread(gw) as gt:
        cam_wire = proto.camera_to_wire(make_cam(H, W))
        with _tiles_session(gt.port) as s:

            def render(seq):
                s.sendall(pack_message({"type": "render", "seq": seq, "stream": "static", "timestep": 0,
                                        "camera": cam_wire}))
                return _read_msg(s)[0]

            assert render(0)["encoding"] == "rgb8"
            assert render(1)["encoding"] == "tiles8"
            gw.run_on_engine(mgr.invalidate, "static", 0).result(timeout=T_OUT)
            assert render(2)["encoding"] == "rgb8"
            assert render(3)["encoding"] == "tiles8"
            s.sendall(pack_message({"type": "bye"}))
    assert gw.delta_resets >= 1


def test_row_invalidation_partial_resets_wire_chain():
    mgr = _manager(timeline_steps=0)
    mgr.warmup()
    gw = Gateway(mgr, port=0)
    with GatewayThread(gw) as gt:
        cam_wire = proto.camera_to_wire(make_cam(H, W))
        dec = FrameDecoder()
        with _tiles_session(gt.port) as s:

            def render(seq):
                s.sendall(pack_message({"type": "render", "seq": seq, "stream": "static", "timestep": 0,
                                        "camera": cam_wire}))
                fh, payload = _read_msg(s)
                return fh, dec.decode("static", fh, payload)

            render(0)
            fh1, f1 = render(1)
            assert fh1["encoding"] == "tiles8" and fh1["tiles"] == []
            gw.run_on_engine(lambda: mgr.invalidate("static", 0, rows=[0])).result(timeout=T_OUT)
            fh2, f2 = render(2)
            assert fh2["encoding"] == "tiles8"
            rekeyed = set(fh2["tiles"]) | {t for t, _ in fh2.get("refs") or []}
            assert rekeyed == set(range(W // 16))
            np.testing.assert_array_equal(f2, f1)
            s.sendall(pack_message({"type": "bye"}))
    assert gw.partial_resets >= 1 and gw.delta_resets == 0


def test_slo_state_is_visible_over_the_wire():
    mgr = _manager(timeline_steps=0)
    mgr.warmup()
    gw = Gateway(mgr, port=0, queue_limit=8, slo={"p99_ms": 2000.0, "window_s": 60.0})
    with GatewayThread(gw) as gt:
        with FrontendClient("127.0.0.1", gt.port, timeout=T_OUT) as cl:
            for i in range(3):
                cl.render("static", make_cam(H, W, dist=2.2 + 0.2 * i))
            slo = cl.metrics()["slo"]
            stats = cl.stats()
    assert slo["state"] == "ok" and slo["target_p99_ms"] == 2000.0 and slo["window_count"] >= 1
    assert stats["gateway"]["slo"]["state"] == "ok" and stats["gateway"]["slo"]["burn"] == 0.0


def test_session_manager_stream_isolation_and_resolve():
    mgr = _manager(timeline_steps=3)
    assert mgr.resolve("static", 0) == 0
    base = mgr.streams["timeline"].base
    assert base > 0 and mgr.resolve("timeline", 2) == base + 2
    with pytest.raises(KeyError, match="unknown stream"):
        mgr.resolve("missing", 0)
    with pytest.raises(KeyError, match="no timestep"):
        mgr.resolve("static", 1)
    with pytest.raises(ValueError, match="already registered"):
        mgr.register_static("static", to_port(make_scene(n=64)))
    assert len(mgr.server.timesteps()) == 4 and mgr.server.device == torch.device("cpu")
    mgr.close()
    assert mgr.server.closed


def test_manager_passes_the_device_to_its_server_whose_default_is_the_card():
    import inspect

    from repro_torch.serve_gs import RenderServer as Server

    assert inspect.signature(Server).parameters["device"].default == "cuda"
    mgr = SessionManager(_cfg(), n_levels=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            mgr.register_static("static", to_port(_scene()))


# ============================================== against the JAX gateway
TRACE = [("static", 0, 2.0), ("timeline", 1, 2.2), ("static", 0, 2.4), ("timeline", 0, 2.0),
         ("static", 0, 2.0), ("timeline", 1, 2.6)]


def _drive(cl):
    frames = [cl.render(s, make_cam(H, W, dist=d), timestep=t) for s, t, d in TRACE]
    scrub = cl.scrub("timeline", make_cam(H, W, dist=2.3), [0, 1])
    return frames + [scrub[0], scrub[1]]


def test_port_gateway_frames_within_one_step_of_the_jax_gateway(gateway_thread, jax_gateway_thread):
    with FrontendClient("127.0.0.1", gateway_thread.port, timeout=T_OUT) as cl:
        ours = _drive(cl)
    with JFrontendClient("127.0.0.1", jax_gateway_thread.port, timeout=T_OUT) as cl:
        theirs = _drive(cl)
    diff = np.abs(np.stack(ours).astype(int) - np.stack(theirs).astype(int))
    assert diff.max() <= 1
    assert np.count_nonzero(diff) <= 1e-3 * diff.size, np.count_nonzero(diff)


def test_jax_client_against_the_port_gateway(gateway_thread):
    errors_before = gateway_thread.gateway.protocol_errors
    with JFrontendClient("127.0.0.1", gateway_thread.port, timeout=T_OUT) as jcl:
        assert set(jcl.streams) == {"static", "timeline"} and jcl.hello["protocol"] == 2
        got = _drive(jcl)  # JAX cameras on the wire, the port renders them
        stats = jcl.stats()
    with FrontendClient("127.0.0.1", gateway_thread.port, timeout=T_OUT) as cl:
        want = _drive(cl)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert stats["gateway"]["protocol_errors"] == errors_before and stats["gateway"]["shed"] == 0


def test_port_client_against_the_jax_gateway(jax_gateway_thread):
    _, cam_t = to_port(_scene(), make_cam(H, W, dist=2.1))
    with FrontendClient("127.0.0.1", jax_gateway_thread.port, timeout=T_OUT) as cl:
        assert set(cl.streams) == {"static", "timeline"} and cl.hello["protocol"] == 2
        got = [cl.render("static", cam_t), cl.render("static", cam_t), cl.render("timeline", cam_t, timestep=1)]
        stats = cl.stats()
    with JFrontendClient("127.0.0.1", jax_gateway_thread.port, timeout=T_OUT) as jcl:
        jcam = make_cam(H, W, dist=2.1)
        want = [jcl.render("static", jcam), jcl.render("static", jcam), jcl.render("timeline", jcam, timestep=1)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert stats["gateway"]["protocol_errors"] == 0


def test_synthetic_timeline_equals_jax_bitwise():
    g = _scene()
    ours, theirs = synthetic_timeline(to_port(g), 4), jax_synthetic_timeline(g, 4)
    for t in range(4):
        np.testing.assert_array_equal(np_(ours[t].means), np.asarray(theirs[t].means))


# ====================================================== race sanitizer
def test_port_gateway_and_manager_under_the_race_sanitizer(monkeypatch):
    """With REPRO_TSAN=1 the port's manager, gateway and gateway thread are
    instrumented; a multi-client run with an engine-side invalidation
    records no race."""
    monkeypatch.setenv("REPRO_TSAN", "1")
    assert tsan.enabled()
    mgr = _manager()
    mgr.warmup()
    gw = Gateway(mgr, port=0)
    assert type(gw).__name__ != "Gateway" and type(mgr).__name__ != "SessionManager"  # instrumented subclasses
    with GatewayThread(gw) as gt:
        clients = [FrontendClient("127.0.0.1", gt.port, timeout=T_OUT) for _ in range(3)]
        try:
            for i, cl in enumerate(clients):
                cl.render("static", make_cam(H, W, dist=2.0 + 0.2 * i))
            gw.run_on_engine(mgr.invalidate, "timeline", 1).result(timeout=T_OUT)
            for cl in clients:
                cl.scrub("timeline", make_cam(H, W), [0, 1])
        finally:
            for cl in clients:
                cl.close()
    assert tsan.take_races() == []


def test_temporal_store_writer_under_the_race_sanitizer(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TSAN", "1")
    tl = synthetic_timeline(to_port(_scene()), 3)
    with TemporalCheckpointStore(str(tmp_path / "seq"), keyframe_interval=2) as store:
        assert type(store).__name__ != "TemporalCheckpointStore"
        for t, p in tl.items():
            store.append(t, p)
        store.flush()
        assert store.timesteps() == [0, 1, 2]
    assert tsan.take_races() == []


def test_race_sanitizer_flags_an_unlocked_write_as_the_jax_copy_does(monkeypatch):
    from repro.analysis import tsan as jtsan

    monkeypatch.setenv("REPRO_TSAN", "1")
    import threading

    found = {}
    for name, mod in (("port", tsan), ("jax", jtsan)):
        mod.reset()

        class Box:
            def __init__(self):
                self.x = 0

        box = mod.attach(Box(), name="Box")
        box.x = 1
        th = threading.Thread(target=lambda: setattr(box, "x", 2))
        th.start()
        th.join(T_OUT)
        assert not th.is_alive()
        found[name] = [(r.obj, r.field) for r in mod.take_races()]
    assert found["port"] == found["jax"] == [("Box", "x")]


# ================================================ timeline_stream, CLI
def test_timeline_stream_registers_a_stored_sequence_on_the_session_manager(tmp_path):
    """``insitu/serve.py::timeline_stream`` puts a recorded sequence on a
    manager's shared pool; over the gateway its scrubbed frames are the
    in-process frames of each stored timestep."""
    gp = to_port(_scene())
    with TemporalCheckpointStore(str(tmp_path / "seq"), keyframe_interval=2) as store:
        for t, p in synthetic_timeline(gp, 3).items():
            store.append(t, p)
    mgr = SessionManager(_cfg(), device="cpu", n_levels=1, max_batch=4, store_frames=False)
    mgr.register_static("static", gp)
    with TemporalCheckpointStore(str(tmp_path / "seq")) as store:
        info = timeline_stream(mgr, "timeline", store)
        stored = {t: store.load(t) for t in store.timesteps()}
    assert info.stream_id == "timeline" and info.kind == "timeline" and info.timesteps == (0, 1, 2)
    assert mgr.resolve("timeline", 2) == info.base + 2
    mgr.warmup()
    cam = make_cam(H, W)
    with GatewayThread(Gateway(mgr, port=0)) as gt:
        with FrontendClient("127.0.0.1", gt.port, timeout=T_OUT) as cl:
            assert cl.streams["timeline"] == {"kind": "timeline", "timesteps": [0, 1, 2]}
            frames = cl.scrub("timeline", cam, [0, 1, 2])
    for t in range(3):
        (want,) = _inprocess([cam], timestep_params=stored[t])
        np.testing.assert_array_equal(frames[t], want)
    assert len({f.tobytes() for f in frames.values()}) == 3


def test_frontend_cli_smoke_on_the_cpu(capsys):
    frontend_cli.main(["--smoke", "--device", "cpu"])
    assert "frontend smoke ok" in capsys.readouterr().out


def test_frontend_cli_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI serves on it instead of refusing")
    with pytest.raises(SystemExit, match="no CUDA device"):
        frontend_cli.main(["--smoke"])


def test_port_frontend_exports_the_jax_names():
    import repro.frontend as jf
    import repro_torch.frontend as tf

    assert tf.__all__ == jf.__all__
