"""Off-loop frame encoding: raw RGB8, zlib temporal deltas, changed tiles
(a copy of the JAX package's ``frontend/encode.py``: the same headers and
payloads, byte for byte, for the same frames).

Rendered frames leave the serving engine as read-only float32 HxWx3 arrays in
[0, 1]. Shipping those over TCP would cost 12 bytes/pixel; the gateway instead
quantizes to RGB8 (4x smaller, visually lossless for display) and — because a
viewer's consecutive frames are usually near-identical (orbit playback, time
scrubbing at a fixed pose, cache hits) — sends one of:

  ``zdelta8``  the uint8 difference vs the last frame sent on that stream,
               zlib-compressed. The difference wraps modulo 256, so decode is
               exact: ``cur = last + delta (mod 256)`` reproduces the
               quantized frame bit-for-bit.
  ``tiles8``   changed-tile streaming (protocol v2): the frame is diffed vs
               ``last`` per screen tile, and only the tiles whose content
               changed ship — their mod-256 diffs concatenated into ONE zlib
               stream, with the changed tile ids in the header. A frame whose
               motion touches three tiles costs three tiles on the wire; an
               identical frame costs a header. Exact, like zdelta8.

               On top of the diff, both ends mirror a bounded per-stream
               **tile store** of recently shipped tile contents (a ring of
               ``TILE_STORE_SLOTS``). A changed tile whose NEW content was
               already shipped on this stream — an orbit replay lap, a
               scrub revisiting a timestep, any pose the viewer returns to —
               is sent as a tiny ``[tile_id, slot]`` reference instead of
               pixels: the client already holds those bytes. The store is
               mirrored deterministically (shipped tiles enter the ring in
               header order; the header carries the frame's starting slot),
               so no round-trip or acknowledgment is needed.

Either way, if the compressed payload comes out **no smaller than raw**
(noisy first-contact frames — zlib on incompressible diffs adds overhead),
the encoder falls back to a raw keyframe and counts it (``raw_fallbacks``):
the wire never pays for compression that didn't compress.

Encoder and decoder are tiny mirrored state machines keyed by stream id:
both sides update ``last`` to the decoded frame after every ``frame``
message, and TCP ordering keeps them in lockstep. The first frame on a
stream (or any resolution change) is always a raw keyframe. Payload lengths
are validated against the header geometry before any reshape, so a
truncated or oversized frame from a misbehaving peer raises a
:class:`CodecError` naming the stream instead of a bare numpy error. All of
this is pure host work — the gateway runs it on an executor thread, never on
the event loop (that is the "off-loop" in the module name).
"""
from __future__ import annotations

import hashlib
import zlib

import numpy as np

RAW8 = "rgb8"        # payload = uint8 HxWx3, row-major
ZDELTA8 = "zdelta8"  # payload = zlib(uint8 wraparound diff vs last frame)
TILES8 = "tiles8"    # payload = zlib(concat of changed tiles' uint8 diffs)

ENCODINGS = (RAW8, ZDELTA8, TILES8)

# Mirrored per-stream tile-store ring size (slots). Memory per stream per
# connection is bounded by SLOTS x tile bytes (16x16x3 tiles -> ~1.5 MB),
# and holds a few frames' worth of recent tile content for ref-not-reship.
TILE_STORE_SLOTS = 2048


class CodecError(ValueError):
    """A frame payload is inconsistent with its header (wrong length,
    missing delta base, unknown encoding). Subclasses ValueError so legacy
    callers catching that still work; always names the stream."""


def quantize_rgb8(frame: np.ndarray) -> np.ndarray:
    """Float [0,1] HxWx3 -> contiguous uint8 (the on-wire pixel format)."""
    f = np.asarray(frame)
    if f.dtype == np.uint8:
        return np.ascontiguousarray(f)
    return np.ascontiguousarray(
        (np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    )


def tile_grid(h: int, w: int, th: int, tw: int) -> list[tuple[slice, slice]]:
    """Row-major (y-slice, x-slice) spans of the tile grid; ragged edges get
    short tiles, so any resolution tiles exactly."""
    return [
        (slice(y, min(y + th, h)), slice(x, min(x + tw, w)))
        for y in range(0, h, th)
        for x in range(0, w, tw)
    ]


def _zdecompress(payload: bytes, expected: int, stream: str, what: str) -> bytes:
    """Bounded zlib decompress: a peer cannot zlib-bomb the receiver, and a
    wrong-size result is a protocol error naming the stream."""
    try:
        d = zlib.decompressobj()
        out = d.decompress(payload, expected + 1)
    except zlib.error as e:
        raise CodecError(f"stream {stream!r}: undecodable {what} payload: {e}") from None
    if len(out) != expected or d.unconsumed_tail or not d.eof:
        raise CodecError(
            f"stream {stream!r}: {what} payload decompresses to "
            f"{len(out)}{'+' if d.unconsumed_tail or not d.eof else ''} bytes, "
            f"header shape needs {expected}"
        )
    return out


class FrameEncoder:
    """Per-connection encoder; independent delta chain per stream id.

    ``tiles=True`` (negotiated: protocol v2 peers only) switches the delta
    path to changed-tile streaming with the ``tile`` grid shape.
    """

    def __init__(
        self,
        *,
        delta: bool = True,
        zlevel: int = 1,
        tiles: bool = False,
        tile: tuple[int, int] = (16, 16),
    ):
        self.delta = delta
        self.zlevel = zlevel
        self.tiles = tiles
        self.tile = (int(tile[0]), int(tile[1]))
        self._last: dict[str, np.ndarray] = {}
        # tile store (encoder side): digest -> slot, ring of digests, counter
        self._store: dict[str, dict[bytes, int]] = {}
        self._ring: dict[str, list[bytes]] = {}
        self._slot: dict[str, int] = {}
        # tile rows a partial reset marked dirty: their tiles ship (or ref)
        # on the next frame even when the pixel diff is zero
        self._force_rows: dict[str, set[int]] = {}
        self.raw_frames = 0
        self.delta_frames = 0
        self.tile_frames = 0
        self.raw_fallbacks = 0   # compressed >= raw, shipped raw instead
        self.tiles_total = 0     # tiles considered across tile frames
        self.tiles_shipped = 0   # tiles whose pixels went on the wire
        self.tiles_reffed = 0    # tiles sent as store references (no pixels)
        self.tiles_forced = 0    # tiles included only because a row was forced
        self.bytes_raw = 0       # what raw-only would have cost
        self.bytes_sent = 0

    def offered(self) -> list[str]:
        """Encodings this encoder may emit (for the hello_ok listing)."""
        out = [RAW8]
        if self.delta:
            out.append(TILES8 if self.tiles else ZDELTA8)
        return out

    @staticmethod
    def _digest(tile: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(tile.shape).encode())
        h.update(np.ascontiguousarray(tile).tobytes())
        return h.digest()

    def _encode_tiles(
        self, stream: str, q: np.ndarray, last: np.ndarray
    ) -> tuple[dict, bytes, list[bytes]]:
        th, tw = self.tile
        grid = tile_grid(q.shape[0], q.shape[1], th, tw)
        tiles_x = -(-q.shape[1] // tw)
        forced = self._force_rows.get(stream) or ()
        diff = q - last  # uint8 arithmetic wraps mod 256: exact on decode
        store = self._store.get(stream, {})
        changed, refs, parts, staged = [], [], [], []
        for ti, (ys, xs) in enumerate(grid):
            d = diff[ys, xs]
            if not d.any():
                # a forced (invalidated) row's tiles ship anyway: the zero
                # diff decodes bit-exactly, and the client's copy is re-keyed
                # instead of silently assumed current
                if ti // tiles_x not in forced:
                    continue
                self.tiles_forced += 1
            digest = self._digest(q[ys, xs])
            slot = store.get(digest)
            if slot is not None:
                # the client already holds these exact pixels: ref, not reship
                refs.append([ti, slot])
            else:
                changed.append(ti)
                parts.append(d.tobytes())
                staged.append(digest)
        payload = zlib.compress(b"".join(parts), self.zlevel)
        meta = {
            "encoding": TILES8,
            "tile": [th, tw],
            "tiles": changed,
            "slot0": self._slot.get(stream, 0),
        }
        if refs:
            meta["refs"] = refs
        return meta, payload, staged

    def _commit_tiles(self, stream: str, staged: list[bytes]) -> None:
        """Enter the shipped tiles into the mirrored store ring, in header
        order (the decoder replays exactly this on receipt)."""
        store = self._store.setdefault(stream, {})
        ring = self._ring.setdefault(stream, [])
        slot = self._slot.get(stream, 0)
        for digest in staged:
            pos = slot % TILE_STORE_SLOTS
            if len(ring) <= pos:
                ring.append(digest)
            else:
                old = ring[pos]
                # evict the digest this ring position held — unless it was
                # re-inserted since and now maps to a newer slot
                if store.get(old) == slot - TILE_STORE_SLOTS:
                    del store[old]
                ring[pos] = digest
            store[digest] = slot
            slot += 1
        self._slot[stream] = slot

    def encode(self, stream: str, frame: np.ndarray) -> tuple[dict, bytes]:
        """Returns (meta fields for the frame header, payload bytes)."""
        q = quantize_rgb8(frame)
        meta = {"shape": list(q.shape)}
        last = self._last.get(stream)
        payload = None
        staged: list[bytes] = []
        if self.delta and last is not None and last.shape == q.shape:
            if self.tiles:
                tmeta, payload, staged = self._encode_tiles(stream, q, last)
            else:
                diff = q - last
                payload = zlib.compress(diff.tobytes(), self.zlevel)
                tmeta = {"encoding": ZDELTA8}
            if len(payload) >= q.nbytes and not tmeta.get("refs"):
                # compression lost (noisy first-contact frames): ship raw.
                # (Frames with store refs always stay tiles8 — the refs are
                # the savings, and a raw frame would desync nothing but
                # would re-ship pixels the client already holds.)
                self.raw_fallbacks += 1
                payload = None
            else:
                meta.update(tmeta)
                if self.tiles:
                    self._commit_tiles(stream, staged)
                    self.tile_frames += 1
                    # counted only for frames that really shipped as tiles8
                    # (a raw fallback put zero tiles on the wire)
                    th, tw = self.tile
                    self.tiles_total += len(
                        tile_grid(q.shape[0], q.shape[1], th, tw)
                    )
                    self.tiles_shipped += len(tmeta["tiles"])
                    self.tiles_reffed += len(tmeta.get("refs") or [])
                else:
                    self.delta_frames += 1
        if payload is None:
            payload = q.tobytes()
            meta["encoding"] = RAW8
            self.raw_frames += 1
        self._last[stream] = q
        # any shipped frame covers the forced rows (raw and zdelta8 carry the
        # whole frame; tiles8 included them above): the mark is consumed
        self._force_rows.pop(stream, None)
        self.bytes_raw += q.nbytes
        self.bytes_sent += len(payload)
        return meta, payload

    def reset(self, stream: str | None = None, *, rows=None) -> None:
        """Drop delta state (one stream, or all): next frame is a keyframe.
        The tile store survives — its content stays bit-exact regardless of
        why the chain was cut, and the header's ``slot0`` keeps both ends'
        rings aligned across the reset.

        ``rows`` (tiles8 chains only) is the partial reset: instead of
        cutting the chain, the given tile rows are marked dirty so the next
        frame ships (or store-refs) their tiles even where the pixel diff is
        zero — the client's copies of exactly the invalidated rows get
        re-keyed while the rest of the frame stays delta-coded. Falls back to
        the full reset when the stream has no chain to patch or the encoder
        is not in tiles mode."""
        if rows is not None and stream is not None:
            rows = {int(r) for r in rows}
            if self.tiles and stream in self._last and rows:
                self._force_rows.setdefault(stream, set()).update(rows)
                return
            if not rows:
                return  # nothing dirty: the chain is intact
        if stream is None:
            self._last.clear()
            self._force_rows.clear()
        else:
            self._last.pop(stream, None)
            self._force_rows.pop(stream, None)

    def stats(self) -> dict:
        return {
            "delta": self.delta,
            "tiles": self.tiles,
            "raw_frames": self.raw_frames,
            "delta_frames": self.delta_frames,
            "tile_frames": self.tile_frames,
            "raw_fallbacks": self.raw_fallbacks,
            "tiles_total": self.tiles_total,
            "tiles_shipped": self.tiles_shipped,
            "tiles_reffed": self.tiles_reffed,
            "tiles_forced": self.tiles_forced,
            "tiles_shipped_frac": round(self.tiles_shipped / self.tiles_total, 4)
            if self.tiles_total
            else None,
            "bytes_sent": self.bytes_sent,
            "bytes_raw_equiv": self.bytes_raw,
            "compression": round(self.bytes_raw / self.bytes_sent, 3)
            if self.bytes_sent
            else None,
        }


class FrameDecoder:
    """Mirror of :class:`FrameEncoder`; lives in the client. Speaks every
    encoding, so one decoder follows whatever the negotiation picked."""

    def __init__(self):
        self._last: dict[str, np.ndarray] = {}
        # tile store (decoder side): slot -> absolute tile pixels, per stream
        self._store: dict[str, dict[int, np.ndarray]] = {}

    def _base(self, stream: str, shape: tuple, enc: str) -> np.ndarray:
        last = self._last.get(stream)
        if last is None or last.shape != shape:
            raise CodecError(
                f"stream {stream!r}: {enc} frame without a matching base"
            )
        return last

    def decode(self, stream: str, meta: dict, payload: bytes) -> np.ndarray:
        """Returns the frame as a READ-ONLY uint8 array (the same contract
        as the server's copy-on-write cache frames, and uniform across all
        encodings — mutate a ``.copy()``). Payload length is validated
        against the header geometry before any array op; mismatches raise
        :class:`CodecError` naming the stream."""
        shape = tuple(int(s) for s in meta["shape"])
        expected = int(np.prod(shape))
        enc = meta.get("encoding", RAW8)
        if enc == RAW8:
            if len(payload) != expected:
                raise CodecError(
                    f"stream {stream!r}: raw payload is {len(payload)} bytes, "
                    f"header shape {list(shape)} needs {expected}"
                )
            # zero-copy view over the wire bytes (already non-writable)
            q = np.frombuffer(payload, np.uint8).reshape(shape)
        elif enc == ZDELTA8:
            last = self._base(stream, shape, enc)
            raw = _zdecompress(payload, expected, stream, enc)
            diff = np.frombuffer(raw, np.uint8).reshape(shape)
            q = last + diff  # wraps mod 256, inverting the encoder exactly
            q.setflags(write=False)
        elif enc == TILES8:
            last = self._base(stream, shape, enc)
            th, tw = (int(x) for x in meta.get("tile") or (16, 16))
            if th <= 0 or tw <= 0:
                raise CodecError(f"stream {stream!r}: bad tile shape {meta.get('tile')}")
            grid = tile_grid(shape[0], shape[1], th, tw)
            ids = [int(t) for t in meta.get("tiles") or []]
            refs = [(int(t), int(s)) for t, s in meta.get("refs") or []]
            if any(not 0 <= t < len(grid) for t in ids + [t for t, _ in refs]):
                raise CodecError(
                    f"stream {stream!r}: tile ids out of range for a "
                    f"{len(grid)}-tile grid"
                )
            spans = [grid[t] for t in ids]
            sizes = [
                (ys.stop - ys.start) * (xs.stop - xs.start) * shape[2]
                for ys, xs in spans
            ]
            raw = _zdecompress(payload, sum(sizes), stream, enc)
            store = self._store.setdefault(stream, {})
            q = last.copy()
            # store references first: tiles the encoder knows we already hold
            for ti, slot in refs:
                ys, xs = grid[ti]
                tile = store.get(slot)
                want = (ys.stop - ys.start, xs.stop - xs.start, shape[2])
                if tile is None or tile.shape != want:
                    raise CodecError(
                        f"stream {stream!r}: tile ref to slot {slot} "
                        f"{'missing from' if tile is None else 'mismatched in'} "
                        f"the mirrored store"
                    )
                q[ys, xs] = tile
            # then shipped diffs — and mirror the encoder's store commits
            # (shipped tiles enter the ring in header order from slot0)
            slot = int(meta.get("slot0", 0))
            off = 0
            for (ys, xs), n in zip(spans, sizes):
                d = np.frombuffer(raw, np.uint8, count=n, offset=off).reshape(
                    ys.stop - ys.start, xs.stop - xs.start, shape[2]
                )
                q[ys, xs] = last[ys, xs] + d  # mod-256 patch, tile-exact
                store[slot] = np.ascontiguousarray(q[ys, xs])
                store.pop(slot - TILE_STORE_SLOTS, None)
                slot += 1
                off += n
            if len(store) > 2 * TILE_STORE_SLOTS:  # bound across slot0 jumps
                for s in [s for s in store if not slot - TILE_STORE_SLOTS <= s < slot]:
                    del store[s]
            q.setflags(write=False)
        else:
            raise CodecError(f"stream {stream!r}: unknown frame encoding {enc!r}")
        self._last[stream] = q
        return q
