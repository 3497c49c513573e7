"""Network frontend: asyncio gateway + multi-stream sessions over the
pipelined serving engine (PyTorch port of the JAX package's ``frontend``;
the wire format, frame encodings and metric names are the same, so either
package's client talks to either package's gateway).

The delivery side of the paper's "real-time post hoc and in situ
visualization": remote clients speak a small versioned binary protocol
(``protocol``), an asyncio TCP gateway (``gateway``) admission-controls them
into per-session bounded queues, and a session layer (``sessions``) maps
string stream ids — static trained scenes and scrubbable insitu timelines —
onto ONE shared ``RenderServer`` so every stream's traffic coalesces into
the same micro-batches, cache, and render functions. Frames travel as RGB8 or
zlib-compressed temporal deltas (``encode``), encoded off the event loop.

See ``launch/frontend.py`` for the CLI and
``benchmarks/frontend_load_torch.py`` for the localhost load methodology.
"""
from repro_torch.frontend.client import (
    AsyncFrontendClient,
    FrontendClient,
    RemoteRenderError,
    ShedError,
)
from repro_torch.frontend.encode import (
    CodecError,
    FrameDecoder,
    FrameEncoder,
    quantize_rgb8,
    tile_grid,
)
from repro_torch.frontend.gateway import Gateway, GatewayThread
from repro_torch.frontend.protocol import (
    ProtocolError,
    camera_from_wire,
    camera_to_wire,
    iter_messages,
    pack_message,
    read_message,
    write_message,
)
from repro_torch.frontend.sessions import (
    PendingRender,
    Session,
    SessionManager,
    StreamInfo,
)

__all__ = [
    "AsyncFrontendClient",
    "CodecError",
    "FrameDecoder",
    "FrameEncoder",
    "FrontendClient",
    "Gateway",
    "GatewayThread",
    "PendingRender",
    "ProtocolError",
    "RemoteRenderError",
    "Session",
    "SessionManager",
    "ShedError",
    "StreamInfo",
    "camera_from_wire",
    "camera_to_wire",
    "iter_messages",
    "pack_message",
    "quantize_rgb8",
    "read_message",
    "tile_grid",
    "write_message",
]
