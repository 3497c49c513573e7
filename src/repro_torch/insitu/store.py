"""Temporal checkpoint store: keyframes + quantized delta frames (PyTorch
port of the JAX package's ``insitu/store.py``).

A streamed sequence multiplies checkpoint cost by T: an 18M-Gaussian model is
~1 GB of float32 per timestep, so storing every timestep verbatim is exactly
the volume-dump I/O burden in-situ reconstruction exists to avoid. But
consecutive warm-started models differ by a few optimization steps, so the
parameter *delta* is tiny and narrow — ideal for quantization.

Layout (on top of ``repro_torch.checkpoint.store``), the JAX package's byte
for byte in the arrays, so a sequence written by either package loads in
the other:

  <dir>/sequence.json            ordered timestep index (kind, base, files)
  <dir>/step_<t>/...             keyframes — the standard checkpoint layout,
                                 restorable by ``restore_checkpoint`` alone
  <dir>/delta_<t>.npz            per-leaf int16-quantized (x_t - x_recon_{t-1})
                                 plus per-leaf scales and sparse exact rows

Deltas chain against the *reconstructed* previous frame (not the exact one),
so quantization error never accumulates along the chain: every frame is within
half a quantum of its true value regardless of distance from the keyframe.

Not every per-Gaussian delta is small: dead-slot reseeding moves a padding
row's mean from the 1e6 sentinel into the scene — a jump six orders of
magnitude above the training deltas, which would poison a shared
max-abs-based quantization scale for the whole leaf. Rows whose delta exceeds
``exact_jump_thresh`` are therefore stored *exactly* (sparse float32 indices
+ values) and excluded from the scale; the remaining rows quantize against a
tight scale. ``load(t)`` restores the nearest keyframe at or before t and
replays deltas (quantized part, then exact-row overwrite).

**Asynchronous writes.** Delta quantization and ``np.savez_compressed`` are
pure host work; running them inline stalls the training loop between
timesteps. With ``async_writes=True`` (the default) ``append`` only pulls the
params to host (cheap, and required before the trainer mutates them again)
and hands the encode+write to a single background writer thread, so the
stream's next timestep trains while the previous one compresses. Appends are
processed strictly in order (one thread, FIFO queue — the delta chain needs
it); every read (``load``/``timesteps``/``stats``) flushes pending writes
first, and ``flush()``/``close()`` make durability explicit. A failure in the
writer surfaces on the next ``append``/``flush``.
"""
from __future__ import annotations

import json
import os
import queue
import threading
import time

import numpy as np

from repro_torch.checkpoint.store import _leaf_to_host, restore_checkpoint, save_checkpoint
from repro_torch.core import gaussians as G

_QMAX = 32767  # int16 symmetric range


def _to_host(params: G.GaussianModel) -> dict[str, np.ndarray]:
    """Host copy of every leaf (tensors on any device, or numpy): a copy,
    never a view, because the caller goes on to change its tensors while
    the writer thread still encodes this one."""
    return {
        f: np.array(_leaf_to_host(getattr(params, f)), np.float32)
        for f in G.GaussianModel._fields
    }


class TemporalCheckpointStore:
    """Append-only per-timestep store of ``GaussianModel`` params."""

    def __init__(
        self,
        directory: str,
        *,
        keyframe_interval: int = 4,
        exact_jump_thresh: float = 1.0,
        async_writes: bool = True,
    ):
        assert keyframe_interval >= 1
        self.directory = directory
        self.exact_jump_thresh = float(exact_jump_thresh)
        self.async_writes = async_writes
        os.makedirs(directory, exist_ok=True)
        self._index_path = os.path.join(directory, "sequence.json")
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)
            # the sequence on disk owns its parameters: reopening with
            # different constructor values must not change cadence or
            # jump-detection mid-sequence
            self.keyframe_interval = int(self._index["keyframe_interval"])
            self.exact_jump_thresh = float(self._index.get("exact_jump_thresh", exact_jump_thresh))
        else:
            self.keyframe_interval = keyframe_interval
            self._index = {
                "keyframe_interval": keyframe_interval,
                "exact_jump_thresh": self.exact_jump_thresh,
                "timesteps": [],
            }
        # submit-side view of the sequence (the writer thread lags behind):
        # monotonicity and key-vs-delta cadence are decided at append() time
        self._submitted = len(self._index["timesteps"])
        self._last_t = self._index["timesteps"][-1]["t"] if self._index["timesteps"] else None

        # background writer: created lazily on the first async append
        self._queue: queue.Queue | None = None
        self._writer: threading.Thread | None = None
        self._writer_err: BaseException | None = None
        self._closed = False

        # overlap metrics: host time spent inside append() (what the caller's
        # loop pays) vs. inside the encode+write itself (what was hidden)
        self.append_s = 0.0
        self.write_s = 0.0

        # reconstructed previous frame, kept so deltas chain without drift
        self._recon: dict[str, np.ndarray] | None = None
        if self._index["timesteps"]:
            self._recon = _to_host(self.load(self._index["timesteps"][-1]["t"]))
        # The fields _recon, _index, _writer_err and write_s cross the
        # writer-thread boundary ordered by the bounded queue + flush()'s
        # queue.join(), not by a lock. (The JAX package's runtime race
        # sanitizer, analysis.tsan, is not ported.)

    # ------------------------------------------------------------------ write
    def append(self, t: int, params: G.GaussianModel) -> str:
        """Store timestep ``t``; returns the path (to be) written. ``t`` must
        be strictly greater than every stored timestep. With async writes the
        encode+write happens on the writer thread; call ``flush()`` (or any
        read) to wait for durability. (If an earlier background write failed,
        the writer may promote this frame from delta to keyframe — the index
        records the actual kind; the predicted path is best-effort.)"""
        assert not self._closed, "append() after close()"
        self._raise_writer_error()
        assert self._last_t is None or t > self._last_t, (t, self._last_t)
        t0 = time.perf_counter()
        is_key = (self._submitted % self.keyframe_interval == 0) or self._submitted == 0
        self._last_t = t
        self._submitted += 1
        host = _to_host(params)  # must copy out before the caller mutates
        if is_key:
            path = os.path.join(self.directory, f"step_{t:08d}")
        else:
            path = os.path.join(self.directory, f"delta_{t:08d}.npz")
        if self.async_writes:
            if self._writer is None:
                # bounded: each entry is a full host copy of the params, so a
                # writer slower than training must backpressure append() here
                # rather than grow the queue (and host memory) without limit
                self._queue = queue.Queue(maxsize=2)  # analysis: allow(locks.thread_shared_write, written before Thread.start(); thread-start happens-before publishes it to the writer)
                self._writer = threading.Thread(
                    target=self._writer_loop, name="temporal-store-writer", daemon=True
                )
                self._writer.start()
            self._queue.put((t, host, is_key))
        else:
            self._write(t, host, is_key)
        self.append_s += time.perf_counter() - t0
        return path

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            try:
                # keep writing after a failure: _recon and the index reflect
                # only successful writes, so later frames stay self-consistent
                # (deltas chain against the last *stored* frame) — only the
                # failed timestep is lost, and flush()/append() report it
                self._write(*item)
            except BaseException as e:  # analysis: allow(hygiene.broad_except, writer must survive any failure to keep draining; first error is surfaced on the next append/flush)
                if self._writer_err is None:  # first failure wins
                    self._writer_err = (item[0], e)  # analysis: allow(locks.thread_shared_write, single-writer field; readers are ordered behind it by queue.join() in flush())
            finally:
                self._queue.task_done()

    def _write(self, t: int, host: dict[str, np.ndarray], is_key: bool) -> None:
        """Encode + persist one timestep (writer thread in async mode)."""
        t0 = time.perf_counter()
        ts = self._index["timesteps"]
        if self._recon is None:
            # no reconstruction base (e.g. the sequence's first keyframe
            # failed to write): a delta is impossible — promote to keyframe
            is_key = True
        if is_key:
            save_checkpoint(self.directory, t, G.GaussianModel(**host))
            ts.append({"t": t, "kind": "key"})
            self._recon = host
        else:
            payload, recon = {}, {}
            for name, x in host.items():
                diff = x - self._recon[name]
                # rows with a discontinuous jump (reseeded dead slots leaving
                # the 1e6 sentinel) are stored exactly and kept out of the
                # quantization scale, which stays tight for the smooth rows
                row_max = np.abs(diff.reshape(diff.shape[0], -1)).max(axis=1)
                jump = np.nonzero(row_max > self.exact_jump_thresh)[0]
                smooth_max = float(np.delete(row_max, jump).max()) if jump.size < row_max.size else 0.0
                scale = smooth_max / _QMAX or 1.0
                q = np.clip(np.round(diff / scale), -_QMAX, _QMAX).astype(np.int16)
                q[jump] = 0
                r = self._recon[name] + q.astype(np.float32) * scale
                r[jump] = x[jump]
                payload[name] = q
                payload[name + "__scale"] = np.float32(scale)
                payload[name + "__jump_idx"] = jump.astype(np.int32)
                payload[name + "__jump_val"] = x[jump].astype(np.float32)
                recon[name] = r
            np.savez_compressed(os.path.join(self.directory, f"delta_{t:08d}.npz"), **payload)
            ts.append({"t": t, "kind": "delta"})
            self._recon = recon
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)
        self.write_s += time.perf_counter() - t0  # analysis: allow(locks.thread_shared_write, written only by the writer thread (or sync path); stats() readers are ordered behind flush()'s queue.join())

    # ------------------------------------------------------------- lifecycle
    def _raise_writer_error(self) -> None:
        if self._writer_err is not None:
            (t, err), self._writer_err = self._writer_err, None
            raise RuntimeError(
                f"temporal store background write failed for timestep {t}; "
                "that timestep is NOT on disk (later appends are unaffected — "
                "deltas chain against the last successfully stored frame)"
            ) from err

    def flush(self) -> None:
        """Block until every queued append is durable on disk."""
        if self._queue is not None:
            self._queue.join()
        self._raise_writer_error()

    def close(self) -> None:
        """Flush pending writes and stop the writer thread. Idempotent."""
        if self._closed:
            return
        if self._writer is not None:
            self._queue.join()
            self._queue.put(None)  # sentinel: writer exits after draining
            self._writer.join()
            self._writer = None
        self._closed = True
        self._raise_writer_error()

    def __enter__(self) -> "TemporalCheckpointStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------- read
    def timesteps(self) -> list[int]:
        self.flush()
        return [e["t"] for e in self._index["timesteps"]]

    def _entry(self, t: int) -> int:
        for i, e in enumerate(self._index["timesteps"]):
            if e["t"] == t:
                return i
        raise KeyError(f"timestep {t} not in store (have {self.timesteps()})")

    def _load_key(self, t: int) -> dict[str, np.ndarray]:
        with open(os.path.join(self.directory, f"step_{t:08d}", "manifest.json")) as f:
            man = json.load(f)
        shapes = {f: man["leaves"][f]["shape"] for f in G.GaussianModel._fields}
        like = G.GaussianModel(**{f: np.zeros(shapes[f], np.float32) for f in G.GaussianModel._fields})
        return _to_host(restore_checkpoint(self.directory, t, like))

    def load(self, t: int) -> G.GaussianModel:
        """Reconstruct timestep ``t``: nearest keyframe <= t, then deltas."""
        self.flush()
        i = self._entry(t)
        entries = self._index["timesteps"]
        k = i
        while entries[k]["kind"] != "key":
            k -= 1
        frame = self._load_key(entries[k]["t"])
        for e in entries[k + 1 : i + 1]:
            with np.load(os.path.join(self.directory, f"delta_{e['t']:08d}.npz")) as z:
                for name in G.GaussianModel._fields:
                    x = frame[name] + z[name].astype(np.float32) * float(z[name + "__scale"])
                    jump = z[name + "__jump_idx"]
                    if jump.size:
                        x[jump] = z[name + "__jump_val"]
                    frame[name] = x
        return G.GaussianModel(**frame)

    def changed_slots(self, t: int) -> np.ndarray | None:
        """Gaussian slots timestep ``t`` changed relative to ``t-1``, straight
        from the stored delta encoding (no params diff): the union over leaves
        of rows with a nonzero quantized delta plus the sparse exact-jump rows
        (reseeded slots). Returns ``None`` for keyframes — a keyframe carries
        no delta, so the change set is unknown and callers must assume
        everything (exactly what ``RenderServer.add_timestep`` without
        ``changed=`` does). Post hoc replay uses this to drive world-space
        invalidation with zero trainer involvement.
        """
        self.flush()
        i = self._entry(int(t))
        e = self._index["timesteps"][i]
        if e["kind"] == "key":
            return None
        rows: set[int] = set()
        with np.load(os.path.join(self.directory, f"delta_{e['t']:08d}.npz")) as z:
            for name in G.GaussianModel._fields:
                q = z[name]
                nz = np.nonzero(q.reshape(q.shape[0], -1).any(axis=1))[0]
                rows.update(int(r) for r in nz)
                rows.update(int(r) for r in z[name + "__jump_idx"])
        return np.asarray(sorted(rows), np.int64)

    # ---------------------------------------------------------------- metrics
    def stats(self) -> dict:
        """On-disk footprint: delta frames vs keyframes (the compression win).
        Flushes first, so the numbers cover every append."""
        self.flush()
        key_b, delta_b, n_key, n_delta = 0, 0, 0, 0
        for e in self._index["timesteps"]:
            if e["kind"] == "key":
                d = os.path.join(self.directory, f"step_{e['t']:08d}")
                key_b += sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
                n_key += 1
            else:
                delta_b += os.path.getsize(os.path.join(self.directory, f"delta_{e['t']:08d}.npz"))
                n_delta += 1
        return {
            "timesteps": len(self._index["timesteps"]),
            "keyframes": n_key,
            "delta_frames": n_delta,
            "keyframe_bytes": key_b,
            "delta_bytes": delta_b,
            "mean_key_bytes": key_b // max(n_key, 1),
            "mean_delta_bytes": delta_b // max(n_delta, 1),
            "delta_compression": (
                round((key_b / n_key) / (delta_b / n_delta), 2) if n_key and delta_b else None
            ),
            "async_writes": self.async_writes,
            "append_wall_s": round(self.append_s, 4),
            "write_s": round(self.write_s, 4),
        }
