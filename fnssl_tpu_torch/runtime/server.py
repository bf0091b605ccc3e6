"""Line-protocol streaming localization server (port of
``fnssl_tpu/runtime/server.py``: the same wire protocol).

The deployment endpoint the reference ecosystem leaves to the user:
`cli serve` turns a checkpoint (or fresh weights from a seed) into a TCP
service that accepts raw PCM and emits DOA/VAD per model output block.
One connection = one independent stream (own model state, own
forgetting-norm statistics); connections are handled concurrently, each
on its own thread with its own model steps, or, under ``cli serve
--slots``, a leased slot of a ``runtime.slots.BatchedStreamPool`` whose
ticks batch the connections' chunk steps.

Wire protocol (newline-framed JSON control, length-framed binary audio):

  client → server   one JSON header line:
                      {"nch": 2}            # channels in the PCM
  client → server   repeated audio blocks:
                      4-byte big-endian uint32 N, then N bytes of
                      float32 little-endian PCM, interleaved
                      (nsample × nch) — any block size
  server → client   one JSON line per fired model output:
                      {"t": <output index>, "doa_deg": [...],
                       "vad": [...]}
  client → server   zero-length block (N=0) = end of stream; the server
                    replies {"eof": true, "outputs": <count>} and closes.

Everything is plain sockets — no framework dependency — so a client is
~15 lines in any language.

Flow-control note: the server alternates read-block → send-outputs, so
a client that pumps a very long recording without ever reading responses
can fill both TCP buffers and stall the pair. Live clients read as they
send (audio arrives in real time); batch clients should either read
concurrently or keep the response volume under the OS socket-buffer
budget (~100 bytes per 192 ms output block — minutes of audio fit). A
pair that does wedge is bounded, not hung: every connection carries a
send timeout (``send_timeout_s``) after which the server drops it.

Error-path duplexing: when the server rejects a stream (bad header,
wrong channel count, decode failure) it half-closes its write side and
DRAINS the client's remaining bytes until EOF before closing, so the
error JSON survives in the client's receive buffer instead of being
destroyed by a TCP reset. ``stream_client`` mirrors this: a send
failure (server already closed the read side) falls through to the
response reader to collect the server's verdict.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Callable

import numpy as np


def _read_exact(f, n: int) -> bytes | None:
    """Exact read from the connection's buffered reader. ALL reads must
    go through the same makefile object — the header readline() buffers
    ahead, so mixing in raw socket.recv() would skip buffered bytes and
    desynchronize the protocol."""
    buf = f.read(n)
    return buf if buf is not None and len(buf) == n else None


class LocalizationServer:
    """TCP server: per-connection StreamingLocalizer + DOA decode.

    Args:
      session_factory: () -> (localizer, decode) where ``localizer`` is
        a fresh StreamingLocalizer and ``decode(chunk) -> dict`` maps a
        model output block to {'doa' (1, k, 2[, ns]) radians,
        'vad_sources' (1, k[, ns])}.
      host/port: bind address; port=0 picks a free port (see .port).
      pool: the slot pool the sessions lease from, if any; closed by
        ``shutdown``.
    """

    def __init__(self, session_factory: Callable, host: str = "127.0.0.1",
                 port: int = 0, send_timeout_s: float = 30.0, pool=None):
        self.session_factory = session_factory
        self.pool = pool
        self.send_timeout_s = send_timeout_s
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    def serve_forever(self):
        """Accept loop (blocking). Call .shutdown() from another thread
        (or a signal handler) to stop."""
        self._sock.settimeout(0.5)
        while not self._stop.is_set():
            # reap finished connection threads: a long-lived daemon must
            # not grow its bookkeeping with total connections served
            self._threads = [t for t in self._threads if t.is_alive()]
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._sock.close()

    def start(self):
        """serve_forever on a daemon thread; returns self."""
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def shutdown(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        if hasattr(self, "_accept_thread"):
            self._accept_thread.join(timeout=5.0)
        if self.pool is not None:
            self.pool.close()

    # ------------------------------------------------------- connection

    @staticmethod
    def _reject(conn: socket.socket, f, payload: bytes,
                drain_timeout_s: float = 5.0):
        """Deliverable-error close: send ``payload``, half-close the
        write side, then drain whatever the client is still sending
        until it sees our FIN and closes. Closing outright while bytes
        are in flight makes the kernel answer the client's next block
        with RST, which destroys the unread error JSON in the client's
        receive buffer — the race this method exists to prevent."""
        try:
            conn.sendall(payload)
            conn.shutdown(socket.SHUT_WR)
        except OSError:
            return
        conn.settimeout(drain_timeout_s)
        try:
            while f.read(65536):
                pass
        except (OSError, ValueError):
            pass

    def _handle(self, conn: socket.socket):
        f = None
        localizer = None
        try:
            # bound sendall: a peer that never reads (both TCP buffers
            # full) wedges this thread forever otherwise. SO_SNDTIMEO
            # bounds only sends — a live stream may legitimately pause
            # between pushes for longer than this.
            sec = int(self.send_timeout_s)
            usec = int((self.send_timeout_s - sec) * 1e6)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                            struct.pack("ll", sec, usec))
            # small JSON replies must not sit in Nagle's buffer waiting
            # for the peer's delayed ACK — this is an RPC-shaped
            # protocol, latency beats packet coalescing
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            f = conn.makefile("rb")
            header = json.loads(f.readline().decode())
            nch = int(header["nch"])
            localizer, decode = self.session_factory()
            if localizer.nch != nch:
                self._reject(conn, f, json.dumps(
                    {"error": f"server model expects nch="
                              f"{localizer.nch}, got {nch}"}).encode()
                    + b"\n")
                return
            emitted = 0
            while True:
                head = _read_exact(f, 4)
                if head is None:
                    break                          # client vanished
                (n,) = struct.unpack(">I", head)
                if n == 0:                         # clean end of stream
                    conn.sendall(json.dumps(
                        {"eof": True, "outputs": emitted}).encode()
                        + b"\n")
                    break
                payload = _read_exact(f, n)
                if payload is None:
                    break
                pcm = np.frombuffer(payload, "<f4").reshape(-1, nch)
                # batch this block's responses into ONE sendall: a
                # write per output line is a syscall + packet each
                lines: list[bytes] = []
                for out in localizer.push(pcm):
                    res = decode(out)
                    doa = np.degrees(res["doa"].cpu().numpy())[0]
                    vad = res["vad_sources"].cpu().numpy()[0]
                    for k in range(doa.shape[0]):
                        msg = {"t": emitted,
                               "doa_deg": np.round(doa[k], 3).tolist(),
                               "vad": np.round(vad[k], 4).tolist()}
                        lines.append(json.dumps(msg).encode() + b"\n")
                        emitted += 1
                if lines:
                    conn.sendall(b"".join(lines))
        except (ConnectionError, json.JSONDecodeError, KeyError,
                ValueError, RuntimeError) as e:
            if f is not None:
                self._reject(conn, f, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode()
                    + b"\n")
        finally:
            # a slot-pool session releases its slot on disconnect
            close = getattr(getattr(localizer, "model_step", None), "close",
                            None)
            if close is not None:
                close()
            conn.close()


def stream_client(host: str, port: int, sig: np.ndarray,
                  block: int = 1600, read_every: int = 0):
    """Reference client: send (nsample, nch) float32 PCM in ``block``-
    sample pieces, return the server's decoded outputs. (Also the test
    harness — the protocol is trivial enough that this IS the spec.)

    A send failure means the server closed its read side early (e.g. it
    rejected the header); the client then falls through to the response
    reader to collect the server's pending messages — crashing in
    ``sendall`` would lose the error JSON the server made deliverable.

    ``read_every`` > 0 interleaves a response read after every N sent
    blocks (the live-client pattern); 0 sends everything first (batch
    pattern — fine while responses fit the OS socket buffer).
    """
    out = []
    with socket.create_connection((host, port)) as conn:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        f = conn.makefile("rb")
        conn.setblocking(True)
        done = False

        def _read_one() -> bool:          # True = stream finished
            line = f.readline()
            if not line:
                return True
            msg = json.loads(line.decode())
            out.append(msg)
            return "eof" in msg or "error" in msg
        try:
            conn.sendall(json.dumps({"nch": int(sig.shape[1])}).encode()
                         + b"\n")
            sent = 0
            for start in range(0, sig.shape[0], block):
                payload = np.ascontiguousarray(
                    sig[start: start + block], "<f4").tobytes()
                conn.sendall(struct.pack(">I", len(payload)) + payload)
                sent += 1
                if read_every and sent % read_every == 0:
                    if _read_one():
                        done = True
                        break
            if not done:
                conn.sendall(struct.pack(">I", 0))
        except (BrokenPipeError, ConnectionResetError):
            pass            # server closed early — read its verdict below
        while not done:
            done = _read_one()
    return out
