"""Tensor-parallel serving: one logical engine over one process a rank.

Counterpart of ``scratchpad_tpu/parallel/multihost.py``, with "rank" in
place of "host". Rank 0, the leader, runs the scheduler, the engine and the
HTTP front; its ``ModelRunner`` is wrapped in :class:`LeaderRunner`, which
sends ``(method, payload)`` over a length-prefixed pickle TCP control plane
before it runs the method locally. Every other rank runs
:func:`follower_loop`: it receives the commands and replays them on its own
``ModelRunner``, over its own heads. The payloads are host-side (numpy)
batches, identical on every rank, and every rank samples from the same
gathered logits with the same seeded generator, so each rank's runner
issues the same collectives in the same order and draws the same tokens;
the device-resident handles of pipelined decode windows never travel, each
rank chains from its own.

Scope: the generate path (``run_extend``, ``run_decode_window``,
``decode_multi`` and the pipelined windows), ``run_embed``, ``run_score``,
``forward_logits``, and ``reset_counts`` / ``tp_report``, the counters each
rank reports back. The JAX module's other relays (draft and EAGLE
speculation, topping registration, the host KV tier, multimodal encoding,
weight update and pool resize) are refused (``REFUSED``; ROADMAP Queue 1,
item 10(c)).

Followers report back over the same sockets (``send_up``): a barrier, a
report, or the error that ends them. The leader waits for them with a
timeout and watches the follower processes, so a follower that dies or
raises makes the leader raise instead of hang.
"""

from __future__ import annotations

import collections
import pickle
import select
import socket
import struct
import threading
import time
from typing import Any, Callable, Optional

from scratchpad_tpu_torch.parallel import DIST_TIMEOUT_S
from scratchpad_tpu_torch.utils import get_logger

logger = get_logger("multihost")

_LEN = struct.Struct("!Q")


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("control-plane peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> Any:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return pickle.loads(_recv_exact(sock, n))


# an fp8 tensor of a weights message, as its bytes: PyTorch pickles a
# float8 tensor that it cannot load again
_FP8_BYTES = "float8_e4m3fn bytes"


def params_message(params: Optional[dict]) -> Optional[dict]:
    """A ``state_dict`` (or None) as the leader sends it to the followers:
    each fp8 tensor as ``(_FP8_BYTES, its uint8 view)``."""
    import torch

    if params is None:
        return None
    return {k: (_FP8_BYTES, t.view(torch.uint8)) if t.dtype == torch.float8_e4m3fn else t
            for k, t in params.items()}


def params_from_message(msg: Optional[dict]) -> Optional[dict]:
    """``params_message``'s ``state_dict`` again, code for code."""
    import torch

    if msg is None:
        return None
    return {k: v[1].view(torch.float8_e4m3fn) if isinstance(v, tuple) and v[0] == _FP8_BYTES else v
            for k, v in msg.items()}


class ControlPlane:
    """Leader: accept the followers' connections (ordered by rank), send
    them commands and wait for their replies. Follower: connect, receive,
    reply. Standard-library sockets only. ``DIST_TIMEOUT_S`` bounds the accept,
    the connect and every wait for a reply; ``watch`` (leader) raises where
    a follower process has ended, and is polled while the leader waits."""

    POLL = 0.25  # seconds between liveness checks while waiting

    def __init__(
        self,
        addr: str,
        num_followers: int,
        is_leader: bool,
        rank: int = 0,
        watch: Optional[Callable[[], None]] = None,
    ):
        host, port_s = addr.rsplit(":", 1)
        port = int(port_s)
        self.is_leader = is_leader
        self.timeout = DIST_TIMEOUT_S
        self._watch = watch or (lambda: None)
        deadline = time.monotonic() + self.timeout
        if is_leader:
            self._srv = socket.create_server((host, port), backlog=num_followers + 1)
            self._srv.settimeout(self.POLL)
            self._lock = threading.Lock()
            peers: dict[int, socket.socket] = {}
            while len(peers) < num_followers:
                self._check_deadline(deadline, "a follower to connect")
                try:
                    conn, _ = self._srv.accept()
                except socket.timeout:
                    continue
                conn.settimeout(None)
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                tag, r = _recv_msg(conn)
                if tag != "hello":
                    raise RuntimeError(f"control plane: {tag!r} from a peer that did not say hello")
                peers[r] = conn
            self._peers = [peers[r] for r in sorted(peers)]
        else:
            last = None
            while True:
                try:
                    self._sock = socket.create_connection((host, port), timeout=5)
                    break
                except OSError as e:
                    last = e
                    if time.monotonic() > deadline:
                        raise ConnectionError(f"cannot reach the leader at {addr}: {last}") from e
                    time.sleep(0.2)
            self._sock.settimeout(None)
            self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            _send_msg(self._sock, ("hello", rank))

    def check(self) -> None:
        """Raise where a follower process has ended (leader)."""
        self._watch()

    def _check_deadline(self, deadline: float, what: str) -> None:
        self.check()
        if time.monotonic() > deadline:
            raise TimeoutError(f"tensor parallel: no reply within {self.timeout} s waiting for {what}")

    # ---------------------------------------------------------------- leader

    def broadcast(self, obj: Any) -> None:
        with self._lock:
            for p in self._peers:
                _send_msg(p, obj)

    def send(self, i: int, obj: Any) -> None:
        """To follower ``i`` (rank ``i + 1``) alone."""
        with self._lock:
            _send_msg(self._peers[i], obj)

    def gather(self, tag: str) -> list:
        """One ``(tag, payload)`` reply from each follower, by rank; a
        follower's ``("error", traceback)`` raises it here, as does a
        follower that ends or stays silent for ``timeout``."""
        out = []
        for i, p in enumerate(self._peers):
            deadline = time.monotonic() + self.timeout
            while not select.select([p], [], [], self.POLL)[0]:
                self._check_deadline(deadline, f"rank {i + 1}'s {tag!r}")
            try:
                got, payload = _recv_msg(p)
            except ConnectionError as e:
                raise RuntimeError(f"tensor-parallel rank {i + 1} closed the control plane") from e
            if got == "error":
                raise RuntimeError(f"tensor-parallel rank {i + 1} failed:\n{payload}")
            if got != tag:
                raise RuntimeError(f"rank {i + 1} answered {got!r} to {tag!r} (command stream desync)")
            out.append(payload)
        return out

    def pending_errors(self) -> list[str]:
        """The errors followers have sent and nobody read yet."""
        out = []
        for i, p in enumerate(self._peers):
            try:
                while select.select([p], [], [], 0)[0]:
                    tag, payload = _recv_msg(p)
                    if tag == "error":
                        out.append(f"rank {i + 1}:\n{payload}")
            except (OSError, ConnectionError, EOFError):
                pass
        return out

    # -------------------------------------------------------------- follower

    def recv(self) -> Any:
        return _recv_msg(self._sock)

    def send_up(self, obj: Any) -> None:
        _send_msg(self._sock, obj)

    def close(self) -> None:
        if self.is_leader:
            for p in self._peers:
                try:
                    _send_msg(p, ("stop", None))
                    p.close()
                except OSError:
                    pass
            self._srv.close()
        else:
            self._sock.close()


# Runner methods whose (numpy-only) arguments are sent verbatim.
PLAIN_METHODS = (
    "run_extend",
    "run_decode_window",
    "decode_multi",
    "run_embed",
    "run_score",
    "forward_logits",
    "reset_counts",
)
# Runner methods that touch the device but are not relayed in this slice:
# refused on the leader, which would otherwise run them alone and leave the
# followers out of step (ROADMAP Queue 1, item 10(c))
REFUSED = (
    "run_extend_with_hidden", "run_kv_only", "run_spec_verify", "run_spec_verify_h",
    "run_spec_verify_sampled", "encode_images", "encode_videos", "image_token_embedding",
    "write_cross", "gather_pages", "scatter_pages", "resize_kv_pool", "update_weights",
    "attach_toppings",
)


class LeaderRunner:
    """Wrap the leader's ModelRunner: send each device-touching call to the
    followers, then run it locally. Host-only state (allocators, configs)
    passes through untouched via ``__getattr__``."""

    def __init__(self, inner, ctrl: ControlPlane):
        self._inner = inner
        self._ctrl = ctrl
        for name in PLAIN_METHODS:
            setattr(self, name, self._make_plain(name))

    def __getattr__(self, name):
        if name in REFUSED:
            raise NotImplementedError(
                f"{name} under tp_size > 1 is not relayed to the followers yet "
                "(ROADMAP Queue 1, item 10(c))"
            )
        return getattr(self._inner, name)

    def _send(self, obj) -> None:
        try:
            self._ctrl.check()
            self._ctrl.broadcast(obj)
        except (OSError, RuntimeError) as e:
            raise RuntimeError(
                f"tensor parallel: a follower is gone ({e}); " + " ".join(self._ctrl.pending_errors())
            ) from e

    def _make_plain(self, name):
        inner_fn = getattr(self._inner, name)

        def call(*args, **kwargs):
            self._send((name, (args, kwargs)))
            return inner_fn(*args, **kwargs)

        return call

    # a pipelined window's handle stays on the device: send only whether the
    # window chains, and every rank chains from its own last ids
    def dispatch_decode_window(self, wb, num_steps, prev_tokens=None):
        self._send(("dispatch_decode_window", ((wb, num_steps), prev_tokens is not None)))
        return self._inner.dispatch_decode_window(wb, num_steps, prev_tokens)

    def fetch_decode_window(self, pending):
        # followers fetch too: it frees their handle and keeps every rank's
        # windows in flight in step
        self._send(("fetch_decode_window", None))
        return self._inner.fetch_decode_window(pending)

    def follower_reports(self) -> list[dict]:
        """Each follower's ``ModelRunner.tp_report()``, by rank."""
        self._send(("tp_report", None))
        return self._ctrl.gather("report")

    def shutdown(self):
        self._ctrl.close()


def follower_loop(runner, ctrl: ControlPlane) -> None:
    """Replay the leader's command stream on this rank's ModelRunner until
    "stop". Pending decode windows form a FIFO: with window pipelining the
    leader interleaves [dispatch W(n+1) chained, fetch W(n)], so a follower
    chains from the NEWEST handle's device-resident ids while it fetches the
    OLDEST."""
    pending: collections.deque = collections.deque()
    while True:
        name, payload = ctrl.recv()
        if name == "stop":
            logger.info("follower: stop received")
            return
        if name == "dispatch_decode_window":
            (wb, num_steps), chained = payload
            if chained and not pending:
                raise RuntimeError("follower: chained dispatch with no window in flight (command stream desync)")
            prev = pending[-1].last_ids if chained else None
            pending.append(runner.dispatch_decode_window(wb, num_steps, prev))
        elif name == "fetch_decode_window":
            if not pending:
                raise RuntimeError("follower: fetch with no window in flight (command stream desync)")
            runner.fetch_decode_window(pending.popleft())
        elif name == "tp_report":
            ctrl.send_up(("report", runner.tp_report()))
        elif name in PLAIN_METHODS:
            args, kwargs = payload
            getattr(runner, name)(*args, **kwargs)
        else:
            raise RuntimeError(f"follower: unknown command {name!r}")


def watch_processes(procs) -> Callable[[], None]:
    """A ``ControlPlane`` watch: raises once a follower process has ended."""

    def watch() -> None:
        for r, p in enumerate(procs, start=1):
            if not p.is_alive():
                raise RuntimeError(f"tensor-parallel rank {r} exited with code {p.exitcode}")

    return watch


def start_followers(args, model_config, entry) -> list:
    """Start ranks 1 to tp - 1 as ``spawn`` processes running ``entry(args,
    rank, model_config)`` (the leader has already initialised CUDA, so never
    ``fork``)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [
        ctx.Process(target=entry, args=(args, r, model_config), name=f"tp-rank-{r}", daemon=True)
        for r in range(1, args.tp_size)
    ]
    for p in procs:
        p.start()
    return procs


def stop_followers(procs, timeout: float = DIST_TIMEOUT_S) -> None:
    """Join the followers, ending those still running after ``timeout``."""
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
        if p.is_alive():
            p.kill()
            p.join(5)
