"""Channel front door for the continuous-batching scheduler.

`ChannelServer` turns the paper's Channels frontend into the server's actual
request path, rebuilt on the unified completion API: request arrival is an
asynchronous channel pop (`pop_async()` Future) the serve loop multiplexes
with decode ticks, and when fully idle the server parks on that Future
instead of spinning — a pop timeout loops back around rather than crashing
the loop.

Every scheduler tick the server (1) ingests any requests whose pop futures
completed, (2) admits as many as there are free slots — new work joins
mid-decode of older work — and (3) replies per-request.

Wire protocol (JSON, NUL-padded to the channel's msg_size):
    request:        {"id": str, "prompt": [int], "steps": int[, "eos": int]}
    reply (terse):  {"id": str, "tokens": [int], "finish_reason": str}

With ``stream_interval=k`` the server streams instead: every k decode ticks
each active request gets a delta chunk, and completion sends the terminal
chunk — clients see tokens as they decode, not one reply at completion:
    delta chunk:    {"id": str, "delta": [int], "done": false}
    terminal chunk: {"id": str, "delta": [int], "done": true,
                     "finish_reason": str}
Reassembly: concatenate `delta` lists in arrival order per id; chunks of one
request are pushed in order, so a per-id concatenation is always the prefix
of the final token list.

Oversized encodings raise `ChannelMessageTooLargeError` instead of silently
corrupting the ring (`ljust` cannot shrink a payload).
"""
from __future__ import annotations

import json
from collections import deque
from typing import List, Optional

from repro_torch.core.definitions import FutureTimeoutError
from repro_torch.frontends.channels import ChannelMessageTooLargeError, pop_future

from .scheduler import ContinuousBatchingScheduler, FinishedRequest, Request


class ChannelServer:
    """Consumes requests from a channel consumer (`pop_async`/`try_pop`) and
    posts replies through `reply_sender.push(bytes)` — typically a
    per-client router over SPSC reply channels.

    Parameters
    ----------
    stream_interval:
        None (default) keeps the terse one-reply-per-request protocol.
        An integer k enables streaming replies: delta chunks every k decode
        ticks plus a terminal chunk per request.
    """

    def __init__(
        self,
        scheduler: ContinuousBatchingScheduler,
        consumer,
        reply_sender,
        *,
        msg_size: int = 1024,
        idle_timeout: float = 60.0,
        stream_interval: Optional[int] = None,
    ):
        if stream_interval is not None and stream_interval < 1:
            raise ValueError("stream_interval must be >= 1 (or None)")
        self.scheduler = scheduler
        self.consumer = consumer
        self.reply = reply_sender
        self.msg_size = msg_size
        self.idle_timeout = idle_timeout
        self.stream_interval = stream_interval
        #: tokens already streamed per active request id
        self._streamed: dict[str, int] = {}
        #: decoded-but-unadmitted requests (ingested while the table was full)
        self._backlog: "deque[Request]" = deque()
        #: requests settled over this server's lifetime (replied or rejected)
        self._settled = 0
        self._ticks_since_stream = 0
        #: the armed arrival future (one outstanding pop at a time)
        self._pop_fut = None

    # -- wire codecs ---------------------------------------------------------
    @staticmethod
    def decode_request(raw: bytes) -> Request:
        body = json.loads(bytes(raw).rstrip(b"\0").decode())
        return Request(
            rid=body["id"],
            prompt=body["prompt"],
            max_new_tokens=body["steps"],
            eos_id=body.get("eos"),
        )

    def _pad(self, data: bytes, what: str) -> bytes:
        if len(data) > self.msg_size:
            raise ChannelMessageTooLargeError(
                f"{what} is {len(data)} bytes, channel msg_size is "
                f"{self.msg_size}; raise msg_size or lower steps"
            )
        return data.ljust(self.msg_size, b"\0")

    def encode_reply(self, fin: FinishedRequest) -> bytes:
        data = json.dumps(
            {"id": fin.rid, "tokens": fin.tokens, "finish_reason": fin.finish_reason}
        ).encode()
        return self._pad(data, f"reply for request {fin.rid!r}")

    def encode_chunk(
        self,
        rid: str,
        delta: List[int],
        *,
        done: bool,
        finish_reason: Optional[str] = None,
    ) -> bytes:
        body = {"id": rid, "delta": delta, "done": done}
        if done:
            body["finish_reason"] = finish_reason
        return self._pad(json.dumps(body).encode(), f"chunk for request {rid!r}")

    def encode_error(self, rid: Optional[str], message: str) -> bytes:
        data = json.dumps({"id": rid, "error": message[: self.msg_size // 2]}).encode()
        return data[: self.msg_size].ljust(self.msg_size, b"\0")

    # -- streaming -----------------------------------------------------------
    def _push_delta(
        self,
        rid: str,
        delta: List[int],
        *,
        done: bool,
        finish_reason: Optional[str] = None,
    ) -> None:
        """Push `delta` as one chunk, splitting into several fitting chunks
        when its encoding exceeds msg_size — the client's per-id
        concatenation must always be a prefix of the final token list, so
        tokens are never dropped. Only the last piece carries the terminal
        flags."""
        pieces: deque[List[int]] = deque([delta])
        while pieces:
            piece = pieces.popleft()
            last = not pieces
            try:
                self.reply.push(
                    self.encode_chunk(
                        rid,
                        piece,
                        done=done and last,
                        finish_reason=finish_reason if (done and last) else None,
                    )
                )
            except ChannelMessageTooLargeError as e:
                if len(piece) <= 1:
                    # even a single token cannot fit: unreassemblable
                    # protocol breakdown — tell the client rather than hang
                    self.reply.push(self.encode_error(rid, str(e)))
                    continue
                mid = len(piece) // 2
                pieces.appendleft(piece[mid:])
                pieces.appendleft(piece[:mid])

    def _stream_deltas(self) -> None:
        """Push delta chunks for every active request that grew since its
        last chunk (delta = tokens past the streamed high-water mark)."""
        for rid, emitted in self.scheduler.active_progress().requests.items():
            sent = self._streamed.get(rid, 0)
            if len(emitted) > sent:
                self._streamed[rid] = len(emitted)
                self._push_delta(rid, emitted[sent:], done=False)

    def _reply_finished(self, fin: FinishedRequest) -> None:
        if self.stream_interval is None:
            try:
                self.reply.push(self.encode_reply(fin))
            except ChannelMessageTooLargeError as e:
                self.reply.push(self.encode_error(fin.rid, str(e)))
            return
        sent = self._streamed.pop(fin.rid, 0)
        self._push_delta(
            fin.rid,
            fin.tokens[sent:],
            done=True,
            finish_reason=fin.finish_reason,
        )

    # -- ingest --------------------------------------------------------------
    def _ingest(self, raw: bytes, backlog: "deque[Request]") -> int:
        """Decode a wire message into the backlog. A malformed request gets
        an error reply (when an id is recoverable) instead of killing the
        server; returns how many requests this message settled (0 normally,
        1 when it was rejected)."""
        try:
            backlog.append(self.decode_request(raw))
            return 0
        except Exception as e:  # noqa: BLE001 - any bad wire bytes
            rid = None
            try:
                rid = json.loads(bytes(raw).rstrip(b"\0").decode()).get("id")
            except Exception:  # noqa: BLE001 - not even JSON
                pass
            self.reply.push(self.encode_error(rid, f"bad request: {e}"))
            return 1

    def _pop_async(self):
        """Arrival future for the next request. Uses the consumer's own
        `pop_async` when present; any object with `try_pop` works."""
        pop_async = getattr(self.consumer, "pop_async", None)
        return pop_async() if pop_async is not None else pop_future(self.consumer)

    # -- serve loop -----------------------------------------------------------
    @property
    def settled(self) -> int:
        """Requests settled (replied or rejected) over this server's life."""
        return self._settled

    @property
    def idle(self) -> bool:
        """No backlogged and no actively decoding requests."""
        return not self._backlog and self.scheduler.active_count == 0

    @property
    def backlog_size(self) -> int:
        """Ingested-but-unadmitted requests (admission queue pressure)."""
        return len(self._backlog)

    def _arm(self):
        if self._pop_fut is None:
            self._pop_fut = self._pop_async()
        return self._pop_fut

    def wait_for_arrival(self, timeout: float) -> bool:
        """Park on the armed arrival future: True the instant a message is
        available (or one was already ingested), False on timeout. The
        fleet worker's idle strategy — a bounded park instead of a spin, so
        a terminate is still observed promptly."""
        return self._arm().wait(timeout)

    def tick(self) -> List[FinishedRequest]:
        """One serve-loop iteration: ingest completed arrivals, admit into
        free slots, advance decode one scheduler step, stream deltas, reply
        for completions. Returns the requests that finished decoding this
        tick (error-settled requests bump `settled` but are not listed)."""
        backlog = self._backlog
        pop_fut = self._arm()
        # ingest every request whose arrival future completed, up to one
        # batch ahead (each completed pop re-arms the next one)
        # backlog-space check FIRST: done() polls the ring and would
        # consume a message this loop has no room to keep
        while len(backlog) < self.scheduler.max_batch and pop_fut.done():
            self._settled += self._ingest(pop_fut.result(), backlog)
            self._pop_fut = pop_fut = self._pop_async()
        # admit into every free slot; the rest stays backlogged
        while backlog:
            try:
                if not self.scheduler.try_admit(backlog[0]):
                    break  # table full; keep backlogged
                backlog.popleft()
            except ValueError as e:  # unservable (too long, dup id, ...)
                bad = backlog.popleft()
                self.reply.push(self.encode_error(bad.rid, str(e)))
                self._settled += 1
        finished = self.scheduler.step()
        if self.stream_interval is not None and self.scheduler.active_count:
            self._ticks_since_stream += 1
            if self._ticks_since_stream >= self.stream_interval:
                self._ticks_since_stream = 0
                self._stream_deltas()
        for fin in finished:
            self._reply_finished(fin)
            self._settled += 1
        return finished

    def serve(self, n_requests: int) -> int:
        """Serve until `n_requests` (further) requests are settled (replied,
        or rejected with an error reply). Returns the number of scheduler
        ticks spent."""
        target = self._settled + n_requests
        while self._settled < target:
            finished = self.tick()
            if self._settled < target and not finished and self.idle:
                # fully idle: park on the arrival future instead of spinning
                # (the old blocking-pop path crashed decoding the timeout
                # sentinel). The Future resolves the instant a message
                # lands; a False return therefore means idle_timeout passed
                # with no traffic at all — surface that instead of hanging.
                if not self.wait_for_arrival(self.idle_timeout):
                    raise FutureTimeoutError(
                        f"serve(): no request arrived within {self.idle_timeout}s "
                        f"while {target - self._settled} request(s) still awaited"
                    )
        return self.scheduler.ticks
