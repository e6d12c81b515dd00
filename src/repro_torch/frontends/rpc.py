"""RPC frontend (paper §4.3): registration, listening, and execution of
remote procedure calls.

Crucial for initial coordination among instances — topology exchange,
channel-creation bootstrap, task coordination — especially when instances
are created at runtime. Functions are pre-registered on the receiving
instance; the receiver enters a listening state; the caller launches a
request; an optional return value is automatically routed back.

Built on the InstanceManager's message path only.
"""
from __future__ import annotations

import itertools
import json
import threading
from typing import Any, Callable, Dict, Optional

from repro_torch.core.definitions import RemoteCallError
from repro_torch.core.events import Future
from repro_torch.core.managers import InstanceManager
from repro_torch.core.stateful import Instance

_call_counter = itertools.count(1)
_call_lock = threading.Lock()


class RPCEngine:
    def __init__(self, instance_manager: InstanceManager):
        self.im = instance_manager
        self._functions: Dict[str, Callable[..., Any]] = {}
        self._buffered: list[dict] = []
        self._me = self.im.get_current_instance().instance_id

    # -- registration ----------------------------------------------------------
    def register(self, name: str, fn: Callable[..., Any]) -> None:
        if name in self._functions:
            raise ValueError(f"RPC {name!r} already registered")
        self._functions[name] = fn

    # -- caller side --------------------------------------------------------------
    def call_async(self, target: Instance, name: str, *args, **kwargs) -> Future:
        """Launch an RPC and return its reply Future: `result()` yields the
        remote return value, or raises `RemoteCallError` with the remote
        error's repr. Completion is discovered by draining this engine's
        message path, so several in-flight calls multiplex on one receiver
        (combine with `wait_any`/`wait_all`)."""
        with _call_lock:
            call_id = f"{self._me}:{next(_call_counter)}"
        req = {
            "kind": "rpc-req",
            "id": call_id,
            "name": name,
            "args": args,
            "kwargs": kwargs,
            "reply_to": self._me,
        }
        self.im.send_message(target, json.dumps(req).encode())
        fut = Future(name=f"rpc:{name}->{target.instance_id}")

        def poll() -> bool:
            reply = self._poll_for(
                lambda m: m.get("kind") == "rpc-rep" and m.get("id") == call_id
            )
            if reply is None:
                return False
            if reply.get("error"):
                fut.set_exception(
                    RemoteCallError(f"remote RPC {name} failed: {reply['error']}")
                )
            else:
                fut.set_result(reply.get("result"))
            return True

        fut.set_poll(poll)
        return fut

    def call(self, target: Instance, name: str, *args, timeout: float = 30.0, **kwargs) -> Any:
        """Blocking shim over `call_async`."""
        fut = self.call_async(target, name, *args, **kwargs)
        if not fut.wait(timeout):
            raise TimeoutError(f"RPC {name} to {target.instance_id} timed out")
        return fut.result()

    def notify(self, target: Instance, name: str, *args, **kwargs) -> None:
        """Fire-and-forget variant (no return value routing)."""
        req = {
            "kind": "rpc-req",
            "id": None,
            "name": name,
            "args": args,
            "kwargs": kwargs,
            "reply_to": None,
        }
        self.im.send_message(target, json.dumps(req).encode())

    # -- receiver side ---------------------------------------------------------------
    def listen(self, *, timeout: float = 30.0) -> bool:
        """Serve exactly one incoming request. Returns False on timeout."""
        msg = self._wait_for(lambda m: m.get("kind") == "rpc-req", timeout)
        if msg is None:
            return False
        self._execute(msg)
        return True

    def listen_loop(self, stop: threading.Event, *, poll: float = 0.05) -> None:
        while not stop.is_set():
            msg = self._wait_for(lambda m: m.get("kind") == "rpc-req", poll)
            if msg is not None:
                self._execute(msg)

    # -- internals ----------------------------------------------------------------------
    def _execute(self, msg: dict) -> None:
        name = msg["name"]
        fn = self._functions.get(name)
        result, error = None, None
        if fn is None:
            error = f"no RPC named {name!r} registered"
        else:
            try:
                result = fn(*msg.get("args", ()), **msg.get("kwargs", {}))
            except BaseException as e:  # noqa: BLE001
                error = repr(e)
        if msg.get("reply_to") is not None:
            target = self._instance_by_id(msg["reply_to"])
            rep = {"kind": "rpc-rep", "id": msg["id"], "result": result, "error": error}
            self.im.send_message(target, json.dumps(rep).encode())

    def _instance_by_id(self, instance_id: str) -> Instance:
        for inst in self.im.get_instances():
            if inst.instance_id == instance_id:
                return inst
        raise LookupError(instance_id)

    def _poll_for(self, predicate) -> Optional[dict]:
        """Nonblocking scan: buffered messages first, then drain whatever the
        message path already holds. Returns None when no match is available
        right now (unmatched messages stay buffered for other waiters)."""
        for i, m in enumerate(self._buffered):
            if predicate(m):
                return self._buffered.pop(i)
        while True:
            blob = self.im.recv_message(timeout=0.001)
            if blob is None:
                return None
            msg = json.loads(blob.decode())
            if predicate(msg):
                return msg
            self._buffered.append(msg)

    def _wait_for(self, predicate, timeout: float) -> Optional[dict]:
        import time

        deadline = time.monotonic() + timeout
        while True:
            msg = self._poll_for(predicate)
            if msg is not None:
                return msg
            if time.monotonic() >= deadline:
                return None
            time.sleep(0)
