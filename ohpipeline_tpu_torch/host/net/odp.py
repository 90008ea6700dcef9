"""ODP — the JSON-over-TCP control plane.

Parity target: OpenHome/Net/Odp/ (Odp.h:12-40 message schema:
announcement / action invocation / subscribe / notify; DviServerOdp.h:68
device-side server; CpDeviceOdp client).  Messages are newline-delimited
JSON objects with a `type` field, as the reference's schema:

  -> {"type":"announcement","protocolVersion":1,"devices":[...]}
  <- {"type":"action","id":N,"device":..,"service":..,"action":..,
      "arguments":[{"name":..,"value":..},...]}
  -> {"type":"actionResponse","id":N,"arguments":[...]} | error
  <- {"type":"subscribe","device":..,"service":..,"sid":..}
  -> {"type":"notify","sid":..,"properties":[{"name":..,"value":..}]}
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Any, Callable, Optional

PROTOCOL_VERSION = 1


class OdpError(RuntimeError):
    """Action failure with a protocol error code (the reference's
    DviOdp relays the provider's invocation error code/description,
    e.g. ProviderVolume's 811 'Volume invalid' / 814 'Volume not
    supported', Av/ProviderVolume.cpp:18-28).  Raised by providers to
    set the wire code, and by OdpClient when an action returns an
    error response."""

    def __init__(self, code: int, description: str):
        super().__init__(description)
        self.code = code
        self.description = description


class OdpService:
    """One service: named actions + evented properties."""

    def __init__(self, name: str):
        self.name = name
        self._actions: dict[str, Callable[..., dict]] = {}
        self._properties: dict[str, Any] = {}
        self._subscribers: list[Callable[[str, dict], None]] = []
        self._lock = threading.Lock()

    def add_action(self, name: str, fn: Callable[..., dict]) -> None:
        """fn(**arguments) -> dict of out-arguments."""
        self._actions[name] = fn

    def invoke(self, action: str, arguments: dict) -> dict:
        fn = self._actions.get(action)
        if fn is None:
            raise KeyError(f"unknown action {self.name}.{action}")
        return fn(**arguments) or {}

    def set_property(self, name: str, value: Any) -> None:
        with self._lock:
            if self._properties.get(name) == value:
                return
            self._properties[name] = value
            subs = list(self._subscribers)
        for cb in subs:
            cb(self.name, {name: value})

    def properties(self) -> dict:
        with self._lock:
            return dict(self._properties)

    def _subscribe(self, cb: Callable[[str, dict], None]) -> None:
        self._subscribers.append(cb)

    def _unsubscribe(self, cb) -> None:
        if cb in self._subscribers:
            self._subscribers.remove(cb)


class OdpDevice:
    def __init__(self, udn: str, friendly_name: str, device_type: str = "av"):
        self.udn = udn
        self.friendly_name = friendly_name
        self.device_type = device_type
        self.services: dict[str, OdpService] = {}

    def add_service(self, service: OdpService) -> None:
        self.services[service.name] = service

    def describe(self) -> dict:
        return {"id": self.udn, "alias": self.friendly_name,
                "type": self.device_type,
                "services": sorted(self.services)}


class OdpServer:
    """Device-side ODP server (DviServerOdp.h:68)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._devices: dict[str, OdpDevice] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(8)
        self._running = True
        self._threads: list[threading.Thread] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="OdpServer")
        self._accept.start()

    @property
    def port(self) -> int:
        return self._srv.getsockname()[1]

    def add_device(self, device: OdpDevice) -> None:
        self._devices[device.udn] = device

    def close(self) -> None:
        self._running = False
        self._srv.close()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break
            t = threading.Thread(target=self._session, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _session(self, conn: socket.socket) -> None:
        f = conn.makefile("rwb")
        wlock = threading.Lock()

        def send(obj: dict) -> None:
            with wlock:
                try:
                    f.write(json.dumps(obj).encode() + b"\n")
                    f.flush()
                except (OSError, ValueError):
                    pass

        send({"type": "announcement",
              "protocolVersion": PROTOCOL_VERSION,
              "devices": [d.describe() for d in self._devices.values()]})
        subs: dict[str, tuple[OdpService, Callable]] = {}
        try:
            for line in f:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                mtype = msg.get("type")
                if mtype == "action":
                    self._handle_action(msg, send)
                elif mtype == "subscribe":
                    self._handle_subscribe(msg, send, subs)
                elif mtype == "unsubscribe":
                    sid = msg.get("sid")
                    if sid in subs:
                        svc, cb = subs.pop(sid)
                        svc._unsubscribe(cb)
        finally:
            for svc, cb in subs.values():
                svc._unsubscribe(cb)
            conn.close()

    def _find_service(self, msg: dict) -> Optional[OdpService]:
        dev = self._devices.get(msg.get("device")) \
            or next(iter(self._devices.values()), None)
        if dev is None:
            return None
        return dev.services.get(msg.get("service"))

    def _handle_action(self, msg: dict, send) -> None:
        mid = msg.get("id")
        svc = self._find_service(msg)
        if svc is None:
            send({"type": "error", "id": mid, "code": 501,
                  "description": "unknown service"})
            return
        args = {a["name"]: a["value"] for a in msg.get("arguments", [])}
        try:
            out = svc.invoke(msg.get("action", ""), args)
        except OdpError as e:
            send({"type": "error", "id": mid, "code": e.code,
                  "description": e.description})
            return
        except KeyError as e:
            send({"type": "error", "id": mid, "code": 501,
                  "description": str(e)})
            return
        except Exception as e:                         # noqa: BLE001
            send({"type": "error", "id": mid, "code": 500,
                  "description": f"{type(e).__name__}: {e}"})
            return
        send({"type": "actionResponse", "id": mid,
              "arguments": [{"name": k, "value": v}
                            for k, v in out.items()]})

    def _handle_subscribe(self, msg: dict, send, subs) -> None:
        svc = self._find_service(msg)
        sid = msg.get("sid") or f"sub{len(subs)}"
        if svc is None:
            send({"type": "error", "sid": sid, "code": 501,
                  "description": "unknown service"})
            return

        def notify(service_name: str, props: dict) -> None:
            send({"type": "notify", "sid": sid,
                  "properties": [{"name": k, "value": v}
                                 for k, v in props.items()]})

        svc._subscribe(notify)
        subs[sid] = (svc, notify)
        send({"type": "subscribeResponse", "sid": sid})
        notify(svc.name, svc.properties())   # initial state


class OdpClient:
    """Control-point client (CpDeviceOdp equivalent)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self._sock.makefile("rwb")
        self._next_id = 1
        self._lock = threading.Lock()
        self._responses: dict[int, dict] = {}
        self._response_cv = threading.Condition(self._lock)
        self.notifications: list[dict] = []
        self.devices: list[dict] = []
        self._announced = threading.Event()
        self._running = True
        self._rx = threading.Thread(target=self._rx_loop, daemon=True,
                                    name="OdpClient")
        self._rx.start()
        self._announced.wait(timeout)

    def _rx_loop(self) -> None:
        try:
            for line in self._f:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                t = msg.get("type")
                if t == "announcement":
                    self.devices = msg.get("devices", [])
                    self._announced.set()
                elif t in ("actionResponse", "error") and "id" in msg:
                    with self._response_cv:
                        self._responses[msg["id"]] = msg
                        self._response_cv.notify_all()
                elif t == "notify":
                    with self._lock:
                        self.notifications.append(msg)
                elif t == "subscribeResponse":
                    with self._response_cv:
                        self._responses[msg.get("sid")] = msg
                        self._response_cv.notify_all()
        except (OSError, ValueError):
            pass

    def _send(self, obj: dict) -> None:
        self._f.write(json.dumps(obj).encode() + b"\n")
        self._f.flush()

    def invoke(self, service: str, action: str, device: str = "",
               timeout: float = 5.0, **arguments) -> dict:
        with self._lock:
            mid = self._next_id
            self._next_id += 1
        self._send({"type": "action", "id": mid, "device": device,
                    "service": service, "action": action,
                    "arguments": [{"name": k, "value": v}
                                  for k, v in arguments.items()]})
        with self._response_cv:
            ok = self._response_cv.wait_for(lambda: mid in self._responses,
                                            timeout)
            if not ok:
                raise TimeoutError(f"{service}.{action}")
            resp = self._responses.pop(mid)
        if resp["type"] == "error":
            raise OdpError(int(resp.get("code", 500)),
                           resp.get("description", "odp error"))
        return {a["name"]: a["value"] for a in resp.get("arguments", [])}

    def subscribe(self, service: str, sid: str = "", device: str = "",
                  timeout: float = 5.0) -> str:
        sid = sid or f"s{self._next_id}"
        self._send({"type": "subscribe", "device": device,
                    "service": service, "sid": sid})
        with self._response_cv:
            self._response_cv.wait_for(lambda: sid in self._responses,
                                       timeout)
            self._responses.pop(sid, None)
        return sid

    def close(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass
