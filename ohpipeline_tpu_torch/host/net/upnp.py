"""Minimal UPnP device stack: SSDP discovery, SOAP control, GENA eventing.

The reference consumes ohNet's full UPnP stack (DvDeviceStandard +
generated providers, SURVEY.md layer 0/6); this module provides the
TPU build's native equivalent for the renderer's primary control plane:

* `SsdpResponder` — answers M-SEARCH and emits NOTIFY alive/byebye
  (ssdp:discover over UDP 239.255.255.250:1900; unicast replies).
* `UpnpDevice` — HTTP server publishing the device description, service
  SCPDs, SOAP control endpoints and GENA event subscriptions.
* `make_av_renderer` — a MediaRenderer:1 with AVTransport:1,
  RenderingControl:1 and ConnectionManager:1 mapped onto the pipeline
  manager + volume manager, with LastChange eventing (parity:
  Av/UpnpAv/ProviderAvTransport.cpp, ProviderRenderingControl.cpp).
"""

from __future__ import annotations

import socket
import struct
import threading
import urllib.parse
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

SSDP_ADDR = "239.255.255.250"
SSDP_PORT = 1900


class UpnpError(Exception):
    def __init__(self, code: int, description: str):
        super().__init__(description)
        self.code = code
        self.description = description


class Action:
    def __init__(self, name: str, handler: Callable[[dict], dict],
                 in_args=(), out_args=()):
        self.name = name
        self.handler = handler
        self.in_args = in_args
        self.out_args = out_args


class Service:
    """One UPnP service: actions + evented state variables."""

    def __init__(self, service_type: str, service_id: str, path: str):
        self.service_type = service_type
        self.service_id = service_id
        self.path = path             # e.g. "AVTransport"
        self.actions: dict[str, Action] = {}
        self.state: dict[str, str] = {}
        self._subs: dict[str, tuple[str, int]] = {}  # sid -> (url, seq)
        self._lock = threading.Lock()

    def add_action(self, name: str, handler, in_args=(), out_args=()):
        self.actions[name] = Action(name, handler, in_args, out_args)

    # -- eventing ----------------------------------------------------------
    def set_state(self, name: str, value: str, notify: bool = True):
        self.state[name] = value
        if notify:
            self._notify({name: value})

    def subscribe(self, callback_url: str) -> str:
        sid = f"uuid:{uuid.uuid4()}"
        with self._lock:
            self._subs[sid] = (callback_url, 0)
        # initial NOTIFY with full state (GENA requirement)
        self._send_notify(callback_url, sid, 0, dict(self.state))
        with self._lock:
            if sid in self._subs:
                self._subs[sid] = (callback_url, 1)
        return sid

    def unsubscribe(self, sid: str) -> bool:
        with self._lock:
            return self._subs.pop(sid, None) is not None

    def _notify(self, changed: dict) -> None:
        with self._lock:
            subs = list(self._subs.items())
        for sid, (url, seq) in subs:
            ok = self._send_notify(url, sid, seq, changed)
            with self._lock:
                if sid in self._subs:
                    if ok:
                        self._subs[sid] = (url, seq + 1)
                    else:
                        del self._subs[sid]    # dead subscriber

    @staticmethod
    def _send_notify(url: str, sid: str, seq: int, props: dict) -> bool:
        body = ['<?xml version="1.0"?>',
                '<e:propertyset xmlns:e='
                '"urn:schemas-upnp-org:event-1-0">']
        for k, v in props.items():
            body.append(f"<e:property><{k}>{escape(str(v))}</{k}>"
                        f"</e:property>")
        body.append("</e:propertyset>")
        data = "".join(body).encode()
        req = urllib.request.Request(url, data=data, method="NOTIFY")
        req.add_header("Content-Type", 'text/xml; charset="utf-8"')
        req.add_header("NT", "upnp:event")
        req.add_header("NTS", "upnp:propchange")
        req.add_header("SID", sid)
        req.add_header("SEQ", str(seq))
        try:
            with urllib.request.urlopen(req, timeout=5):
                return True
        except OSError:
            return False

    # -- SCPD ---------------------------------------------------------------
    def scpd_xml(self) -> str:
        acts = []
        for a in self.actions.values():
            args = []
            for n in a.in_args:
                args.append(f"<argument><name>{n}</name>"
                            f"<direction>in</direction>"
                            f"<relatedStateVariable>{n}"
                            f"</relatedStateVariable></argument>")
            for n in a.out_args:
                args.append(f"<argument><name>{n}</name>"
                            f"<direction>out</direction>"
                            f"<relatedStateVariable>{n}"
                            f"</relatedStateVariable></argument>")
            acts.append(f"<action><name>{a.name}</name>"
                        f"<argumentList>{''.join(args)}</argumentList>"
                        f"</action>")
        return ('<?xml version="1.0"?>'
                '<scpd xmlns="urn:schemas-upnp-org:service-1-0">'
                '<specVersion><major>1</major><minor>0</minor>'
                '</specVersion>'
                f"<actionList>{''.join(acts)}</actionList>"
                '<serviceStateTable/></scpd>')


class UpnpDevice:
    """HTTP side of a UPnP device (description + control + eventing)."""

    def __init__(self, friendly_name: str,
                 device_type: str = "urn:schemas-upnp-org:device:"
                                    "MediaRenderer:1",
                 udn: Optional[str] = None, port: int = 0,
                 host: str = "127.0.0.1"):
        self.friendly_name = friendly_name
        self.device_type = device_type
        self.udn = udn or f"uuid:{uuid.uuid4()}"
        self.services: dict[str, Service] = {}
        device = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _reply(self, code, body: bytes,
                       ctype='text/xml; charset="utf-8"', extra=None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                device._handle_get(self)

            def do_POST(self):
                device._handle_post(self)

            def do_SUBSCRIBE(self):
                device._handle_subscribe(self)

            def do_UNSUBSCRIBE(self):
                device._handle_unsubscribe(self)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="UpnpDevice")
        self._ssdp: Optional[SsdpResponder] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self, ssdp: bool = False) -> None:
        self._thread.start()
        if ssdp:
            self._ssdp = SsdpResponder(self)
            self._ssdp.start()

    def close(self) -> None:
        if self._ssdp:
            self._ssdp.close()
        self._server.shutdown()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def location(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/description.xml"

    def add_service(self, svc: Service) -> None:
        self.services[svc.path] = svc

    # -- description ----------------------------------------------------------
    def description_xml(self) -> str:
        svcs = []
        for svc in self.services.values():
            svcs.append(
                f"<service><serviceType>{svc.service_type}</serviceType>"
                f"<serviceId>{svc.service_id}</serviceId>"
                f"<SCPDURL>/{svc.path}/scpd.xml</SCPDURL>"
                f"<controlURL>/{svc.path}/control</controlURL>"
                f"<eventSubURL>/{svc.path}/event</eventSubURL></service>")
        return ('<?xml version="1.0"?>'
                '<root xmlns="urn:schemas-upnp-org:device-1-0">'
                '<specVersion><major>1</major><minor>0</minor>'
                '</specVersion><device>'
                f"<deviceType>{self.device_type}</deviceType>"
                f"<friendlyName>{escape(self.friendly_name)}"
                f"</friendlyName>"
                '<manufacturer>ohpipeline_tpu</manufacturer>'
                '<modelName>TPU Renderer</modelName>'
                f"<UDN>{self.udn}</UDN>"
                f"<serviceList>{''.join(svcs)}</serviceList>"
                '</device></root>')

    # -- HTTP handlers ---------------------------------------------------------
    def _handle_get(self, h) -> None:
        path = h.path.split("?")[0]
        if path == "/description.xml":
            h._reply(200, self.description_xml().encode())
            return
        parts = [p for p in path.split("/") if p]
        if len(parts) == 2 and parts[1] == "scpd.xml":
            svc = self.services.get(parts[0])
            if svc:
                h._reply(200, svc.scpd_xml().encode())
                return
        h._reply(404, b"")

    def _handle_post(self, h) -> None:
        parts = [p for p in h.path.split("/") if p]
        svc = self.services.get(parts[0]) if parts else None
        if svc is None or (len(parts) < 2 or parts[1] != "control"):
            h._reply(404, b"")
            return
        length = int(h.headers.get("Content-Length", 0))
        body = h.rfile.read(length)
        try:
            env = ET.fromstring(body)
        except ET.ParseError:
            h._reply(400, b"")
            return
        ns = "{http://schemas.xmlsoap.org/soap/envelope/}"
        action_el = None
        for el in env.iter():
            tag = el.tag
            if tag.startswith("{") and svc.service_type in tag:
                action_el = el
                break
        if action_el is None:
            body_el = env.find(f"{ns}Body")
            if body_el is not None and len(body_el):
                action_el = body_el[0]
        if action_el is None:
            h._reply(400, b"")
            return
        name = action_el.tag.split("}")[-1]
        action = svc.actions.get(name)
        if action is None:
            self._soap_fault(h, 401, "Invalid Action")
            return
        args = {c.tag.split("}")[-1]: (c.text or "") for c in action_el}
        try:
            out = action.handler(args) or {}
        except UpnpError as e:
            self._soap_fault(h, e.code, e.description)
            return
        except Exception as e:   # noqa: BLE001 - SOAP must answer
            self._soap_fault(h, 501, f"Action Failed: {e}")
            return
        st = svc.service_type
        outxml = "".join(f"<{k}>{escape(str(v))}</{k}>"
                         for k, v in out.items())
        resp = ('<?xml version="1.0"?>'
                '<s:Envelope xmlns:s='
                '"http://schemas.xmlsoap.org/soap/envelope/" '
                's:encodingStyle='
                '"http://schemas.xmlsoap.org/soap/encoding/">'
                f'<s:Body><u:{name}Response xmlns:u="{st}">{outxml}'
                f'</u:{name}Response></s:Body></s:Envelope>')
        h._reply(200, resp.encode())

    @staticmethod
    def _soap_fault(h, code: int, desc: str) -> None:
        body = ('<?xml version="1.0"?>'
                '<s:Envelope xmlns:s='
                '"http://schemas.xmlsoap.org/soap/envelope/">'
                '<s:Body><s:Fault>'
                '<faultcode>s:Client</faultcode>'
                '<faultstring>UPnPError</faultstring><detail>'
                '<UPnPError xmlns="urn:schemas-upnp-org:control-1-0">'
                f"<errorCode>{code}</errorCode>"
                f"<errorDescription>{escape(desc)}</errorDescription>"
                '</UPnPError></detail></s:Fault></s:Body></s:Envelope>')
        h._reply(500, body.encode())

    def _handle_subscribe(self, h) -> None:
        parts = [p for p in h.path.split("/") if p]
        svc = self.services.get(parts[0]) if parts else None
        if svc is None or len(parts) < 2 or parts[1] != "event":
            h._reply(404, b"")
            return
        callback = h.headers.get("Callback", "")
        sid_hdr = h.headers.get("SID")
        if sid_hdr:                 # renewal
            h._reply(200, b"", ctype="text/plain",
                     extra={"SID": sid_hdr, "TIMEOUT": "Second-1800"})
            return
        url = callback.strip("<>")
        if not url:
            h._reply(412, b"")
            return
        sid = svc.subscribe(url)
        h._reply(200, b"", ctype="text/plain",
                 extra={"SID": sid, "TIMEOUT": "Second-1800"})

    def _handle_unsubscribe(self, h) -> None:
        parts = [p for p in h.path.split("/") if p]
        svc = self.services.get(parts[0]) if parts else None
        sid = h.headers.get("SID", "")
        if svc and svc.unsubscribe(sid):
            h._reply(200, b"", ctype="text/plain")
        else:
            h._reply(412, b"")


class SsdpResponder(threading.Thread):
    """Answers ssdp:discover M-SEARCH for the device and its services and
    sends NOTIFY alive on start / byebye on close."""

    def __init__(self, device: UpnpDevice, bind: str = "0.0.0.0",
                 port: int = SSDP_PORT):
        super().__init__(daemon=True, name="SsdpResponder")
        self.device = device
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind, port))
        try:
            mreq = struct.pack("4s4s", socket.inet_aton(SSDP_ADDR),
                               socket.inet_aton("0.0.0.0"))
            self._sock.setsockopt(socket.IPPROTO_IP,
                                  socket.IP_ADD_MEMBERSHIP, mreq)
        except OSError:
            pass                    # loopback-only environments
        self._sock.settimeout(0.5)
        self._quit = False
        #: most recent M-SEARCH searchers [(addr, monotonic_s)], newest
        #: kept per address, capped at 10 (ProviderDebug.cpp
        #: MSearchObserver::kMaxAddresses)
        self._recent_msearch: list = []
        self._msearch_lock = threading.Lock()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def targets(self) -> list[str]:
        out = ["upnp:rootdevice", self.device.udn, self.device.device_type]
        out += [s.service_type for s in self.device.services.values()]
        return out

    def run(self) -> None:
        self.notify_alive()
        while not self._quit:
            try:
                data, addr = self._sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            self._handle(data, addr)

    def _handle(self, data: bytes, addr) -> None:
        try:
            text = data.decode("utf-8", "replace")
        except Exception:   # noqa: BLE001
            return
        if not text.startswith("M-SEARCH"):
            return
        self._record_msearch(addr)
        st = ""
        for line in text.split("\r\n"):
            if line.lower().startswith("st:"):
                st = line[3:].strip()
        matches = (st == "ssdp:all" or st in self.targets())
        if not matches:
            return
        for target in ([st] if st != "ssdp:all" else self.targets()):
            usn = self.device.udn if target == self.device.udn \
                else f"{self.device.udn}::{target}"
            resp = ("HTTP/1.1 200 OK\r\n"
                    "CACHE-CONTROL: max-age=1800\r\nEXT:\r\n"
                    f"LOCATION: {self.device.location}\r\n"
                    "SERVER: ohpipeline_tpu UPnP/1.0\r\n"
                    f"ST: {target}\r\nUSN: {usn}\r\n\r\n")
            try:
                self._sock.sendto(resp.encode(), addr)
            except OSError:
                pass

    def _record_msearch(self, addr) -> None:
        import time as _time
        now = _time.monotonic()
        with self._msearch_lock:
            for ent in self._recent_msearch:
                if ent[0] == addr[0]:
                    ent[1] = now
                    return
            if len(self._recent_msearch) >= 10:
                oldest = min(range(len(self._recent_msearch)),
                             key=lambda i: self._recent_msearch[i][1])
                self._recent_msearch.pop(oldest)
            self._recent_msearch.append([addr[0], now])

    def recent_msearches(self) -> list:
        """[(address, seconds_ago)] of the last distinct searchers
        (ProviderDebug GetRecentMSearches)."""
        import time as _time
        now = _time.monotonic()
        with self._msearch_lock:
            return [(a, round(now - t, 1))
                    for a, t in self._recent_msearch]

    def _notify(self, nts: str) -> None:
        for target in self.targets():
            usn = self.device.udn if target == self.device.udn \
                else f"{self.device.udn}::{target}"
            msg = ("NOTIFY * HTTP/1.1\r\n"
                   f"HOST: {SSDP_ADDR}:{SSDP_PORT}\r\n"
                   "CACHE-CONTROL: max-age=1800\r\n"
                   f"LOCATION: {self.device.location}\r\n"
                   f"NT: {target}\r\nNTS: {nts}\r\n"
                   f"USN: {usn}\r\n\r\n")
            try:
                self._sock.sendto(msg.encode(), (SSDP_ADDR, SSDP_PORT))
            except OSError:
                pass

    def notify_alive(self) -> None:
        self._notify("ssdp:alive")

    def close(self) -> None:
        self._notify("ssdp:byebye")
        self._quit = True
        try:
            self._sock.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# MediaRenderer services over the pipeline (Av/UpnpAv providers)
# ---------------------------------------------------------------------------

_AVT_NS = "urn:schemas-upnp-org:metadata-1-0/AVT/"
_RCS_NS = "urn:schemas-upnp-org:metadata-1-0/RCS/"


def _last_change(ns: str, props: dict) -> str:
    inner = "".join(f'<{k} val="{escape(str(v))}"/>'
                    for k, v in props.items())
    return (f'<Event xmlns="{ns}"><InstanceID val="0">{inner}'
            f"</InstanceID></Event>")


def make_av_renderer(pipeline_manager, volume_manager=None,
                     friendly_name: str = "ohpipeline TPU renderer",
                     upnp_av_source=None, port: int = 0,
                     host: str = "127.0.0.1") -> UpnpDevice:
    """Build a MediaRenderer:1 over the pipeline/volume managers
    (reference ProviderAvTransport/RenderingControl/ConnectionManager)."""
    pm = pipeline_manager
    dev = UpnpDevice(friendly_name, port=port, host=host)

    avt = Service("urn:schemas-upnp-org:service:AVTransport:1",
                  "urn:upnp-org:serviceId:AVTransport", "AVTransport")
    state = {"uri": "", "metadata": "", "transport": "STOPPED",
             "seconds": 0}

    def _avt_event(**props):
        avt.set_state("LastChange", _last_change(_AVT_NS, props))

    def set_uri(args):
        state["uri"] = args.get("CurrentURI", "")
        state["metadata"] = args.get("CurrentURIMetaData", "")
        if upnp_av_source is not None:
            upnp_av_source.set_uri(state["uri"], state["metadata"])
        _avt_event(AVTransportURI=state["uri"],
                   CurrentTrackMetaData=state["metadata"])
        return {}

    def play(args):
        if not state["uri"]:
            raise UpnpError(716, "Resource not found")
        if upnp_av_source is not None:
            upnp_av_source.play()
        else:
            pm.play_uri(state["uri"], state["metadata"])
        state["transport"] = "PLAYING"
        _avt_event(TransportState="PLAYING")
        return {}

    def pause(args):
        pm.pause()
        state["transport"] = "PAUSED_PLAYBACK"
        _avt_event(TransportState="PAUSED_PLAYBACK")
        return {}

    def stop(args):
        pm.stop()
        state["transport"] = "STOPPED"
        _avt_event(TransportState="STOPPED")
        return {}

    def nxt(args):
        pm.next()
        return {}

    def prev(args):
        pm.prev()
        return {}

    def get_transport_info(args):
        return {"CurrentTransportState": state["transport"],
                "CurrentTransportStatus": "OK",
                "CurrentSpeed": "1"}

    def get_position_info(args):
        s = int(state["seconds"])
        rel = f"{s // 3600}:{s // 60 % 60:02d}:{s % 60:02d}"
        return {"Track": "1", "TrackDuration": "0:00:00",
                "TrackMetaData": state["metadata"],
                "TrackURI": state["uri"], "RelTime": rel,
                "AbsTime": rel, "RelCount": str(s), "AbsCount": str(s)}

    def get_media_info(args):
        return {"NrTracks": "1" if state["uri"] else "0",
                "MediaDuration": "0:00:00",
                "CurrentURI": state["uri"],
                "CurrentURIMetaData": state["metadata"],
                "NextURI": "", "NextURIMetaData": "",
                "PlayMedium": "NETWORK", "RecordMedium": "NOT_IMPLEMENTED",
                "WriteStatus": "NOT_IMPLEMENTED"}

    def seek(args):
        target = args.get("Target", "0:00:00")
        try:
            hh, mm, ss = (int(x) for x in target.split(":"))
            seconds = hh * 3600 + mm * 60 + ss
        except ValueError:
            raise UpnpError(711, "Illegal seek target")
        pm.seek(0, float(seconds), 44100)
        return {}

    avt.add_action("SetAVTransportURI", set_uri,
                   ("InstanceID", "CurrentURI", "CurrentURIMetaData"))
    avt.add_action("Play", play, ("InstanceID", "Speed"))
    avt.add_action("Pause", pause, ("InstanceID",))
    avt.add_action("Stop", stop, ("InstanceID",))
    avt.add_action("Next", nxt, ("InstanceID",))
    avt.add_action("Previous", prev, ("InstanceID",))
    avt.add_action("Seek", seek, ("InstanceID", "Unit", "Target"))
    avt.add_action("GetTransportInfo", get_transport_info, ("InstanceID",),
                   ("CurrentTransportState", "CurrentTransportStatus",
                    "CurrentSpeed"))
    avt.add_action("GetPositionInfo", get_position_info, ("InstanceID",),
                   ("Track", "TrackDuration", "TrackMetaData", "TrackURI",
                    "RelTime", "AbsTime", "RelCount", "AbsCount"))
    avt.add_action("GetMediaInfo", get_media_info, ("InstanceID",))
    avt.set_state("LastChange", _last_change(_AVT_NS,
                                             {"TransportState": "STOPPED"}),
                  notify=False)
    dev.add_service(avt)

    # observer: mirror pipeline state into AVT LastChange
    class _Obs:
        def notify_pipeline_state(self, st):
            name = {"playing": "PLAYING", "paused": "PAUSED_PLAYBACK",
                    "stopped": "STOPPED",
                    "buffering": "TRANSITIONING",
                    "waiting": "TRANSITIONING"}.get(
                        getattr(st, "value", str(st)), "STOPPED")
            state["transport"] = name
            _avt_event(TransportState=name)

        def notify_time(self, seconds, total):
            state["seconds"] = seconds

    pm.add_observer(_Obs())

    rcs = Service("urn:schemas-upnp-org:service:RenderingControl:1",
                  "urn:upnp-org:serviceId:RenderingControl",
                  "RenderingControl")

    def _rcs_event(**props):
        rcs.set_state("LastChange", _last_change(_RCS_NS, props))

    vm = volume_manager

    def set_volume(args):
        if vm is None:
            raise UpnpError(501, "no volume manager")
        from ..av.volume import VolumeNotSupported, VolumeOutOfRange
        desired = int(args.get("DesiredVolume", "0"))
        try:
            vm.set_volume(desired)
        except VolumeOutOfRange:
            # HelperSetVolume (ProviderVolume.cpp:573-585): only a
            # request beyond VolumeMax errors; an in-range request the
            # limiter pins is swallowed
            if desired > vm.profile.max_volume or desired < 0:
                raise UpnpError(811, "Volume invalid") from None
        except VolumeNotSupported:
            raise UpnpError(814, "Volume not supported") from None
        return {}

    def get_volume(args):
        return {"CurrentVolume": str(vm.volume if vm else 0)}

    def set_mute(args):
        if vm is None:
            raise UpnpError(501, "no volume manager")
        if args.get("DesiredMute") in ("1", "true", "True"):
            vm.mute()
        else:
            vm.unmute()
        return {}

    def get_mute(args):
        return {"CurrentMute": "1" if (vm and vm.muted) else "0"}

    rcs.add_action("SetVolume", set_volume,
                   ("InstanceID", "Channel", "DesiredVolume"))
    rcs.add_action("GetVolume", get_volume, ("InstanceID", "Channel"),
                   ("CurrentVolume",))
    rcs.add_action("SetMute", set_mute,
                   ("InstanceID", "Channel", "DesiredMute"))
    rcs.add_action("GetMute", get_mute, ("InstanceID", "Channel"),
                   ("CurrentMute",))
    rcs.set_state("LastChange", _last_change(_RCS_NS, {"Volume": "0"}),
                  notify=False)
    if vm is not None:
        vm.add_observer(lambda v: _rcs_event(Volume=v))
    dev.add_service(rcs)

    cm = Service("urn:schemas-upnp-org:service:ConnectionManager:1",
                 "urn:upnp-org:serviceId:ConnectionManager",
                 "ConnectionManager")
    mimes = ",".join(f"http-get:*:{m}:*" for m in (
        "audio/wav", "audio/x-flac", "audio/flac", "audio/mpeg",
        "audio/aac", "audio/mp4", "audio/ogg", "audio/opus",
        "audio/aiff", "audio/dsf"))
    cm.add_action("GetProtocolInfo",
                  lambda a: {"Source": "", "Sink": mimes}, (),
                  ("Source", "Sink"))
    cm.add_action("GetCurrentConnectionIDs",
                  lambda a: {"ConnectionIDs": "0"}, (), ("ConnectionIDs",))
    dev.add_service(cm)
    return dev


# -- tiny SOAP client (tests / control-point use) ---------------------------

def soap_call(base_url: str, service_path: str, service_type: str,
              action: str, args: Optional[dict] = None) -> dict:
    """POST one SOAP action; returns the response argument dict.
    Raises UpnpError on SOAP faults."""
    body_args = "".join(f"<{k}>{escape(str(v))}</{k}>"
                        for k, v in (args or {}).items())
    envelope = ('<?xml version="1.0"?>'
                '<s:Envelope xmlns:s='
                '"http://schemas.xmlsoap.org/soap/envelope/" '
                's:encodingStyle='
                '"http://schemas.xmlsoap.org/soap/encoding/">'
                f'<s:Body><u:{action} xmlns:u="{service_type}">'
                f"{body_args}</u:{action}></s:Body></s:Envelope>")
    req = urllib.request.Request(
        f"{base_url}/{service_path}/control", envelope.encode(),
        method="POST")
    req.add_header("Content-Type", 'text/xml; charset="utf-8"')
    req.add_header("SOAPACTION", f'"{service_type}#{action}"')
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            text = r.read()
    except urllib.error.HTTPError as e:
        detail = e.read()
        try:
            root = ET.fromstring(detail)
            code = root.findtext(".//{urn:schemas-upnp-org:control-1-0}"
                                 "errorCode") or "501"
            desc = root.findtext(".//{urn:schemas-upnp-org:control-1-0}"
                                 "errorDescription") or "fault"
        except ET.ParseError:
            code, desc = "501", "fault"
        raise UpnpError(int(code), desc)
    root = ET.fromstring(text)
    out = {}
    for el in root.iter():
        if el.tag.endswith("Response"):
            for c in el:
                out[c.tag.split("}")[-1]] = c.text or ""
    return out


def msearch(st: str = "ssdp:all", timeout: float = 1.0,
            addr: tuple = (SSDP_ADDR, SSDP_PORT)) -> list[dict]:
    """Send an M-SEARCH and collect replies (control-point side)."""
    msg = ("M-SEARCH * HTTP/1.1\r\n"
           f"HOST: {addr[0]}:{addr[1]}\r\n"
           'MAN: "ssdp:discover"\r\nMX: 1\r\n'
           f"ST: {st}\r\n\r\n")
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.settimeout(timeout)
    s.sendto(msg.encode(), addr)
    out = []
    try:
        while True:
            data, _ = s.recvfrom(8192)
            headers = {}
            for line in data.decode("utf-8", "replace").split("\r\n")[1:]:
                k, _, v = line.partition(":")
                if _:
                    headers[k.strip().upper()] = v.strip()
            out.append(headers)
    except socket.timeout:
        pass
    finally:
        s.close()
    return out


# -- openhome service family over UPnP ---------------------------------------

def _soap_value(v) -> str:
    """Provider out-arg -> SOAP string (ohNet bool wire is 1/0)."""
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (list, dict)):
        import json as _json
        return _json.dumps(v)
    return str(v)


def _soap_arg(v: str):
    """SOAP in-arg string -> the typed value the provider actions expect
    (ohNet declares typed arguments; our SOAP layer is stringly)."""
    low = v.strip().lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(v)
    except ValueError:
        return v


def bridge_odp_service(odp_svc, version: int = 1) -> Service:
    """Publish an OdpService as an av-openhome-org UPnP service: every
    ODP action becomes a SOAP action and every evented property a GENA
    state variable.  The reference publishes the same provider objects
    through ohNet's DvProvider UPnP stack (MediaPlayer.cpp provider
    registration); here one provider table serves both planes, with the
    provider error codes carried into SOAP faults."""
    from .odp import OdpError
    svc = Service(
        f"urn:av-openhome-org:service:{odp_svc.name}:{version}",
        f"urn:av-openhome-org:serviceId:{odp_svc.name}",
        f"oh{odp_svc.name}")
    for name in list(odp_svc._actions):
        def handler(args, _n=name):
            try:
                out = odp_svc.invoke(
                    _n, {k: _soap_arg(v) for k, v in args.items()})
            except OdpError as e:
                raise UpnpError(e.code, e.description) from None
            except (KeyError, IndexError, ValueError, TypeError) as e:
                raise UpnpError(402, f"Invalid Args: {e}") from None
            return {k: _soap_value(v) for k, v in (out or {}).items()}
        svc.add_action(name, handler)
    for k, v in odp_svc.properties().items():
        svc.set_state(k, _soap_value(v), notify=False)
    odp_svc._subscribe(
        lambda _n, props: [svc.set_state(k, _soap_value(v))
                           for k, v in props.items()])
    return svc


def make_openhome_device(mp, odp_device=None, friendly_name=None,
                         port: int = 0, host: str = "127.0.0.1"):
    """Publish the full openhome provider family over UPnP — the same
    surface as the ODP device (Product/Volume/Info/Transport/Playlist/
    Radio/Time/Credentials/OAuth/Config/Reaction/Debug/Pins, plus
    Receiver/Sender when present) as av-openhome-org services with SOAP
    control + GENA eventing.  Pass an existing OdpDevice to share one
    provider table between both planes (avoids double observer
    registration)."""
    if odp_device is None:
        from .providers import make_device
        odp_device = make_device(mp)
    dev = UpnpDevice(
        friendly_name or f"{mp.product.room}:{mp.product.name}",
        port=port, host=host)
    for odp_svc in odp_device.services.values():
        dev.add_service(bridge_odp_service(odp_svc))
    return dev
