"""OAuth: device-code flows and token management for streaming services.

Parity target: OpenHome/OAuth.cpp / OAuth.h:349-625 (device-code limited
input flow, TokenManager with short/long-lived token slots, refresh
scheduling, persisted refresh tokens) and Av/ProviderOAuth (the control
surface).  Network calls go through an injectable `http_post` so tests
(and this zero-egress environment) use fakes, like the reference's test
doubles.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from .config import RamStore, StoreKeyNotFound

MAX_SHORT_LIVED = 10     # TokenManager slot caps (OAuth.h)
MAX_LONG_LIVED = 5


@dataclass(slots=True)
class Token:
    token_id: str
    access_token: str = ""
    refresh_token: str = ""
    expires_at: float = 0.0
    long_lived: bool = False

    @property
    def valid(self) -> bool:
        return bool(self.access_token) and time.time() < self.expires_at


@dataclass(slots=True)
class DeviceCodeRequest:
    """State of one device-code ("limited input") authorisation flow."""
    service_id: str
    device_code: str
    user_code: str
    verification_url: str
    interval: float
    expires_at: float
    job_id: int = 0


def default_http_post(url: str, data: dict, headers: dict) -> dict:
    import urllib.parse
    import urllib.request
    req = urllib.request.Request(
        url, urllib.parse.urlencode(data).encode(),
        headers={"Content-Type": "application/x-www-form-urlencoded",
                 **headers})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


class TokenManager:
    """Per-service token slots with refresh + persistence
    (OAuth.h TokenManager)."""

    def __init__(self, service_id: str, store: RamStore,
                 refresh_fn: Callable[[str], dict],
                 max_short: int = MAX_SHORT_LIVED,
                 max_long: int = MAX_LONG_LIVED):
        self.service_id = service_id
        self._store = store
        self._refresh = refresh_fn
        self._max = {False: max_short, True: max_long}
        self._tokens: dict[str, Token] = {}
        self._lock = threading.RLock()
        self._observers: list[Callable[[], None]] = []
        self._load()

    def _key(self) -> str:
        return f"OAuth.{self.service_id}.Tokens"

    def _load(self) -> None:
        try:
            raw = json.loads(self._store.read(self._key()))
        except (StoreKeyNotFound, ValueError):
            return
        for t in raw:
            tok = Token(t["id"], refresh_token=t["refresh"],
                        long_lived=t.get("long", False))
            self._tokens[tok.token_id] = tok

    def _save(self) -> None:
        raw = [{"id": t.token_id, "refresh": t.refresh_token,
                "long": t.long_lived} for t in self._tokens.values()]
        self._store.write(self._key(), json.dumps(raw).encode())

    def add_observer(self, cb: Callable[[], None]) -> None:
        self._observers.append(cb)

    def _notify(self):
        for cb in self._observers:
            cb()

    # -- API (ProviderOAuth actions) ----------------------------------------
    def add_token(self, token_id: str, refresh_token: str,
                  long_lived: bool = False) -> None:
        with self._lock:
            count = sum(1 for t in self._tokens.values()
                        if t.long_lived == long_lived)
            if token_id not in self._tokens \
                    and count >= self._max[long_lived]:
                raise RuntimeError("token slots full")
            self._tokens[token_id] = Token(token_id,
                                           refresh_token=refresh_token,
                                           long_lived=long_lived)
            self._save()
        self._notify()

    def remove_token(self, token_id: str) -> None:
        with self._lock:
            self._tokens.pop(token_id, None)
            self._save()
        self._notify()

    def clear_all(self) -> None:
        with self._lock:
            self._tokens.clear()
            self._save()
        self._notify()

    def token_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._tokens)

    def access_token(self, token_id: str) -> Optional[str]:
        """Valid access token, refreshing through the service if stale."""
        with self._lock:
            tok = self._tokens.get(token_id)
            if tok is None:
                return None
            if tok.valid:
                return tok.access_token
            resp = self._refresh(tok.refresh_token)
            tok.access_token = resp.get("access_token", "")
            tok.expires_at = time.time() + float(resp.get("expires_in", 0))
            if resp.get("refresh_token"):
                tok.refresh_token = resp["refresh_token"]
                self._save()
            return tok.access_token or None


class OAuthDeviceFlow:
    """Device-code ("limited input") authorisation
    (OAuth.h OAuthPollingManager semantics)."""

    def __init__(self, service_id: str, auth_url: str, token_url: str,
                 client_id: str, scope: str = "",
                 http_post: Callable = default_http_post,
                 client_secret: str = ""):
        self.service_id = service_id
        self.auth_url = auth_url
        self.token_url = token_url
        self.client_id = client_id
        self.client_secret = client_secret
        self.scope = scope
        self._post = http_post

    def begin(self) -> DeviceCodeRequest:
        resp = self._post(self.auth_url,
                          {"client_id": self.client_id, "scope": self.scope},
                          {})
        return DeviceCodeRequest(
            service_id=self.service_id,
            device_code=resp["device_code"],
            user_code=resp.get("user_code", ""),
            verification_url=resp.get("verification_uri",
                                      resp.get("verification_url", "")),
            interval=float(resp.get("interval", 5)),
            expires_at=time.time() + float(resp.get("expires_in", 300)))

    def poll_once(self, req: DeviceCodeRequest) -> Optional[dict]:
        """One token poll; None while authorisation is pending."""
        if time.time() > req.expires_at:
            raise TimeoutError("device code expired")
        data = {"client_id": self.client_id,
                "device_code": req.device_code,
                "grant_type": "urn:ietf:params:oauth:grant-type:device_code"}
        if self.client_secret:
            data["client_secret"] = self.client_secret
        resp = self._post(self.token_url, data, {})
        if resp.get("error") in ("authorization_pending", "slow_down"):
            return None
        if resp.get("error"):
            raise RuntimeError(resp["error"])
        return resp

    def poll_until_authorised(self, req: DeviceCodeRequest,
                              deadline: Optional[float] = None) -> dict:
        while True:
            resp = self.poll_once(req)
            if resp is not None:
                return resp
            if deadline and time.time() > deadline:
                raise TimeoutError("authorisation timed out")
            time.sleep(req.interval)

    def refresh(self, refresh_token: str) -> dict:
        data = {"client_id": self.client_id, "refresh_token": refresh_token,
                "grant_type": "refresh_token"}
        if self.client_secret:
            data["client_secret"] = self.client_secret
        return self._post(self.token_url, data, {})


class PollingJob:
    """One limited-input-flow job (reference OAuthPollingManager job,
    OAuth.h:570-625): created by BeginLimitedInputFlow, polled on a
    worker thread, terminal status Complete/Failed."""

    def __init__(self, job_id: str, service_id: str,
                 request: DeviceCodeRequest):
        self.job_id = job_id
        self.service_id = service_id
        self.request = request
        self.status = "InProgress"


class OAuthRegistry:
    """The ProviderOAuth service registry (ProviderOAuth.cpp:292-339
    AddService + ServiceProvider list): each streaming service
    registers its TokenManager (and optionally its device-code flow);
    the provider serialises state to the GetServiceStatus /
    GetJobStatus JSON and bumps updateId/jobUpdateId on change."""

    def __init__(self):
        self._lock = threading.RLock()
        self._services: dict[str, dict] = {}
        self.update_id = 0
        self.job_update_id = 0
        self._observers: list[Callable[[], None]] = []
        self._job_observers: list[Callable[[], None]] = []
        self._job_counter = 0
        self.jobs: dict[str, PollingJob] = {}

    def add_service(self, service_id: str, tokens: TokenManager,
                    flow: Optional[OAuthDeviceFlow] = None,
                    visible: bool = True, max_jobs: int = 1) -> None:
        with self._lock:
            self._services[service_id] = {
                "tokens": tokens, "flow": flow, "visible": visible,
                "max_jobs": max_jobs}
        tokens.add_observer(self._bump)
        self._bump()

    def service_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._services)

    def service(self, service_id: str) -> Optional[dict]:
        with self._lock:
            return self._services.get(service_id)

    # -- update ids (ProviderOAuth::UpdateIdSet/JobUpdateIdSet) ---------
    def add_observer(self, cb: Callable[[], None]) -> None:
        self._observers.append(cb)

    def add_job_observer(self, cb: Callable[[], None]) -> None:
        self._job_observers.append(cb)

    def _bump(self) -> None:
        with self._lock:
            self.update_id += 1
        for cb in self._observers:
            cb()

    def _bump_jobs(self) -> None:
        with self._lock:
            self.job_update_id += 1
        for cb in self._job_observers:
            cb()

    # -- limited input flow (BeginLimitedInputFlow) ----------------------
    def running_jobs(self, service_id: str) -> int:
        with self._lock:
            return sum(1 for j in self.jobs.values()
                       if j.service_id == service_id
                       and j.status == "InProgress")

    def begin_limited_input_flow(self, service_id: str) -> PollingJob:
        """Starts the device-code flow and a poller thread that lands
        the refresh token in the service's TokenManager on success."""
        svc = self.service(service_id)
        if svc is None:
            raise KeyError(service_id)
        flow = svc["flow"]
        if flow is None:
            raise RuntimeError(f"{service_id}: no flow")
        req = flow.begin()
        with self._lock:
            self._job_counter += 1
            job = PollingJob(f"job-{self._job_counter}", service_id, req)
            self.jobs[job.job_id] = job
        self._bump_jobs()
        t = threading.Thread(target=self._poll_job, args=(job, svc),
                             daemon=True, name=f"OAuthPoll-{job.job_id}")
        t.start()
        return job

    def _poll_job(self, job: PollingJob, svc: dict) -> None:
        try:
            resp = svc["flow"].poll_until_authorised(
                job.request, deadline=job.request.expires_at)
            svc["tokens"].add_token(job.job_id,
                                    resp.get("refresh_token", ""))
            job.status = "Complete"
        except Exception:             # noqa: BLE001 — job failure state
            job.status = "Failed"
        self._bump_jobs()

    # -- status JSON (ServiceProvider::ToJson / WriteJobStatus) ----------
    def service_status(self) -> dict:
        with self._lock:
            services = []
            for sid in sorted(self._services):
                svc = self._services[sid]
                tm = svc["tokens"]
                toks = {False: [], True: []}
                for tid in tm.token_ids():
                    t = tm._tokens[tid]
                    toks[t.long_lived].append(
                        {"id": t.token_id, "isValid": t.valid,
                         "username": ""})
                services.append({
                    "id": sid, "visible": svc["visible"],
                    "shortLivedMax": tm._max[False],
                    "longLivedMax": tm._max[True],
                    "shortLivedTokens": toks[False],
                    "longLivedTokens": toks[True]})
            return {"updateId": self.update_id, "services": services}

    def job_status(self) -> dict:
        with self._lock:
            services = []
            for sid in sorted(self._services):
                svc = self._services[sid]
                jobs = [{"id": j.job_id, "status": j.status}
                        for j in self.jobs.values()
                        if j.service_id == sid]
                services.append({"id": sid,
                                 "maxRunningJobs": svc["max_jobs"],
                                 "jobs": jobs})
            return {"updateId": self.job_update_id, "services": services}
