"""Credentials: per-service username/password store, encrypted at rest.

Parity target: OpenHome/Av/Credentials.cpp — service credential slots,
RSA keypair generated from device entropy (Credentials.cpp:309-330), the
public key published so control points can send RSA-encrypted passwords,
plaintext never stored; observers notified on change; ProviderCredentials
surfaced the same API over UPnP (here: an ODP service).
"""

from __future__ import annotations

import base64
import threading
from typing import Callable, Optional

from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import padding, rsa

from .config import RamStore, StoreKeyNotFound

KEY_BITS = 2048


class CredentialsIdNotFound(KeyError):
    """Unknown service id (Credentials.h EXCEPTION CredentialsIdNotFound;
    ProviderCredentials error 800 'Id not found')."""


class CredentialsLoginFailed(Exception):
    """Login/ReLogin failed (ProviderCredentials error 801)."""


class CredentialsTooLong(ValueError):
    """Username/password beyond the storable size (Credentials.h
    EXCEPTION CredentialsTooLong; provider error 802). RSA-2048
    PKCS1v15 bounds the raw password at 245 bytes."""


class Credentials:
    """Service credential registry (ICredentials, Credentials.h:114)."""

    def __init__(self, store: RamStore):
        self._store = store
        self._lock = threading.RLock()
        self._observers: dict[str, list[Callable[[], None]]] = {}
        self._status: dict[str, str] = {}
        self._enabled: dict[str, bool] = {}
        self._consumers: dict[str, object] = {}
        self._register_observers: list[Callable[[], None]] = []
        self._key = self._load_or_create_key()

    # -- key management -----------------------------------------------------
    def _load_or_create_key(self) -> rsa.RSAPrivateKey:
        try:
            pem = self._store.read("Credentials.Key")
            return serialization.load_pem_private_key(pem, password=None)
        except (StoreKeyNotFound, ValueError):
            key = rsa.generate_private_key(public_exponent=65537,
                                           key_size=KEY_BITS)
            pem = key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption())
            self._store.write("Credentials.Key", pem)
            return key

    def public_key_pem(self) -> str:
        """Published via GetPublicKey so control points encrypt passwords
        before sending (reference ProviderCredentials)."""
        return self._key.public_key().public_bytes(
            serialization.Encoding.PEM,
            serialization.PublicFormat.SubjectPublicKeyInfo).decode()

    # -- registration (services call this at startup) -----------------------
    def add(self, service_id: str, consumer=None) -> None:
        """Register a credential slot.  `consumer` is the
        ICredentialConsumer analogue (Credentials.h:84-113): an object
        with login(username, password) -> token and re_login(current)
        -> token that the Login/ReLogin provider actions delegate to."""
        with self._lock:
            self._observers.setdefault(service_id, [])
            self._enabled.setdefault(service_id, True)
            self._status.setdefault(service_id, "")
            if consumer is not None:
                self._consumers[service_id] = consumer
            regs = list(self._register_observers)
        for cb in regs:
            cb()

    def add_register_observer(self, cb: Callable[[], None]) -> None:
        """Called whenever a new service id registers (the provider
        keeps its evented Ids property fresh)."""
        self._register_observers.append(cb)

    def ids(self) -> list[str]:
        with self._lock:
            return sorted(self._observers)

    def _check_id(self, service_id: str) -> None:
        if service_id not in self._observers:
            raise CredentialsIdNotFound(service_id)

    def subscribe(self, service_id: str, cb: Callable[[], None]) -> None:
        with self._lock:
            self._observers.setdefault(service_id, []).append(cb)

    # -- credentials --------------------------------------------------------
    def _encrypt(self, plaintext: bytes) -> bytes:
        return self._key.public_key().encrypt(
            plaintext, padding.PKCS1v15())

    def _decrypt(self, blob: bytes) -> bytes:
        return self._key.decrypt(blob, padding.PKCS1v15())

    def set(self, service_id: str, username: str, password: bytes) -> None:
        """`password` may be RSA-encrypted (control-point flow) or raw
        (local flow; it is encrypted before storage either way)."""
        self._check_id(service_id)
        try:
            plain = self._decrypt(password)
        except ValueError:
            plain = password
        if len(plain) > 245 or len(username.encode()) > 245:
            raise CredentialsTooLong(service_id)
        with self._lock:
            self._store.write(f"Credentials.{service_id}.Username",
                              username.encode())
            self._store.write(f"Credentials.{service_id}.Password",
                              self._encrypt(plain))
            self._status[service_id] = ""
            obs = list(self._observers.get(service_id, []))
        for cb in obs:
            cb()

    def get(self, service_id: str) -> tuple[str, bytes]:
        """Returns (username, decrypted password)."""
        self._check_id(service_id)
        with self._lock:
            try:
                user = self._store.read(
                    f"Credentials.{service_id}.Username").decode()
                blob = self._store.read(f"Credentials.{service_id}.Password")
            except StoreKeyNotFound:
                return "", b""
        return user, self._decrypt(blob)

    def clear(self, service_id: str) -> None:
        self._check_id(service_id)
        with self._lock:
            self._store.delete(f"Credentials.{service_id}.Username")
            self._store.delete(f"Credentials.{service_id}.Password")
            obs = list(self._observers.get(service_id, []))
        for cb in obs:
            cb()

    # -- status/enabled (reference SetState/GetStatus) -----------------------
    def set_status(self, service_id: str, status: str) -> None:
        with self._lock:
            self._status[service_id] = status

    def status(self, service_id: str) -> str:
        with self._lock:
            return self._status.get(service_id, "")

    def set_enabled(self, service_id: str, enabled: bool) -> None:
        self._check_id(service_id)
        with self._lock:
            self._enabled[service_id] = enabled
            obs = list(self._observers.get(service_id, []))
        for cb in obs:
            cb()

    def enabled(self, service_id: str) -> bool:
        with self._lock:
            return self._enabled.get(service_id, True)

    # -- login (delegates to the ICredentialConsumer analogue) --------------
    def login(self, service_id: str) -> str:
        """ProviderCredentials::Login — the registered consumer trades
        the stored credentials for a service token."""
        self._check_id(service_id)
        consumer = self._consumers.get(service_id)
        if consumer is None:
            raise CredentialsLoginFailed(f"{service_id}: no consumer")
        user, pw = self.get(service_id)
        try:
            return consumer.login(user, pw)
        except CredentialsLoginFailed:
            raise
        except Exception as e:        # noqa: BLE001 — consumer failure
            raise CredentialsLoginFailed(str(e)) from e

    def re_login(self, service_id: str, current_token: str) -> str:
        """ProviderCredentials::ReLogin — refresh an expired token; the
        reference contract returns a NEW token (or the same one if still
        valid)."""
        self._check_id(service_id)
        consumer = self._consumers.get(service_id)
        if consumer is None:
            raise CredentialsLoginFailed(f"{service_id}: no consumer")
        try:
            return consumer.re_login(current_token)
        except CredentialsLoginFailed:
            raise
        except Exception as e:        # noqa: BLE001
            raise CredentialsLoginFailed(str(e)) from e
