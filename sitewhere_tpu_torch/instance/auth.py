"""Users, roles, passwords, and JWT — the instance-management auth stack.

The reference delegates users/roles to Apache Syncope with retry-wrapped
connections (SyncopeUserManagement.java:83-119) and mints JWTs in
web/auth/controllers/JwtService.java:35-66 (basic-auth -> JWT flow via
BasicAuthForJwt + JwtAuthForApi filters). Here users are first-class:
PBKDF2-SHA256 password hashing, role-based granted authorities, and a
dependency-free HS256 JWT implementation with expiry + claims.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import hmac
import json
import os
import threading
import time


# --- JWT (HS256) -------------------------------------------------------------


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class JwtError(Exception):
    pass


class JwtService:
    """Mint + verify HS256 JWTs (JwtService.java analog)."""

    def __init__(self, secret: bytes | None = None,
                 expiration_s: int = 60 * 60 * 24, issuer: str = "sitewhere-tpu"):
        self.secret = secret if secret is not None else os.urandom(32)
        self.expiration_s = expiration_s
        self.issuer = issuer

    def generate(self, username: str, authorities: list[str],
                 tenant: str | None = None) -> str:
        now = int(time.time())
        payload = {
            "sub": username,
            "auth": authorities,
            "iss": self.issuer,
            "iat": now,
            "exp": now + self.expiration_s,
        }
        if tenant is not None:
            payload["tenant"] = tenant
        header = {"alg": "HS256", "typ": "JWT"}
        signing_input = f"{_b64url(json.dumps(header).encode())}.{_b64url(json.dumps(payload).encode())}"
        sig = hmac.new(self.secret, signing_input.encode(), hashlib.sha256).digest()
        return f"{signing_input}.{_b64url(sig)}"

    def validate(self, token: str) -> dict:
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
        except ValueError as e:
            raise JwtError("malformed token") from e
        signing_input = f"{header_b64}.{payload_b64}".encode()
        expect = hmac.new(self.secret, signing_input, hashlib.sha256).digest()
        try:
            sig = _b64url_decode(sig_b64)
        except (ValueError, TypeError) as e:
            raise JwtError("malformed signature") from e
        if not hmac.compare_digest(expect, sig):
            raise JwtError("invalid signature")
        try:
            header = json.loads(_b64url_decode(header_b64))
            payload = json.loads(_b64url_decode(payload_b64))
        except (ValueError, UnicodeDecodeError) as e:
            raise JwtError("malformed claims") from e
        if header.get("alg") != "HS256":
            raise JwtError(f"unsupported algorithm {header.get('alg')!r}")
        if payload.get("exp", 0) < time.time():
            raise JwtError("token expired")
        return payload


# --- passwords ---------------------------------------------------------------


def hash_password(password: str, iterations: int = 100_000) -> str:
    salt = os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iterations)
    return f"pbkdf2${iterations}${_b64url(salt)}${_b64url(dk)}"


def verify_password(password: str, stored: str) -> bool:
    try:
        _, iters_s, salt_b64, dk_b64 = stored.split("$")
        salt = _b64url_decode(salt_b64)
        expect = _b64url_decode(dk_b64)
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, int(iters_s))
        return hmac.compare_digest(dk, expect)
    except (ValueError, TypeError):
        return False


# --- users + roles -----------------------------------------------------------

# granted-authority constants mirroring the reference's authority catalog
AUTH_ADMIN = "GRP_ACCESS"
AUTH_ADMINISTER_USERS = "ADMINISTER_USERS"
AUTH_ADMINISTER_TENANTS = "ADMINISTER_TENANTS"
AUTH_VIEW_INFORMATION = "VIEW_SERVER_INFORMATION"

DEFAULT_ROLES = {
    "admin": [AUTH_ADMIN, AUTH_ADMINISTER_USERS, AUTH_ADMINISTER_TENANTS,
              AUTH_VIEW_INFORMATION],
    "user": [AUTH_VIEW_INFORMATION],
}


@dataclasses.dataclass
class User:
    username: str
    hashed_password: str
    first_name: str = ""
    last_name: str = ""
    email: str = ""
    roles: list[str] = dataclasses.field(default_factory=lambda: ["user"])
    enabled: bool = True
    created_ms: float = 0.0
    last_login_ms: float | None = None


class AuthenticationError(Exception):
    pass


class UserManagement:
    """User CRUD + authentication (SyncopeUserManagement capability,
    embedded). Role -> authority expansion mirrors the reference's granted-
    authority model."""

    def __init__(self):
        self._lock = threading.Lock()
        self.users: dict[str, User] = {}
        self.roles: dict[str, list[str]] = dict(DEFAULT_ROLES)
        # fires ("upsert"|"delete", "user"|"role", key, obj) after each
        # mutation, outside the lock — the cluster replicator's tap.
        # Ships the User with its HASHED password only (state-based
        # replication never journals or transmits a plaintext password).
        self.on_change = None

    def _notify(self, action: str, kind: str, key: str, obj) -> None:
        cb = self.on_change
        if cb is not None:
            cb(action, kind, key, obj)

    def create_user(self, username: str, password: str, roles: list[str] | None = None,
                    **kw) -> User:
        with self._lock:
            if username in self.users:
                raise ValueError(f"user {username!r} already exists")
            for role in roles or ["user"]:
                if role not in self.roles:
                    raise ValueError(f"unknown role {role!r}")
            user = User(username=username, hashed_password=hash_password(password),
                        roles=roles or ["user"], created_ms=time.time() * 1000, **kw)
            self.users[username] = user
        self._notify("upsert", "user", username, user)
        return user

    def authenticate(self, username: str, password: str) -> User:
        user = self.users.get(username)
        if user is None or not user.enabled:
            raise AuthenticationError("unknown or disabled user")
        if not verify_password(password, user.hashed_password):
            raise AuthenticationError("bad credentials")
        user.last_login_ms = time.time() * 1000
        return user

    def authorities_for(self, user: User) -> list[str]:
        out: list[str] = []
        for role in user.roles:
            for auth in self.roles.get(role, []):
                if auth not in out:
                    out.append(auth)
        return out

    def update_user(self, username: str, password: str | None = None,
                    roles: list[str] | None = None, enabled: bool | None = None,
                    **kw) -> User:
        with self._lock:
            user = self.users.get(username)
            if user is None:
                raise KeyError(f"user {username!r} not found")
            if password is not None:
                user.hashed_password = hash_password(password)
            if roles is not None:
                unknown = [r for r in roles if r not in self.roles]
                if unknown:
                    raise ValueError(f"unknown roles: {unknown}")
                user.roles = roles
            if enabled is not None:
                user.enabled = enabled
            for k, v in kw.items():
                setattr(user, k, v)
        self._notify("upsert", "user", username, user)
        return user

    def add_roles(self, username: str, roles: list[str]) -> User:
        """Append roles (reference: Users.java @PUT /{username}/roles ->
        SyncopeUserManagement.addRoles)."""
        with self._lock:
            user = self.users.get(username)
            if user is None:
                raise KeyError(f"user {username!r} not found")
            unknown = [r for r in roles if r not in self.roles]
            if unknown:
                raise ValueError(f"unknown roles: {unknown}")
            for r in roles:
                if r not in user.roles:
                    user.roles.append(r)
        self._notify("upsert", "user", username, user)
        return user

    def remove_roles(self, username: str, roles: list[str]) -> User:
        """Remove roles (reference: Users.java @DELETE /{username}/roles)."""
        with self._lock:
            user = self.users.get(username)
            if user is None:
                raise KeyError(f"user {username!r} not found")
            user.roles = [r for r in user.roles if r not in set(roles)]
        self._notify("upsert", "user", username, user)
        return user

    def delete_user(self, username: str) -> bool:
        with self._lock:
            existed = self.users.pop(username, None) is not None
        if existed:
            self._notify("delete", "user", username, None)
        return existed

    def create_role(self, role: str, authorities: list[str]) -> None:
        with self._lock:
            self.roles[role] = list(authorities)
        self._notify("upsert", "role", role, list(authorities))

    # ---- replication surface (no hook: peers must not re-broadcast) ----
    def apply_replicated_user(self, username: str, user: "User | None") -> None:
        with self._lock:
            if user is None:
                self.users.pop(username, None)
            else:
                self.users[username] = user

    def apply_replicated_role(self, role: str,
                              authorities: "list[str] | None") -> None:
        with self._lock:
            if authorities is None:
                self.roles.pop(role, None)
            else:
                self.roles[role] = list(authorities)
