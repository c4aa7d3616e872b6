"""Trust termination for the serve fleet: per-household bearer tokens + TLS.

Untrusted households on real networks reach the gateway/router; two
stdlib-only primitives terminate trust there:

* **HMAC-signed bearer tokens.** ``p2p1.<b64url(claims)>.<b64url(sig)>``
  where ``claims`` is JSON ``{"household": id, "iat": unix, "exp": unix
  or null}`` and ``sig`` is HMAC-SHA256 over the claims bytes with the
  fleet secret. No asymmetric crypto, no external deps — one shared
  secret file (``serve-token --new-secret``) distributed to every
  gateway/router process. The household claim ``"*"`` is the operator
  wildcard: it authorizes ANY household plus the admin surface
  (``/stats``, ``/admin/*``) — the router holds one to probe and swap.
* **Failure taxonomy.** A missing/malformed/forged/expired token is 401
  ("you are nobody"); a VALID token presented for another household's
  request is 403 ("you are somebody, but not them"). Both are terminal
  client errors on the wire: router and loadgen never retry them and
  they never consume the retry budget — an attacker hammering /v1/act
  with garbage tokens must not eat the budget honest retries depend on.
* **Rotation without a synchronized restart.** ``rotate_secret`` writes a
  fresh secret in place and parks the previous one next to it
  (``<path>.prev``, JSON with an expiry ``grace_s`` seconds out);
  ``load_secret_chain`` returns the primary plus the still-graced old
  secret, and a ``TokenAuthenticator`` built on a chain verifies against
  BOTH until the grace expires (checked at verification time, so a
  long-lived gateway honors the expiry without reloading). Tokens are
  always MINTED with the primary — the old secret only verifies. Fleets
  rotate by running ``serve-token --rotate`` and restarting/reloading
  processes at leisure inside the grace window; requests signed with
  either secret pass mid-rotation, and post-grace old-secret tokens 401.
* **TLS.** ``server_ssl_context``/``client_ssl_context`` wrap stdlib
  ``ssl``; ``ensure_test_certs`` shells out to the system ``openssl`` to
  mint a short-lived self-signed cert (SAN ``IP:127.0.0.1,DNS:localhost``)
  under ``artifacts/tls/`` — a scratch location ``.gitignore``d and
  exempted by ``tools/check_artifacts_schema.py``'s committed-private-key
  refusal, so test keys can exist locally but never land in the repo.

Timing discipline: signature comparison is ``hmac.compare_digest``
(constant-time); everything else here is cold-path per-request work
measured in microseconds against a millisecond wire.
"""

from __future__ import annotations

import base64
import hmac
import hashlib
import json
import os
import secrets
import shutil
import subprocess
import time
from typing import Optional, Tuple

TOKEN_PREFIX = "p2p1"
WILDCARD_HOUSEHOLD = "*"


class AuthError(Exception):
    """A rejected credential. ``status`` is the HTTP mapping: 401 for
    missing/malformed/forged/expired tokens, 403 for a valid token that
    does not authorize the requested household/surface."""

    def __init__(self, message: str, status: int = 401):
        super().__init__(message)
        self.status = status


def _b64e(raw: bytes) -> str:
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def _b64d(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    return base64.urlsafe_b64decode(text + pad)


def generate_secret(path: Optional[str] = None) -> str:
    """A fresh 32-byte hex fleet secret; written 0600 when ``path``."""
    secret = secrets.token_hex(32)
    if path is not None:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            f.write(secret + "\n")
    return secret


def load_secret(path: str) -> str:
    with open(path) as f:
        secret = f.read().strip()
    if not secret:
        raise ValueError(f"secret file {path} is empty")
    return secret


def _prev_secret_path(path: str) -> str:
    return path + ".prev"


def rotate_secret(
    path: str, grace_s: float = 3600.0, now: Optional[float] = None
) -> str:
    """Rotate the fleet secret at ``path`` in place.

    Writes a fresh secret to ``path`` (0600) and parks the PREVIOUS one in
    ``<path>.prev`` as JSON ``{"secret": ..., "expires": unix}`` with the
    expiry ``grace_s`` seconds from ``now``. Verifiers built from
    ``load_secret_chain`` honor both until the grace passes, so the fleet
    needs no synchronized restart; minting always uses the new primary.
    Returns the new secret.
    """
    now = time.time() if now is None else now
    old = load_secret(path)
    fd = os.open(
        _prev_secret_path(path), os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600
    )
    with os.fdopen(fd, "w") as f:
        json.dump({"secret": old, "expires": now + max(grace_s, 0.0)}, f)
    return generate_secret(path)


def load_secret_chain(
    path: str, now: Optional[float] = None
) -> list:
    """``[(secret, expires_or_None), ...]`` — the primary secret first
    (never expiring), then the rotated-out previous secret while its grace
    window holds. An expired/missing/corrupt ``.prev`` contributes
    nothing: the chain degrades to exactly ``load_secret``'s behavior."""
    now = time.time() if now is None else now
    chain = [(load_secret(path), None)]
    try:
        with open(_prev_secret_path(path)) as f:
            prev = json.load(f)
        secret = prev.get("secret")
        expires = float(prev.get("expires", 0.0))
        if secret and expires > now:
            chain.append((secret, expires))
    except (OSError, ValueError, TypeError):
        pass
    return chain


def _sign(secret: str, claims_raw: bytes) -> bytes:
    return hmac.new(secret.encode(), claims_raw, hashlib.sha256).digest()


def mint_token(
    secret: str,
    household: str,
    ttl_s: Optional[float] = None,
    now: Optional[float] = None,
) -> str:
    """A signed bearer for ``household`` (``"*"`` = operator wildcard),
    expiring ``ttl_s`` seconds from ``now`` (None = never)."""
    if not household:
        raise ValueError("household must be non-empty")
    now = time.time() if now is None else now
    claims = {
        "household": household,
        "iat": int(now),
        "exp": int(now + ttl_s) if ttl_s is not None else None,
    }
    raw = json.dumps(claims, sort_keys=True, separators=(",", ":")).encode()
    return f"{TOKEN_PREFIX}.{_b64e(raw)}.{_b64e(_sign(secret, raw))}"


def verify_token(secret: str, token: str, now: Optional[float] = None) -> dict:
    """The verified claims dict, or ``AuthError`` (always 401 here: a
    token that fails verification authenticates nobody)."""
    if not isinstance(token, str) or not token:
        raise AuthError("missing bearer token", status=401)
    parts = token.split(".")
    if len(parts) != 3 or parts[0] != TOKEN_PREFIX:
        raise AuthError("malformed bearer token", status=401)
    try:
        raw = _b64d(parts[1])
        sig = _b64d(parts[2])
    except (ValueError, TypeError):
        raise AuthError("malformed bearer token", status=401) from None
    if not hmac.compare_digest(sig, _sign(secret, raw)):
        raise AuthError("bad token signature", status=401)
    try:
        claims = json.loads(raw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError):
        raise AuthError("malformed token claims", status=401) from None
    if not isinstance(claims, dict) or not claims.get("household"):
        raise AuthError("token carries no household claim", status=401)
    exp = claims.get("exp")
    if exp is not None:
        now = time.time() if now is None else now
        if now >= exp:
            raise AuthError("token expired", status=401)
    return claims


class TokenAuthenticator:
    """The gateway/router-side verifier bound to one fleet secret — or,
    across a rotation, to a dual-secret chain: ``secret`` may be a plain
    string or a ``load_secret_chain`` list of ``(secret, expires)`` pairs.
    Minting always signs with the PRIMARY (first) secret; verification
    accepts any chain member whose expiry has not passed — expiry is
    checked per verification, so the grace window closes on schedule in a
    long-lived process without reloading the chain."""

    def __init__(self, secret):
        if isinstance(secret, str):
            chain = [(secret, None)]
        else:
            chain = [(s, e) for s, e in secret]
        if not chain or not all(s for s, _ in chain):
            raise ValueError("secret must be non-empty")
        self.chain = chain
        self.secret = chain[0][0]  # the minting (primary) secret

    @classmethod
    def from_secret_file(cls, path: str) -> "TokenAuthenticator":
        """Build from a secret file, honoring a rotation's ``.prev``
        grace window (``load_secret_chain``)."""
        return cls(load_secret_chain(path))

    def mint(self, household: str, ttl_s: Optional[float] = None) -> str:
        return mint_token(self.secret, household, ttl_s=ttl_s)

    def verify(self, token: Optional[str]) -> dict:
        """Verify against every live chain member; the PRIMARY's failure
        is what surfaces (the old secret is a compatibility window, not
        an identity of its own)."""
        now = time.time()
        primary_error: Optional[AuthError] = None
        for i, (secret, expires) in enumerate(self.chain):
            if expires is not None and now >= expires:
                continue
            try:
                return verify_token(secret, token, now=now)
            except AuthError as err:
                if i == 0:
                    primary_error = err
        raise primary_error or AuthError("missing bearer token", status=401)

    def check(self, token: Optional[str], household: Optional[str]) -> dict:
        """Authorize an act request for ``household``. 401 on a token
        that authenticates nobody; 403 on a real token for the wrong
        household (wildcard tokens pass any)."""
        claims = self.verify(token)
        claimed = claims["household"]
        if claimed == WILDCARD_HOUSEHOLD:
            return claims
        if household is not None and household != claimed:
            raise AuthError(
                f"token authorizes household {claimed!r}, "
                f"not {household!r}", status=403,
            )
        return claims

    def check_admin(self, token: Optional[str]) -> dict:
        """Authorize the admin surface (stats/swap/drain): wildcard only."""
        claims = self.verify(token)
        if claims["household"] != WILDCARD_HOUSEHOLD:
            raise AuthError(
                "admin surface requires the operator wildcard token",
                status=403,
            )
        return claims


# -- TLS ----------------------------------------------------------------------


def server_ssl_context(cert_path: str, key_path: str):
    """TLS-terminating server context over a cert/key pair on disk."""
    import ssl

    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_ssl_context(cafile: str):
    """Client context trusting EXACTLY ``cafile`` (the fleet's self-signed
    test cert doubles as its own CA); hostname/IP-SAN checking stays ON."""
    import ssl

    return ssl.create_default_context(cafile=cafile)


# artifacts/tls under the REPO ROOT is the designated local scratch for
# generated test certs: .gitignore'd, and exempted from
# check_artifacts_schema's private-key refusal — keys may exist there,
# never anywhere committed. Anchored to this file (not the CWD) so a CLI
# run from a subdirectory cannot scatter key material into unignored,
# checker-visible locations.
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
TEST_CERT_DIR = os.path.join(_REPO_ROOT, "artifacts", "tls")


def ensure_test_certs(
    cert_dir: str = TEST_CERT_DIR,
    days: int = 2,
    refresh_after_s: float = 12 * 3600.0,
) -> Tuple[str, str]:
    """(cert_path, key_path) of a loopback self-signed pair under
    ``cert_dir``, minted via the system ``openssl`` (no Python crypto
    deps). Reuses a pair younger than ``refresh_after_s`` — well inside
    the ``days`` validity, so a reused cert never expires mid-run."""
    cert = os.path.join(cert_dir, "test-cert.pem")
    key = os.path.join(cert_dir, "test-key.pem")
    if os.path.exists(cert) and os.path.exists(key):
        age = time.time() - os.path.getmtime(cert)
        if age < refresh_after_s:
            return cert, key
    if shutil.which("openssl") is None:
        raise RuntimeError(
            "openssl binary not found: cannot generate test TLS certs "
            "(provide --tls-cert/--tls-key explicitly)"
        )
    os.makedirs(cert_dir, exist_ok=True)
    subprocess.run(
        [
            "openssl", "req", "-x509", "-newkey", "rsa:2048",
            "-keyout", key, "-out", cert,
            "-days", str(days), "-nodes",
            "-subj", "/CN=p2p-test-fleet",
            "-addext", "subjectAltName=IP:127.0.0.1,DNS:localhost",
        ],
        check=True,
        capture_output=True,
    )
    os.chmod(key, 0o600)
    return cert, key
