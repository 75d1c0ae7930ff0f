"""Auth0 JWT verification (RS256) with the standard library.

The port's own copy of ``instageo_tpu/webapp/auth.py`` (reference
``instageo/new_apps/backend/app/auth.py``): JWKS fetch with caching, RS256
signature verification, audience/issuer validation, task ownership checks,
and /userinfo retrieval with retry. The fetches go over ``urllib``; the
signature is checked as RFC 8017 §8.2.2 sets out (RSASSA-PKCS1-v1_5 with
SHA-256): ``m = s^e mod n``, compared in constant time with the
EMSA-PKCS1-v1_5 encoding of the message's SHA-256 ``DigestInfo``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional

from instageo_tpu_torch.utils.ratelimit import retry_backoff
from instageo_tpu_torch.webapp.settings import settings

log = logging.getLogger(__name__)

# DER prefix of DigestInfo{sha256, OCTET STRING(32)} (RFC 8017 §9.2 note 1).
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


class AuthError(Exception):
    def __init__(self, message: str, status: int = 401) -> None:
        super().__init__(message)
        self.status = status


def _b64url_decode(s: str) -> bytes:
    s += "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s)


def _get_json(url: str, headers: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """GET ``url`` and parse its JSON; an HTTP error status raises
    ``urllib.error.HTTPError``."""
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=15) as r:
        return json.loads(r.read())


_JWKS_REFETCH_COOLDOWN_S = 30.0
_last_jwks_refetch: dict = {}


def _jwks_refetch_allowed(domain: str) -> bool:
    """Per-domain cooldown: one tenant's refetch (or a forged kid) must
    not block another tenant's rotation recovery."""
    now = time.monotonic()
    if now - _last_jwks_refetch.get(domain, 0.0) >= _JWKS_REFETCH_COOLDOWN_S:
        _last_jwks_refetch[domain] = now
        return True
    return False


_jwks_cache: Dict[str, Dict[str, Any]] = {}


def get_jwks(domain: str) -> Dict[str, Any]:
    """Fetch + cache the tenant's JWKS (reference auth.py:19-34).

    Per-domain dict cache: key-rotation recovery must be able to evict ONE
    domain's entry without dropping every other tenant's cached keys."""
    cached = _jwks_cache.get(domain)
    if cached is None:
        cached = _get_json(f"https://{domain}/.well-known/jwks.json")
        _jwks_cache[domain] = cached
    return cached


def _evict_jwks(domain: str) -> None:
    _jwks_cache.pop(domain, None)


def _rsa_key_from_jwk(jwk: Dict[str, str]):
    """(n, e) of an RSA JWK."""
    n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
    e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
    return n, e


def rs256_verify(n: int, e: int, signature: bytes, message: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 verification with SHA-256 (RFC 8017 §8.2.2)."""
    k = (n.bit_length() + 7) // 8
    if len(signature) != k:
        return False
    s = int.from_bytes(signature, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(k, "big")
    t = _SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        return False
    expected = b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(em, expected)


def verify_jwt(token: str, domain: Optional[str] = None,
               audience: Optional[str] = None) -> Dict[str, Any]:
    """Verify an RS256 JWT: signature, exp, aud, iss (reference auth.py:36-73)."""
    domain = domain or settings.AUTH0_DOMAIN
    audience = audience or settings.AUTH0_AUDIENCE
    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        payload = json.loads(_b64url_decode(payload_b64))
        signature = _b64url_decode(sig_b64)
    except Exception as e:
        raise AuthError(f"Malformed token: {e}")

    if header.get("alg") != "RS256":
        raise AuthError(f"Unsupported algorithm {header.get('alg')}")

    def _find_key():
        jwks = get_jwks(domain)
        return next((k for k in jwks.get("keys", [])
                     if k.get("kid") == header.get("kid")), None)

    key_spec = _find_key()
    if key_spec is None and _jwks_refetch_allowed(domain):
        # Unknown kid usually means the tenant rotated its signing keys
        # since the JWKS was cached: evict THIS domain's entry and refetch
        # ONCE before rejecting (cooldown-limited so forged kids can't turn
        # this into a JWKS-fetch amplifier).
        _evict_jwks(domain)
        key_spec = _find_key()
    if key_spec is None:
        raise AuthError("Signing key not found")
    try:
        n, e = _rsa_key_from_jwk(key_spec)
        valid = rs256_verify(n, e, signature, f"{header_b64}.{payload_b64}".encode())
    except Exception:
        valid = False
    if not valid:
        raise AuthError("Invalid signature")

    # exp and iss are REQUIRED: a token without exp must not live forever,
    # and a token without iss must not skip issuer validation.
    now = time.time()
    if "exp" not in payload:
        raise AuthError("Token missing exp claim")
    if payload["exp"] < now:
        raise AuthError("Token expired")
    aud = payload.get("aud")
    auds = aud if isinstance(aud, list) else [aud]
    if audience and audience not in auds:
        raise AuthError("Invalid audience")
    issuer = f"https://{domain}/"
    if payload.get("iss") != issuer:
        raise AuthError("Invalid issuer")
    return payload


@retry_backoff((urllib.error.URLError, OSError), max_tries=3, max_time=30)
def get_userinfo(token: str, domain: Optional[str] = None) -> Dict[str, Any]:
    """Auth0 /userinfo with retry (reference auth.py:104-159)."""
    domain = domain or settings.AUTH0_DOMAIN
    return _get_json(f"https://{domain}/userinfo",
                     headers={"Authorization": f"Bearer {token}"})


def get_current_user(token: str) -> Dict[str, Any]:
    """Validate the token and return user claims."""
    if settings.AUTH_DISABLED:
        return {"sub": "test-user", "email": "test@example.com"}
    return verify_jwt(token)


def is_task_owner(task: Dict[str, Any], user: Dict[str, Any]) -> bool:
    """Ownership check (reference auth.py:76-101)."""
    return bool(task) and task.get("user_sub") == user.get("sub")
