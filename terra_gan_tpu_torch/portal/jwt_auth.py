"""Minimal HS256 JWT encode/verify (standard library only).

The port's own copy of terra_gan_tpu/portal/jwt_auth.py, which the
serving path's bearer tokens go through. The reference portal validates
bearer tokens as HS256 JWTs signed with the app secret
(Annotation_Portal_Code/app.py:38-55: `jwt.decode(token, SECRET_KEY,
algorithms=['HS256'])`, 401 on InvalidTokenError). This module
implements that subset without PyJWT: compact JWS with HS256, base64url
without padding, signature verification in constant time, and
`exp`/`nbf` claim validation (the checks PyJWT's decode performs by
default).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, Optional


class InvalidTokenError(ValueError):
    """Raised for any malformed, tampered, expired or not-yet-valid token."""


def _b64url_encode(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: str | bytes) -> bytes:
    if isinstance(data, str):
        data = data.encode("ascii", "strict")
    pad = (-len(data)) % 4
    return base64.urlsafe_b64decode(data + b"=" * pad)


def encode(claims: Dict[str, Any], secret: str, *,
           expires_in: Optional[float] = None) -> str:
    """Create a signed HS256 JWT. `expires_in` adds an `exp` claim."""
    if expires_in is not None:
        claims = {**claims, "exp": int(time.time() + expires_in)}
    header = _b64url_encode(
        json.dumps({"alg": "HS256", "typ": "JWT"}, separators=(",", ":")).encode()
    )
    payload = _b64url_encode(
        json.dumps(claims, separators=(",", ":")).encode()
    )
    signing_input = header + b"." + payload
    sig = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    return (signing_input + b"." + _b64url_encode(sig)).decode("ascii")


def decode(token: str, secret: str, *, leeway: float = 0.0) -> Dict[str, Any]:
    """Verify an HS256 JWT and return its claims.

    Same failure surface PyJWT's decode presents to the reference app:
    any structural problem, signature mismatch, non-HS256 alg (incl.
    'none'), expired `exp`, or future `nbf` raises InvalidTokenError.
    """
    parts = token.split(".")
    if len(parts) != 3:
        raise InvalidTokenError("token must have three segments")
    header_b64, payload_b64, sig_b64 = parts
    try:
        header = json.loads(_b64url_decode(header_b64))
        claims = json.loads(_b64url_decode(payload_b64))
        signature = _b64url_decode(sig_b64)
    except (ValueError, TypeError) as e:
        raise InvalidTokenError(f"undecodable token: {e}") from e
    if not isinstance(header, dict) or header.get("alg") != "HS256":
        raise InvalidTokenError("alg must be HS256")
    signing_input = (header_b64 + "." + payload_b64).encode("ascii")
    expected = hmac.new(secret.encode(), signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(signature, expected):
        raise InvalidTokenError("signature mismatch")
    if not isinstance(claims, dict):
        raise InvalidTokenError("claims must be a JSON object")
    now = time.time()
    if "exp" in claims:
        try:
            exp = float(claims["exp"])
        except (TypeError, ValueError) as e:
            raise InvalidTokenError("bad exp claim") from e
        if now > exp + leeway:
            raise InvalidTokenError("token expired")
    if "nbf" in claims:
        try:
            nbf = float(claims["nbf"])
        except (TypeError, ValueError) as e:
            raise InvalidTokenError("bad nbf claim") from e
        if now < nbf - leeway:
            raise InvalidTokenError("token not yet valid")
    return claims
