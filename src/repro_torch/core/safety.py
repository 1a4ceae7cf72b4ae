"""Safety module: authentication, rate limiting, content filtering
(paper §1: "inference control" + Figure 1's Safety Module)."""
from __future__ import annotations

import hashlib
import hmac
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Set


class AuthError(Exception):
    pass


class RateLimited(Exception):
    pass


class ContentBlocked(Exception):
    pass


@dataclass
class Authenticator:
    """HMAC-signed API keys: token = user_id + ":" + hex(hmac(secret, user_id))."""
    secret: bytes = b"repro-secret"

    def issue(self, user_id: str) -> str:
        sig = hmac.new(self.secret, user_id.encode(), hashlib.sha256).hexdigest()
        return f"{user_id}:{sig}"

    def verify(self, token: str) -> str:
        try:
            user_id, sig = token.split(":", 1)
        except ValueError:
            raise AuthError("malformed token")
        expect = hmac.new(self.secret, user_id.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(sig, expect):
            raise AuthError("bad signature")
        return user_id


@dataclass
class TokenBucket:
    """Per-user token-bucket rate limiter (rate/sec, burst capacity)."""
    rate: float = 100.0
    burst: float = 200.0
    _state: Dict[str, tuple] = field(default_factory=dict)

    def check(self, user_id: str, cost: float = 1.0, now: Optional[float] = None) -> None:
        t = time.monotonic() if now is None else now
        tokens, last = self._state.get(user_id, (self.burst, t))
        tokens = min(self.burst, tokens + (t - last) * self.rate)
        if tokens < cost:
            self._state[user_id] = (tokens, t)
            raise RateLimited(f"user {user_id}")
        self._state[user_id] = (tokens - cost, t)


@dataclass
class ContentFilter:
    """Blocklist scan over prompt token ids (stand-in for sensitive-content
    detection; real systems run a classifier here)."""
    blocked: Set[int] = field(default_factory=set)

    def check(self, tokens: Iterable[int]) -> None:
        if self.blocked:
            hit = next((t for t in tokens if int(t) in self.blocked), None)
            if hit is not None:
                raise ContentBlocked(f"token {hit}")
