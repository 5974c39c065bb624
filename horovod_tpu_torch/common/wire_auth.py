"""HMAC signing for the Python control-plane messages.

Copied from ``horovod_tpu/common/wire_auth.py`` (reference parity:
horovod/runner/common/util/secret.py + network.py — the reference signs
every pickled driver/task RPC message with a per-job shared secret and
rejects messages whose digest does not verify).  Here the signed
channels are the elastic driver <-> worker JSON-line sockets
(``runner/elastic_driver.py``, ``elastic/worker.py``).

The secret is the launcher-generated per-job nonce in ``HVD_TPU_SECRET``
(the launcher exports it to every worker).  Signing is per-message (no
sequence numbers): replay within one job's lifetime is accepted, exactly
the reference's HMAC-of-payload property — the fresh per-job secret
kills cross-job replay.  When no secret is set (bare single-host runs
outside the launcher) messages pass unsigned, matching the reference's
behavior when run without horovodrun.  The canonical JSON (sorted keys,
no spaces) is the JAX package's, so a message signed by either package
verifies in the other.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
from typing import Optional

SECRET_ENV = "HVD_TPU_SECRET"


def make_secret() -> str:
    """Fresh per-job secret (reference: secret.make_secret_key)."""
    return os.urandom(32).hex()


def job_secret() -> Optional[str]:
    return os.environ.get(SECRET_ENV) or None


def _mac(secret: str, payload: str) -> str:
    return hmac.new(secret.encode(), payload.encode(),
                    hashlib.sha256).hexdigest()


def _canonical(obj: dict) -> str:
    body = {k: v for k, v in obj.items() if k != "hmac"}
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def sign_message(obj: dict, secret: Optional[str]) -> dict:
    """Return a copy of ``obj`` carrying an ``hmac`` field over its
    canonical JSON encoding; identity when no secret is configured."""
    if not secret:
        return obj
    out = {k: v for k, v in obj.items() if k != "hmac"}
    out["hmac"] = _mac(secret, _canonical(obj))
    return out


def verify_message(obj: dict, secret: Optional[str]) -> Optional[dict]:
    """Verify and strip the ``hmac`` field.  Returns the payload dict, or
    None when a secret is configured and the signature is missing/wrong
    (callers must drop the message / close the peer)."""
    if not secret:
        return obj
    mac = obj.get("hmac")
    if not isinstance(mac, str):
        return None
    if not hmac.compare_digest(mac, _mac(secret, _canonical(obj))):
        return None
    return {k: v for k, v in obj.items() if k != "hmac"}
