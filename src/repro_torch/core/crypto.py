"""Authenticated stream encryption from stdlib primitives (the port's
copy of the JAX package's ``core.crypto``, byte for byte the same
output for the same key, nonce, plaintext and AAD).

Encrypt-then-MAC: the plaintext is XORed with a SHAKE-256 keystream of
(encryption subkey, nonce), and the tag is HMAC-SHA256(MAC subkey,
nonce || ciphertext || aad).  The XOR runs through numpy, one
vectorised pass over the payload, so a slot of hundreds of MB seals in
a fraction of a second.
"""

from __future__ import annotations

import hashlib
import hmac
import os

import numpy as np


class IntegrityError(Exception):
    pass


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    # SHAKE-256 XOF as the PRF stream: one C call for the whole payload
    return hashlib.shake_256(key + b"|" + nonce).digest(n) if n else b""


def _subkeys(key: bytes) -> tuple[bytes, bytes]:
    enc = hmac.new(key, b"enc", hashlib.sha256).digest()
    mac = hmac.new(key, b"mac", hashlib.sha256).digest()
    return enc, mac


def _tag(mac_k: bytes, nonce: bytes, ct: bytes, aad: bytes) -> bytes:
    h = hmac.new(mac_k, nonce, hashlib.sha256)
    h.update(ct)
    h.update(aad)
    return h.digest()


def _xor(data: bytes, stream: bytes) -> bytes:
    return (np.frombuffer(data, np.uint8)
            ^ np.frombuffer(stream, np.uint8)).tobytes()


def seal(key: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    """nonce(16) || ciphertext || tag(32)."""
    enc_k, mac_k = _subkeys(key)
    nonce = os.urandom(16)
    ct = _xor(plaintext, _keystream(enc_k, nonce, len(plaintext)))
    tag = _tag(mac_k, nonce, ct, aad)
    return nonce + ct + tag


def open_(key: bytes, sealed: bytes, aad: bytes = b"") -> bytes:
    enc_k, mac_k = _subkeys(key)
    if len(sealed) < 48:
        raise IntegrityError("truncated message")
    nonce, ct, tag = sealed[:16], sealed[16:-32], sealed[-32:]
    expect = _tag(mac_k, nonce, ct, aad)
    if not hmac.compare_digest(expect, tag):
        raise IntegrityError("HMAC verification failed (tampered state)")
    return _xor(ct, _keystream(enc_k, nonce, len(ct)))
