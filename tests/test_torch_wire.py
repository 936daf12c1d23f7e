"""The port's wire primitives against the JAX package's: the msgpack
subset byte for byte against ``msgpack``, the compression shim on the
JAX package's frames, and the sealed channel byte for byte against
``repro.core.crypto``."""

import os

import msgpack
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import compression as jcompression  # noqa: E402
from repro.core import crypto as jcrypto  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.core import crypto  # noqa: E402
from repro_torch.core.msgpack_subset import packb, unpackb  # noqa: E402

LENGTHS = (0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536)
INTS = (0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**63 - 1, 2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
        -2**31, -2**31 - 1, -2**63)

VALUES = (
    [pytest.param(v, id=f"int{v}") for v in INTS]
    + [pytest.param("s" * n, id=f"str{n}") for n in LENGTHS]
    + [pytest.param(b"\x01" * n, id=f"bin{n}") for n in LENGTHS]
    + [pytest.param(list(range(n)), id=f"array{n}") for n in LENGTHS]
    + [pytest.param({f"k{i}": i for i in range(n)}, id=f"map{n}")
       for n in LENGTHS]
    + [pytest.param(v, id=name) for name, v in (
        ("float0", 0.0), ("float-1.5", -1.5), ("float1e300", 1e300),
        ("float-inf", float("-inf")), ("true", True), ("false", False),
        ("none", None), ("utf8", "é漢字"), ("tuple", (1, "a", b"b")),
        ("nested", {"leaves": [{"key": ".tokens", "shape": [4],
                                "dtype": "int32", "data": b"\x00" * 16}],
                    "meta": {"request": {"rid": "r0", "deadline": None,
                                         "temperature": 0.7,
                                         "output": [1, 300, 70000]},
                             "step": 3, "version": 2}}))])


@pytest.mark.parametrize("value", VALUES)
def test_packb_is_byte_identical_to_msgpack(value):
    assert packb(value) == msgpack.packb(value)


@pytest.mark.parametrize("value", VALUES)
def test_unpackb_reads_what_msgpack_reads(value):
    blob = msgpack.packb(value)
    assert unpackb(blob) == msgpack.unpackb(blob)


def test_unpackb_refuses_truncated_and_trailing_bytes():
    blob = msgpack.packb({"a": b"x" * 300})
    with pytest.raises(ValueError, match="truncated"):
        unpackb(blob[:-1])
    with pytest.raises(ValueError, match="extra bytes"):
        unpackb(blob + b"\x00")
    with pytest.raises(TypeError):
        packb({1, 2})


@pytest.mark.parametrize("backend", ["jax_default", "zlib"])
def test_decompress_reads_jax_compressed_blobs(backend):
    """Blobs the JAX shim wrote (zstd where the wheel exists, and the
    zlib frame the card machine writes) decompress in the port."""
    data = np.random.default_rng(0).integers(0, 4, 50_000,
                                             np.uint8).tobytes()
    if backend == "zlib":
        import zlib
        blob = zlib.compress(data, 3)
    else:
        blob = jcompression.compress(data)
    assert compression.decompress(blob) == data
    assert compression.Decompressor().decompress(blob) == data
    assert jcompression.decompress(compression.compress(data)) == data


@pytest.mark.parametrize("n", [0, 1, 4096, 100_003])
def test_seal_is_byte_identical_to_jax(monkeypatch, n):
    key = bytes(range(32))
    plaintext = np.random.default_rng(n).integers(
        0, 256, n, np.uint8).tobytes()
    monkeypatch.setattr(os, "urandom", lambda k: b"\x5a" * k)
    ours = crypto.seal(key, plaintext, aad=b"gid")
    theirs = jcrypto.seal(key, plaintext, aad=b"gid")
    assert ours == theirs
    assert crypto.open_(key, theirs, aad=b"gid") == plaintext
    assert jcrypto.open_(key, ours, aad=b"gid") == plaintext


@pytest.mark.parametrize("where", ["nonce", "ciphertext", "tag", "aad",
                                   "truncated"])
def test_tampering_raises_integrity_error(where):
    key = b"k" * 32
    sealed = crypto.seal(key, b"the workspace bytes" * 10, aad=b"model-A")
    aad = b"model-A"
    if where == "truncated":
        sealed = sealed[:40]
    elif where == "aad":
        aad = b"model-B"
    else:
        i = {"nonce": 3, "ciphertext": 30, "tag": len(sealed) - 5}[where]
        sealed = sealed[:i] + bytes([sealed[i] ^ 0x40]) + sealed[i + 1:]
    with pytest.raises(crypto.IntegrityError):
        crypto.open_(key, sealed, aad=aad)
