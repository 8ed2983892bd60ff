"""The JAX package's checkpoint files, read without flax (counterpart of
``flax.serialization.msgpack_restore``, which kvq_tpu/core/checkpoint.py
calls).

A file is one msgpack map.  Its leaves use flax's extension types:

  - code 1, an ndarray: the msgpack of ``(shape, dtype name, C-order
    bytes)``;
  - code 2, a Python complex: the msgpack of ``(real, imag)``;
  - code 3, a numpy scalar: packed as a 0-d ndarray.

bfloat16, which numpy does not name, comes back as a ``torch.bfloat16``
tensor (the bytes through a uint16 view); every other array as a numpy
array.  Arrays over 2^30 bytes are stored as ``__msgpack_chunked_array__``
maps of flat chunks and are reassembled.  Tuples and namedtuples (optax
states) come back as maps with the keys ``"0"``, ``"1"``, ... or the field
names, and empty states as ``{}``, exactly as flax restores them.
"""

from __future__ import annotations

import numpy as np
import torch

_NDARRAY, _COMPLEX, _SCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


def _array(data: bytes):
    import msgpack

    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype == b"bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _NDARRAY:
        return _array(data)
    if code == _SCALAR:
        a = _array(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    if code == _COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    return msgpack.ExtType(code, data)


def _concat(chunks: list):
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks])
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks])


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return _concat(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes):
    """The tree of a flax msgpack payload (``msgpack_restore``'s result,
    with bfloat16 arrays as torch tensors)."""
    import msgpack

    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False))


def read(path: str):
    with open(path, "rb") as f:
        return restore(f.read())


def is_torch_file(head: bytes) -> bool:
    """Whether the first bytes of a file are ``torch.save``'s: a zip archive,
    or (the legacy format) a pickle's protocol header.  A msgpack map never
    starts so: its first byte is 0x80-0x8f, 0xde or 0xdf, and 0x80 is the
    empty map, which has no second byte."""
    return head[:4] == b"PK\x03\x04" or (
        len(head) > 1 and head[0] == 0x80 and 2 <= head[1] <= 5)
