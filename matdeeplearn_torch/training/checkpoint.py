"""The port's checkpoint format: one torch.save file.

  {"meta": json string, "params": {name: tensor},
   "batch_stats": {name: tensor}, "optimizer": optimizer state_dict or None}

`meta` has the reference package's keys (model_name, model_config,
scheduler), so the model is rebuilt by registry name, and the scheduler's
state is recorded as the reference package records it. `params` and
`batch_stats` split the model's state_dict into parameters and running
statistics; `optimizer` (written by Training) holds the optimizer's state
with its learning rate, so `load_model: "True"` resumes parameters,
statistics and optimizer as the reference package's
load_checkpoint(path, run.state) does. Only tensors, numbers and strings
are stored: loading uses torch.load(weights_only=True) and runs no pickled
code.

`load_checkpoint` also reads the reference package's checkpoints: msgpack
({"meta": json string, "state": the TrainState's state dict}, in the
msgpack encoding of the reference's serialization library), decoded by
the port's own `msgpack_restore` (it imports no msgpack package) and
turned into a
state_dict by convert.params_from_jax. The two formats come apart by
their first bytes: a torch.save zip starts with "PK", msgpack with a map.
Such a file carries no torch optimizer state.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

_STAT_NAMES = ("running_mean", "running_var")


def split_state_dict(state_dict: dict) -> tuple[dict, dict]:
    """state_dict → (params, batch_stats), tensors detached on the CPU."""
    params, stats = {}, {}
    for k, v in state_dict.items():
        (stats if k.rsplit(".", 1)[-1] in _STAT_NAMES else params)[k] = (
            v.detach().cpu().clone())
    return params, stats


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def save_checkpoint(path: str, state_dict: dict, model_name: str,
                    model_config: dict, scheduler=None,
                    extra_meta: dict | None = None,
                    optimizer_state: dict | None = None):
    meta = {
        "model_name": model_name,
        "model_config": model_config,
        "scheduler": scheduler.state_dict() if scheduler is not None else None,
        **(extra_meta or {}),
    }
    params, stats = split_state_dict(state_dict)
    tmp = path + ".tmp"
    torch.save({"meta": json.dumps(meta), "params": params,
                "batch_stats": stats,
                "optimizer": _to_cpu(optimizer_state)}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, with_optimizer: bool = False):
    """Returns (meta dict, state_dict with params and batch_stats merged),
    and with `with_optimizer` also the optimizer state (None if absent, as
    in every reference package checkpoint). Reads either package's
    format."""
    with open(path, "rb") as f:
        head = f.read(1)
    if head and _is_msgpack_map(head[0]):
        from matdeeplearn_torch.convert import params_from_jax

        with open(path, "rb") as f:
            payload = msgpack_restore(f.read())
        state = payload["state"]
        out = (json.loads(payload["meta"]),
               params_from_jax(state["params"], state.get("batch_stats") or {}))
        return out + (None,) if with_optimizer else out
    payload = torch.load(path, map_location="cpu", weights_only=True)
    out = (json.loads(payload["meta"]), {**payload["params"],
                                          **payload["batch_stats"]})
    if with_optimizer:
        return out + (payload.get("optimizer"),)
    return out


# ------------------------------------------- the reference package's format


def _is_msgpack_map(b: int) -> bool:
    return 0x80 <= b <= 0x8F or b in (0xDE, 0xDF)


# the reference serializer's msgpack extension types: an ndarray, and a
# numpy scalar in the same encoding
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer, for the subset the reference
    serializer writes: nil, booleans, integers, floats, str, bin, arrays
    (as lists), maps and the ndarray extension; any other extension type
    raises."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        sizes = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",    # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",    # str
                 0xDC: ">H", 0xDD: ">I",                # array
                 0xDE: ">H", 0xDF: ">I",                # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}    # ext
        if b in sizes:
            n = self.unpack(sizes[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b >= 0xD9 and b <= 0xDB:
                return self.str(n)
            if b in (0xDC, 0xDD):
                return self.array(n)
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: extension type {code} is not a "
                             "ndarray (type 1) or numpy scalar (type 3)")
        shape, dtype, buf = _Reader(payload).value()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def _unchunk(tree):
    """The serializer's chunked-array maps (arrays above its 1 GiB leaf
    limit) back into arrays, in place."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data: bytes):
    """The tree the reference serializer's msgpack_restore returns for
    `data`: dicts, lists and Python scalars, with numpy arrays (read-only
    views of the buffer, as its are) at the ndarray leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return _unchunk(tree)
