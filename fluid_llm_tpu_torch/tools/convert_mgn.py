"""DeepMind MeshGraphNets TFRecord -> per-trajectory pickle converter.

Equivalent of ``max/ds_download/MGN_unload.py:36-102`` / ``torch_MGN.py``
without the TensorFlow dependency: TFRecord framing and the ``tf.Example``
protobuf are parsed directly (varint wire format), so the converter runs in
this image.  Output pickles carry
``{'cells', 'mesh_pos', 'node_type', 'velocity', 'pressure', ...}`` with
static fields de-duplicated across time and cells narrowed to int16 when
they fit (``MGN_unload.py:86-99``).  A copy of
``fluid_llm_tpu/tools/convert_mgn.py`` (it writes the same bytes), so that
the port alone can write the pickles ``configs/training1.yaml`` reads:

    python -m fluid_llm_tpu_torch.tools.convert_mgn --dataset_dir <dir with meta.json> \\
        --split train --out_dir <load_dir>/train
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import struct
import sys
from typing import Iterator

import numpy as np


# -- TFRecord framing --------------------------------------------------------


def iter_tfrecords(path: str) -> Iterator[bytes]:
    """Yield raw record payloads (length-framed; CRCs skipped)."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            f.read(4)  # length crc
            data = f.read(length)
            if len(data) < length:
                return
            f.read(4)  # data crc
            yield data


# -- minimal protobuf wire parsing ------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes) -> Iterator[tuple[int, int, bytes | int]]:
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
            yield field, wire, val
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


def parse_example(record: bytes) -> dict[str, list[bytes]]:
    """tf.Example -> {feature name: BytesList values}."""
    out: dict[str, list[bytes]] = {}
    for field, _, features in _iter_fields(record):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(features):
            if f2 != 1:  # Features.feature map entry
                continue
            key = None
            values: list[bytes] = []
            for f3, _, val in _iter_fields(entry):
                if f3 == 1:
                    key = val.decode()
                elif f3 == 2:  # Feature
                    for f4, _, lst in _iter_fields(val):
                        if f4 == 1:  # BytesList
                            for f5, _, item in _iter_fields(lst):
                                if f5 == 1:
                                    values.append(item)
            if key is not None:
                out[key] = values
    return out


# -- dataset conversion ------------------------------------------------------

_DTYPES = {"float32": np.float32, "int32": np.int32, "int64": np.int64}


def decode_trajectory(record: bytes, meta: dict) -> dict[str, np.ndarray]:
    """Raw record -> field arrays per the dataset meta.json (tiling static
    fields over the trajectory like the reference parser)."""
    example = parse_example(record)
    out = {}
    for key, field in meta["features"].items():
        raw = b"".join(example[key])
        arr = np.frombuffer(raw, dtype=_DTYPES[field["dtype"]])
        shape = [s if s != -1 else -1 for s in field["shape"]]
        arr = arr.reshape(shape)
        if field["type"] == "static":
            arr = np.tile(arr, (meta["trajectory_length"], 1, 1))
        elif field["type"] != "dynamic":
            raise ValueError(f"unsupported field type {field['type']}")
        out[key] = arr
    return out


def check_repeat(arr: np.ndarray) -> bool:
    """``MGN_unload.py:28-33``: is the field constant over time?"""
    return all(np.array_equal(arr[0], arr[i]) for i in range(1, len(arr)))


def convert_split(ds_dir: str, split: str, out_dir: str, limit: int | None = None) -> int:
    with open(os.path.join(ds_dir, "meta.json")) as f:
        meta = json.load(f)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for i, record in enumerate(iter_tfrecords(os.path.join(ds_dir, f"{split}.tfrecord"))):
        if limit is not None and i >= limit:
            break
        sample = decode_trajectory(record, meta)
        save = {k: v for k, v in sample.items() if k not in ("cells", "mesh_pos", "node_type")}
        for var in ("cells", "mesh_pos", "node_type"):
            if var in sample:
                if not check_repeat(sample[var]):
                    print(f"Warning: {var} not static over time")
                save[var] = sample[var][0]
        cells = save.get("cells")
        if cells is not None and cells.min() >= np.iinfo(np.int16).min and cells.max() <= np.iinfo(np.int16).max:
            save["cells"] = cells.astype(np.int16)
        with open(os.path.join(out_dir, f"save_{i}.pkl"), "wb") as f:
            pickle.dump(save, f)
        count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset_dir", required=True, help="dir with meta.json + *.tfrecord")
    parser.add_argument("--split", default="train")
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--limit", type=int, default=None)
    args = parser.parse_args(argv)
    n = convert_split(args.dataset_dir, args.split, args.out_dir, args.limit)
    print(f"converted {n} trajectories")


if __name__ == "__main__":
    main(sys.argv[1:])
