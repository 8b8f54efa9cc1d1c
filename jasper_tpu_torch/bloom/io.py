""""bloomcounter" file format interchange (copy of jasper_tpu/bloom/io.py:11-93).

Layout (reference bc_main.cc:88-148 + generic_file_header.hpp:88-117):
9-digit header length, terse JSON with keys format="bloomcounter", key_len,
size (=m counters), nb_hashes, matrix1, matrix2, canonical, fpr; then the
counter bits: 5 base-3 counters packed per byte, counter p stored at
byte p//5 as digit p%5 (value = digit * 3^(p%5),
reference bloom_counter2.hpp:40-42,56-105).
"""

from __future__ import annotations

import json

import numpy as np

from jasper_tpu_torch.bloom.bloom import BloomCounter2, BloomHashPair
from jasper_tpu_torch.io.jf import read_header
from jasper_tpu_torch.ops.gf2 import GF2Matrix

FORMAT = "bloomcounter"
_POW3 = np.array([1, 3, 9, 27, 81], dtype=np.uint8)


def pack_base3(digits: np.ndarray) -> np.ndarray:
    """uint8 digits [m] (values 0..2) -> packed bytes [ceil(m/5)]."""
    m = len(digits)
    nbytes = (m + 4) // 5
    padded = np.zeros(nbytes * 5, dtype=np.uint8)
    padded[:m] = digits
    return (padded.reshape(nbytes, 5) * _POW3[None, :]).sum(axis=1).astype(np.uint8)


def unpack_base3(packed: np.ndarray, m: int) -> np.ndarray:
    """packed bytes -> uint8 digits [m]."""
    b = packed.astype(np.uint16)
    digits = np.stack([(b // p) % 3 for p in _POW3], axis=1).reshape(-1)
    return digits[:m].astype(np.uint8)


def write_bloom_counter(
    path: str,
    bc: BloomCounter2,
    canonical: bool = True,
    fpr: float | None = None,
    extra_header: dict | None = None,
) -> None:
    header = {
        "alignment": 8,
        "canonical": bool(canonical),
        "format": FORMAT,
        "key_len": 2 * bc.hash_pair.k,
        "matrix1": bc.hash_pair.m1.to_header_json(),
        "matrix2": bc.hash_pair.m2.to_header_json(),
        "nb_hashes": bc.nb_hashes,
        "size": bc.m,
    }
    if fpr is not None:
        header["fpr"] = fpr
    if extra_header:
        header.update(extra_header)
    hjson = json.dumps(header, separators=(",", ":"), sort_keys=True).encode()
    pad = (9 + len(hjson)) % 8
    padlen = (8 - pad) if pad else 0
    with open(path, "wb") as f:
        f.write(b"%09d" % (len(hjson) + padlen))
        f.write(hjson)
        f.write(b"\x00" * padlen)
        f.write(pack_base3(bc.data).tobytes())


def load_bloom_counter(path: str):
    """-> (BloomCounter2, header dict)."""
    header = read_header(path)
    if header.get("format") != FORMAT:
        raise ValueError(f"not a bloomcounter file: format={header.get('format')!r}")
    m = int(header["size"])
    nh = int(header["nb_hashes"])
    pair = BloomHashPair(
        GF2Matrix.from_header_json(header["matrix1"]),
        GF2Matrix.from_header_json(header["matrix2"]),
    )
    nbytes = (m + 4) // 5
    with open(path, "rb") as f:
        hlen = int(f.read(9))
        f.seek(9 + hlen)
        raw = np.frombuffer(f.read(nbytes), dtype=np.uint8)
    if len(raw) != nbytes:
        raise ValueError(f"{path}: bloom filter file is truncated")
    data = unpack_base3(raw, m)
    return BloomCounter2(m, nh, pair, data), header
