"""Bloom counters and filters for the jellyfish CLI's `bc`, `--bc` and
`--bf-size` (copy of jasper_tpu/bloom/__init__.py)."""

from jasper_tpu_torch.bloom.bloom import BloomCounter2, BloomFilter1, BloomHashPair, opt_k, opt_m
from jasper_tpu_torch.bloom.io import load_bloom_counter, write_bloom_counter

__all__ = [
    "BloomCounter2",
    "BloomFilter1",
    "BloomHashPair",
    "opt_k",
    "opt_m",
    "load_bloom_counter",
    "write_bloom_counter",
]
