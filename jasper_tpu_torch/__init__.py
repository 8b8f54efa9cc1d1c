"""jasper_tpu_torch — the PyTorch/CUDA port of jasper_tpu for NVIDIA Hopper.

The port sits beside ``jasper_tpu``, which stays the reference: every ported
module is held bit for bit against its ``jasper_tpu`` counterpart by the
``tests/test_torch_*.py`` parity suites. This package imports ``torch`` and
nothing of ``jax`` or ``jasper_tpu``: the host modules it shares with
jasper_tpu are its own copies, each naming its source by file and line
(``polish.engine``, ``polish.runner.polish_file``, ``io.jf``, ``io.fastx``,
``io.bam``, ``io.native``, ``io.native_jf``, ``io.generators``,
``ops.codes``, ``ops.gf2``, the host helpers of ``ops.kmer`` and
``ops.hashing``, the host table's queries, ``bloom``, ``count.merge``,
``count.stats``, ``bindings.dna_jellyfish``, ``utils.pairwise`` and the
helpers of ``pipeline.driver``). tests/test_torch_selfcontained.py enforces
it.

Ported so far, on one device: counting from reads (count/: extraction,
sorted runs in an LSM ladder, the waterfall build of the table on the
device, records to the host table, histogram and `.jf`), the polish scan
(table on the device -> per-window counts through the hand-written CUDA
bucket probe, ``csrc/probe.cu`` -> the reference-exact host repair walk),
the driver around them, reads -> polished FASTA, and the
jellyfish-compatible CLI (count on the device, forward and filtered counts,
--disk; histo, query, dump, merge, stats, info, bc, mem and cite on the
host) with the ``dna_jellyfish`` bindings. Entry points:
``bin/jasper-tpu-torch`` (``python -m jasper_tpu_torch.pipeline.cli``),
``bin/jellyfish-tpu-torch`` (``python -m jasper_tpu_torch.pipeline.jf_cli``)
and ``python -m jasper_tpu_torch.polish.runner``. The profiling tools
(jasper_tpu's tools/profile_count.py, profile_polish.py and
layout_sweep.py) are ``python -m jasper_tpu_torch.tools.<name>``.

The top-level names are jasper_tpu's lazy API, each resolved from the
port's module on first use: ``import jasper_tpu_torch`` alone imports no
torch.
"""

__version__ = "0.1.0"

_API = {
    "count_reads": "jasper_tpu_torch.count.counter",
    "count_sequences": "jasper_tpu_torch.count.counter",
    "histogram_rows": "jasper_tpu_torch.count.histogram",
    "threshold_from_histogram": "jasper_tpu_torch.count.histogram",
    "merge_jf_files": "jasper_tpu_torch.count.merge",
    "read_jf": "jasper_tpu_torch.io.jf",
    "write_jf": "jasper_tpu_torch.io.jf",
    "read_any_jf": "jasper_tpu_torch.io.jf",
    "load_jf_into_host_table": "jasper_tpu_torch.io.jf",
    "dump_table_to_jf": "jasper_tpu_torch.io.jf",
    "read_fasta": "jasper_tpu_torch.io.fastx",
    "write_fasta": "jasper_tpu_torch.io.fastx",
    "HostKmerTable": "jasper_tpu_torch.table.host_table",
    "PolishEngine": "jasper_tpu_torch.polish.engine",
    "CountSource": "jasper_tpu_torch.polish.engine",
    "DevicePolishEngine": "jasper_tpu_torch.polish.device_engine",
    "DeviceScanner": "jasper_tpu_torch.polish.device_engine",
    "polish_file": "jasper_tpu_torch.polish.runner",
    "run_pipeline": "jasper_tpu_torch.pipeline.driver",
    "scan_window": "jasper_tpu_torch.polish.window",
    "scan_window_tiled": "jasper_tpu_torch.polish.window",
}


def __getattr__(name):
    """The lazy top-level API (jasper_tpu/__init__.py:23-54): the name's
    module is imported on first use."""
    mod = _API.get(name)
    if mod is None:
        raise AttributeError(f"module 'jasper_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(list(globals()) + list(_API))
