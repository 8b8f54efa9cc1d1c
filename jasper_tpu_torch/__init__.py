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
and ``python -m jasper_tpu_torch.polish.runner``.
"""

__version__ = "0.1.0"
