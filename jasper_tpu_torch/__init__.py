"""jasper_tpu_torch — the PyTorch/CUDA port of jasper_tpu for NVIDIA Hopper.

The port sits beside ``jasper_tpu``, which stays the reference: every ported
module is held bit for bit against its ``jasper_tpu`` counterpart by the
``tests/test_torch_*.py`` parity suites. This package imports ``torch`` and
never ``jax``; where it reuses a ``jasper_tpu`` module, that module is
jax-free (``polish.engine``, ``polish.runner.polish_file``, ``io.jf``,
``io.native_jf``, ``ops.kmer``, ``ops.codes``).

The slice ported so far is the polish scan: ``.jf`` -> host table -> table on
the device -> per-window counts through the hand-written CUDA bucket probe
(``csrc/probe.cu``) -> the reference-exact host repair walk -> polished FASTA.
Entry point: ``python -m jasper_tpu_torch.polish.runner``.
"""

__version__ = "0.1.0"
