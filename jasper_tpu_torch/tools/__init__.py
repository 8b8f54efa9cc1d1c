"""Profiling tools of the port, on the card (counterparts of jasper_tpu's
tools/profile_count.py, tools/profile_polish.py and tools/layout_sweep.py,
which import jax). Run each as ``python -m jasper_tpu_torch.tools.<name>``;
every tool takes ``--device`` (default ``cuda``: raises without a card;
``--device cpu`` runs the same torch code), prints its JSON as the last
line of its output and exposes ``main(argv) -> dict``. ``measure`` holds
the timing and the roofline bounds they share with chip_smoke.py.
"""
