"""`dna_jellyfish`-compatible Python bindings on the port (counterpart of
jasper_tpu/bindings/__init__.py).

Importing this package registers ``dna_jellyfish`` in ``sys.modules`` unless
a module of that name is there already (``setdefault``: a process that
imports jasper_tpu's bindings and these keeps the first), so existing
reference-user code (``import dna_jellyfish as jf``) works unchanged:

    import jasper_tpu_torch.bindings  # noqa: F401
    import dna_jellyfish as jf
"""

import sys

from jasper_tpu_torch.bindings import dna_jellyfish

sys.modules.setdefault("dna_jellyfish", dna_jellyfish)
