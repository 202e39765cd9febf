"""The cases of tests/test_crc32c.py over the port's CRC32C and heal
wire frames, under the reference's names and assertions
(tests/test_torch_twin.py says how).

The port has one CRC32C, ``csrc/host/crc32c.cc`` linked into its build of
the native control plane, and no numpy fallback: without that build there
is no lighthouse or manager either, so a fallback would never run (and a
numpy CRC makes a 1.6 GB heal outlast the collective timeout, ROADMAP
F1's note). The fallback's contract is held all the same, bitwise: the
reference's scalar table CRC (``_ref_crc`` over the reference's
``_TABLE``) and the reference's own ``_np_crc`` stand as the oracles the
port's ``crc32c`` must equal at the fold-tree boundary sizes
(2047–10240 bytes) and across the streaming cuts. The wire cases build
their states with numpy where the reference's use ``jax.numpy``: the
port's checkpoint server takes host arrays and tensors.
"""

from tests.test_torch_twin import reference_twin

reference_twin(
    globals(), "test_crc32c",
    renames={"C._TABLE": "_REF_TABLE", "C._np_crc": "_ref_np_crc",
             "import jax.numpy as jnp": "import numpy as jnp"},
    prelude="from torchft_tpu.utils.crc32c import _TABLE as _REF_TABLE\n"
            "from torchft_tpu.utils.crc32c import _np_crc as _ref_np_crc\n")
