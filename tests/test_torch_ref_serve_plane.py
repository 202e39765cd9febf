"""The cases of tests/test_serve_plane.py over the port's train-to-serve
plane (``serve.py``), whole, under the reference's names and assertions
(tests/test_torch_twin.py says how): every ``ServeCohort`` and
``ServingReplica`` here asks for ``device="cpu"`` (the port's serving
replicas hold their versions on the card unless asked)."""

from tests.test_torch_twin import reference_twin

reference_twin(
    globals(), "test_serve_plane",
    prelude="import functools\n",
    renames={"ServeCohort(": "_CpuCohort(",
             "ServingReplica(": "_CpuReplica(",
             "    unit_digest,\n)": "    unit_digest,\n)\n"
             "import torchft_tpu_torch.serve as _S\n"
             "_CpuCohort = functools.partial(_S.ServeCohort, device=\"cpu\")\n"
             "_CpuReplica = functools.partial(_S.ServingReplica, "
             "device=\"cpu\")"})
