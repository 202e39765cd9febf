"""The cases of tests/test_pipeline_plane.py over the port's MPMD stage
plane (``torchft_tpu_torch.Pipeline``) on the CPU: every
``PipelineConfig`` here asks for ``device="cpu"`` (the port's stage
compute runs on the card unless asked), under the reference's names and
assertions (tests/test_torch_twin.py says how). The suite's slow cases
stay behind its ``slow`` marker, as the reference's do.
"""

from tests.test_torch_twin import reference_twin

reference_twin(
    globals(), "test_pipeline_plane",
    prelude="import functools\n",
    renames={"PipelineConfig(": "_CpuConfig(",
             "import torchft_tpu_torch.pipeline as P":
                 "import torchft_tpu_torch.pipeline as P\n"
                 "_CpuConfig = functools.partial(P.PipelineConfig, "
                 "device=\"cpu\")"})
