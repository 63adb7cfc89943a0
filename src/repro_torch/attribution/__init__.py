"""GraSS data attribution (port of ``repro.attribution``): the MLP and its
trainer, the gradient sparsify→sketch feature pipeline, and the LDS
metric."""
from repro_torch.attribution.grass import (GrassPipeline,  # noqa: F401
                                           GrassPipelineConfig,
                                           run_grass_lds, sparsify_mask)
